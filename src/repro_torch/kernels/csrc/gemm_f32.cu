// f32 matrix product on Hopper's TF32 tensor cores in three split passes
// (sm_90a): C (m, n) = A (m, k) . W (k, n), all f32, with W given as its
// TF32 hi and lo planes laid out K-major, (n, k) each.
//
// Replaces no TPU kernel: the JAX package leaves demo_transformer's
// products (core/model_zoo.py: x @ Wqkv, o @ Wo, y @ W1, gelu(.) @ W2) to
// XLA.  On the card cuBLAS ran them as f32 SGEMMs on the FMA units (67
// TFLOP/s at most), about 70% of the device time of a served microbatch.
//
// What bounds it: 2 m n k FLOPs at three TF32 passes (495 TFLOP/s dense)
// against 4 (m k + 2 n k + m n) bytes: at the served shapes (m = 32768, k
// and n 2560 to 10240) thousands of FLOPs a byte, so it is compute bound,
// and the design is about keeping the tensor cores fed:
//
// * wgmma.m64n128k8 does the products: A from registers, the weight planes
//   from shared memory.  A TF32 wgmma takes K-major operands only, so the
//   planes are split and transposed once per weight version by the caller
//   (kernels/gemm/ops.py: weight_planes), never per call.
// * The activation is split in the kernel, shared memory -> registers ->
//   hi = tf32_rna(a), lo = tf32_rna(a - hi) (split_tf32.cuh), so no pass
//   over device memory writes split planes of A.  A product is
//   a_lo.w_hi + a_hi.w_lo + a_hi.w_hi; a_lo.w_lo (~2^-22 of it) is dropped.
// * The tensor cores' own accumulation does not round to nearest, so each
//   32-deep slice of k (12 wgmma, the small terms first) sums into a fresh
//   fragment that is then added in f32 to the tile's sum, as the repo's
//   other split kernels keep every tensor-core sum short: the error stays
//   at the f32 product's, not growing with k.
// * One producer warp keeps TMA loads of A and both planes (128 B swizzled,
//   48 KB a stage) in flight through a 4-stage mbarrier ring; two consumer
//   warpgroups own 64 rows each of a 128 x 128 output tile.  setmaxnreg
//   gives the consumers 232 registers (tile sum, fresh fragment and the
//   split A of a slice) and the producer 40.
// * Blocks are persistent, one an SM, over the output tiles rastered in
//   groups of 16 row tiles (a group's activation rows and weight columns
//   stay in the 50 MB L2), so the producer loads the next tile's slices
//   while the consumers store this one's.
//
// Ragged m, n and k are masked: TMA fills what lies past the edge with
// zeros and the epilogue stores only rows < m, columns < n.  n and k must
// be multiples of 4 (TMA's 16-byte row strides); the wrapper checks.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "split_tf32.cuh"
#include "tma_wgmma.cuh"

namespace {

using namespace tma_wgmma;

constexpr int BM = 128, BN = 128, BK = 32, STAGES = 4, GROUP_M = 16;
constexpr int THREADS = 384;  // warpgroups 0, 1 consume; warpgroup 2 produces
constexpr int TILE_BYTES = BM * BK * 4;  // A, W hi, W lo: 16 KB each
constexpr int STAGE_BYTES = 3 * TILE_BYTES;
constexpr int SMEM = STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;  // + 1 KB to align

// shared-memory matrix descriptor of a K-major tile with 128-byte rows,
// 128 B swizzle, 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

// d (64 x 128, f32; scale_d = 0: d is overwritten) += a (64 x 8, tf32, in
// registers) . b (8 x 128, tf32, K-major in shared memory)
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// the output tile (row, column of its first element) of a tile index:
// tiles run down a group of GROUP_M row tiles, then across the columns
__device__ __forceinline__ void tile_origin(int tile, int m_tiles, int n_tiles, int& m0,
                                            int& n0) {
  const int per_group = GROUP_M * n_tiles;
  const int group = tile / per_group, first = group * GROUP_M;
  const int rows = min(m_tiles - first, GROUP_M);
  const int in_group = tile - group * per_group;
  m0 = (first + in_group % rows) * BM;
  n0 = (in_group / rows) * BN;
}

__global__ void __launch_bounds__(THREADS, 1)
    seifer_gemm_tf32x3_kernel(const __grid_constant__ CUtensorMap map_a,
                              const __grid_constant__ CUtensorMap map_hi,
                              const __grid_constant__ CUtensorMap map_lo,
                              float* __restrict__ c, int m, int n, int k) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // 128 B swizzle wants 1 KB alignment
  const float* smem_f = reinterpret_cast<const float*>(smem_raw + (base - raw));
  const uint32_t full = base + STAGES * STAGE_BYTES, empty = full + STAGES * 8;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);       // the producer's expect_tx; TMA's bytes
      mbar_init(empty + 8 * s, 2 * 4);  // one arrival from each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int m_tiles = (m + BM - 1) / BM, n_tiles = (n + BN - 1) / BN;
  const int tiles = m_tiles * n_tiles, k_steps = (k + BK - 1) / BK;
  const int wg = threadIdx.x / 128;

  if (wg == 2) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x != 256) return;
    int s = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      int m0, n0;
      tile_origin(tile, m_tiles, n_tiles, m0, n0);
      for (int ks = 0; ks < k_steps; ++ks) {
        mbar_wait(empty + 8 * s, phase ^ 1);
        const uint32_t bar = full + 8 * s, dst = base + s * STAGE_BYTES;
        mbar_expect_tx(bar, STAGE_BYTES);
        tma_load(dst, &map_a, bar, ks * BK, m0);
        tma_load(dst + TILE_BYTES, &map_hi, bar, ks * BK, n0);
        tma_load(dst + 2 * TILE_BYTES, &map_lo, bar, ks * BK, n0);
        if (++s == STAGES) s = 0, phase ^= 1;
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
  const int g = lane / 4, t = lane % 4;
  const int r0 = wg * 64 + warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  // word offset within a 128-byte swizzled row of column 8 j + 4 h + t
  // (16-byte chunk 2 j + h lands at chunk (2 j + h) ^ (row % 8), row % 8 = g)
  int col_off[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) col_off[j][h] = (((2 * j + h) ^ g) << 2) + t;

  float acc[64], frag[64];
  int s = 0;
  uint32_t phase = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    int m0, n0;
    tile_origin(tile, m_tiles, n_tiles, m0, n0);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
    for (int ks = 0; ks < k_steps; ++ks) {
      mbar_wait(full + 8 * s, phase);
      const uint32_t stage = base + s * STAGE_BYTES;
      const float* a_rows = smem_f + s * (STAGE_BYTES / 4) + r0 * BK;
      uint32_t hi[4][4], lo[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // wgmma's A fragment: (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)
        split_tf32::split(a_rows[col_off[j][0]], hi[j][0], lo[j][0]);
        split_tf32::split(a_rows[8 * BK + col_off[j][0]], hi[j][1], lo[j][1]);
        split_tf32::split(a_rows[col_off[j][1]], hi[j][2], lo[j][2]);
        split_tf32::split(a_rows[8 * BK + col_off[j][1]], hi[j][3], lo[j][3]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v) pin(hi[j][v]), pin(lo[j][v]);
#pragma unroll
      for (int i = 0; i < 64; ++i) pin(frag[i]);
      wgmma_fence();
      const uint64_t d_hi = smem_desc(stage + TILE_BYTES), d_lo = smem_desc(stage + 2 * TILE_BYTES);
      // small terms first; each 8-deep k step advances the descriptors by
      // 32 bytes (2 in the descriptor's 16-byte units)
#pragma unroll
      for (int j = 0; j < 4; ++j) wgmma_rs(frag, lo[j], d_hi + 2 * j, j > 0);
#pragma unroll
      for (int j = 0; j < 4; ++j) wgmma_rs(frag, hi[j], d_lo + 2 * j, 1);
#pragma unroll
      for (int j = 0; j < 4; ++j) wgmma_rs(frag, hi[j], d_hi + 2 * j, 1);
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int i = 0; i < 64; ++i) pin(frag[i]);
      if (lane == 0) mbar_arrive(empty + 8 * s);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] += frag[i];
      if (++s == STAGES) s = 0, phase ^= 1;
    }
    // accumulator (64 x 128 a warpgroup): element 4 j + e of a thread is
    // row g + 8 (e / 2) of its warp's 16, column 8 j + 2 t + e % 2
    const int row = m0 + r0;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = n0 + 8 * j + 2 * t;
      if (col < n) {  // n is even, so col + 1 < n too
        if (row < m)
          *reinterpret_cast<float2*>(c + (size_t)row * n + col) = make_float2(acc[4 * j], acc[4 * j + 1]);
        if (row + 8 < m)
          *reinterpret_cast<float2*>(c + (size_t)(row + 8) * n + col) =
              make_float2(acc[4 * j + 2], acc[4 * j + 3]);
      }
    }
  }
}

// a row-major (rows, cols) f32 tensor read in boxes of (BK columns, 128 rows)
bool encode(EncodeTiled enc, CUtensorMap* map, const void* ptr, int rows, int cols) {
  return tma_wgmma::encode(enc, map, ptr, rows, cols, BK, 128, CU_TENSOR_MAP_SWIZZLE_128B);
}

constexpr int MAX_DEVICES = 64;
int sms_of[MAX_DEVICES] = {};  // a device's SM count, once the kernel is set up there

// the current device's SM count; at a device's first call, also the
// kernel's shared-memory allowance there, so later calls do no more
cudaError_t prepare(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (sms_of[dev] == 0) {
    int n = 0;
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(seifer_gemm_tf32x3_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return err;
    sms_of[dev] = n;
  }
  *sms = sms_of[dev];
  return cudaSuccess;
}

}  // namespace

extern "C" {

// c (m, n) = a (m, k) . w (k, n); w_hi, w_lo: w's TF32 planes, (n, k) each.
// n and k multiples of 4, every pointer 16-byte aligned (the wrapper checks).
int seifer_gemm_f32(const void* a, const void* w_hi, const void* w_lo, void* c, int m, int n,
                    int k, void* stream) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap map_a, map_hi, map_lo;
  if (!encode(enc, &map_a, a, m, k) || !encode(enc, &map_hi, w_hi, n, k) ||
      !encode(enc, &map_lo, w_lo, n, k))
    return (int)cudaErrorInvalidValue;
  int sms = 0;
  const cudaError_t err = prepare(&sms);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (long long)((m + BM - 1) / BM) * ((n + BN - 1) / BN);
  const unsigned grid = (unsigned)(tiles < sms ? tiles : sms);
  seifer_gemm_tf32x3_kernel<<<grid, THREADS, SMEM, (cudaStream_t)stream>>>(map_a, map_hi, map_lo,
                                                                          (float*)c, m, n, k);
  return (int)cudaGetLastError();
}

}  // extern "C"

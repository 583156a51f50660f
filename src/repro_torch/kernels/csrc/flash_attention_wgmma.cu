// Flash-attention forward for Hopper (sm_90a) at head dims 64, 80, 112 and
// 128: f32 in and out, every product on TF32 wgmma under split precision
// (split_tf32.cuh), operands staged by TMA.
//
// Stands beside the Pallas TPU kernel src/repro/kernels/flash_attention/
// kernel.py flash_attention_tpu (_fa_kernel), as csrc/flash_attention.cu
// does for the other head dims, with its arithmetic in full: online softmax
// (m, l, acc) across kv tiles, masked logits at NEG_INF = -1e30, ragged key
// columns at -inf, l clamped at 1e-30, causal and sliding-window masks, the
// gemma2 logit softcap c*tanh(s/c), the caller's scale on q, GQA (H = G*KH),
// q, k, v as strided views (the fused q|k|v projection's slices), fully dead
// kv tiles never loaded, and each row's logsumexp for the backward when lse
// is non-null.
//
// What bounds it: 4 hd operations per live (query, key) pair at three TF32
// passes (lo.hi, hi.lo, hi.hi; 495 TFLOP/s dense) against reading q, k, v
// and writing o once: at the served shapes (S = 8192) operations bound it by
// two orders of magnitude, so the design keeps the tensor cores fed.
//
// * A pre-pass (flash_fwd_kernel_planes) splits K and V once into TF32 hi
//   and lo planes in scratch the wrapper allocates: K as stored (keys, hd),
//   V transposed (hd, keys), because TF32 wgmma takes only K-major operands
//   from shared memory and the key is P V's inner dimension.  Within each
//   8 keys V^T holds keys 0 2 4 6 1 3 5 7, so that P's accumulator
//   fragment (a lane holds keys 2t and 2t + 1) is P V's A fragment as it
//   stands, as in split_tf32.cuh.  The planes are S rounded up to 64 keys,
//   zero past S.  Each plane's bytes cross HBM once more (~0.6 ms at
//   phi-2's B=4, S=8192, 32 kv heads of 80), and a K or V element is split
//   once, not once a warp as in the mma.sync kernel.
// * The main kernel (flash_fwd_kernel_wgmma) takes 128 queries of one head
//   in two warpgroups of 64 rows.  Thread 0 also keeps a ring of K and V^T
//   tiles in flight by TMA (64-byte swizzle, 16-float atoms, which divide
//   every head dim here), hi and lo planes in one entry, through full/empty
//   mbarriers.  Each warpgroup first loads its 64 rows of q, scales them,
//   splits them once and writes their hi and lo planes to shared memory in
//   the same swizzle.
// * S = Q K^T: wgmma m64nBNk8 with both operands in shared memory.  Each
//   32-wide slice of hd (12 wgmma, small terms first; 80 and 112 end in a
//   16-wide slice) sums in a fresh fragment; the slices all go to the tensor cores at
//   once and are added to S in f32, in order.
// * O = P V: P split into hi and lo in registers as the softmax leaves it,
//   wgmma m64nNCk8 against the V^T planes.  Each 32 keys and NC columns of
//   hd (12 wgmma) sum in a fresh fragment added to O in f32: fed O
//   directly, the tensor cores' own accumulation let the error grow with S
//   (csrc/flash_attention.cu).
// * The two warpgroups run unsynchronised: one's softmax runs while the
//   other's products hold the tensor cores.  Strict turns (FlashAttention-3's
//   ping-pong, named barriers around each batch of products) measured 40%
//   slower on an H100 at phi-2's call, and one batch of P V with both fresh
//   fragments live (no wait between its 32-key halves) spilled at hd 80.
//
// Budgets (227 KB of shared memory; 255 registers a thread, since no third
// warpgroup shares the SM's register file): Q's planes take 2 x 128 x hd x 4
// bytes; a ring entry (a K or V^T tile, both planes) 2 x BN x hd x 4.  At hd
// 64 and 80 a tile is 64 keys (64 + 5 x 32 KB; 80 + 3 x 40 KB), at 112 and
// 128 it is 32 (112 + 4 x 28; 128 + 3 x 32).  A thread holds S and its
// slices (BN / 2 x NS floats), O (hd / 2), and for P V the hi and lo of 32
// keys of P (32) and one fresh fragment (NC / 2; NC = hd at hd <= 80 and
// hd / 2 above).
//
// Above hd 128 the same plan does not fit: Q's planes alone are 115 KB at
// hd 224 for 64 rows, K's and V^T's for a 32-key tile another 115 KB, over
// what a block may use.  hd 160, 224, 256 (and the demo models' 8) stay on
// the mma.sync kernel, csrc/flash_attention.cu.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "split_tf32.cuh"
#include "tma_wgmma.cuh"

namespace {

using namespace tma_wgmma;
using split_tf32::split;

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 128;            // queries a block: two consumer warpgroups of 64
constexpr int THREADS = 256;       // two warpgroups; thread 0 also produces
constexpr int SMEM_MAX = 232448;   // what a block may use on an H100
constexpr int PLANE_KEYS = 64;     // the planes hold S rounded up to this
constexpr int ATOM = 64;           // bytes a swizzled row: 16 floats

template <int HD>
struct Cfg {
  static constexpr int BN = HD <= 80 ? 64 : 32;  // keys a kv tile
  static constexpr int TILE = BN * HD * 4;        // one plane of a K or V^T tile, bytes
  static constexpr int ENTRY = 2 * TILE;          // a ring entry: the hi and lo planes
  static constexpr int Q_PLANE = BQ * HD * 4;
  static constexpr int ENTRIES = (SMEM_MAX - 1024 - 2 * Q_PLANE) / (ENTRY + 16);
  static constexpr int SMEM = 2 * Q_PLANE + ENTRIES * (ENTRY + 16) + 1024;  // + 1 KB to align
  static constexpr int NS = (HD + 31) / 32;       // 32-wide slices of hd in Q K^T
  static constexpr int NH = BN / 32;              // 32-key slices of P V
  static constexpr int NC = HD <= 80 ? HD : HD / 2;  // hd columns of a P V fresh fragment
  static_assert(HD % 16 == 0 && ENTRIES >= 3 && ENTRY % 512 == 0, "tile plan");
};

// shared-memory matrix descriptor of a K-major operand of 64-byte rows,
// 64 B swizzle, 8-row groups 512 bytes apart
__device__ __forceinline__ uint64_t desc64(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | (32ull << 32) | (2ull << 62);
}

// desc advanced by `bytes`, formed where it is used: the empty asm keeps the
// compiler from computing every wgmma's descriptors up front and holding
// them all in registers
__device__ __forceinline__ uint64_t at(uint64_t desc, uint32_t bytes) {
  asm volatile("" : "+l"(desc));
  return desc + (bytes >> 4);
}

// byte offset of (row, column c) in a plane of `rows` rows stored as 16-float
// atoms of 64-byte rows, each 16-byte chunk swizzled as TMA's 64 B mode does
__device__ __forceinline__ uint32_t swizzled(int rows, int row, int c) {
  return (c / 16) * rows * ATOM + row * ATOM + ((((c % 16) / 4) ^ ((row >> 1) & 3)) << 4);
}

// d (64 x 32) += a (64 x 8, shared) . b (8 x 32, shared); scale_d = 0 overwrites d
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, %8, "
      "%9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 64) += a (64 x 8, shared) . b (8 x 64, shared); scale_d = 0 overwrites d
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, %8, "
      "%9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "
      "%27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 56) += a (64 x 8, registers) . b (8 x 56, shared); scale_d = 0 overwrites d
__device__ __forceinline__ void wgmma_rs(float (&d)[28], const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %33, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n56k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, %8, "
      "%9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "
      "%27}, "
      "{%28, %29, %30, %31}, %32, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// d (64 x 64) += a (64 x 8, registers) . b (8 x 64, shared); scale_d = 0 overwrites d
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, %8, "
      "%9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "
      "%27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// d (64 x 80) += a (64 x 8, registers) . b (8 x 80, shared); scale_d = 0 overwrites d
__device__ __forceinline__ void wgmma_rs(float (&d)[40], const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, %8, "
      "%9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "
      "%27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// K and V of 64 keys of one kv head into their TF32 planes: K hi, K lo as
// (keys, hd), V^T hi, V^T lo as (hd, keys) with keys 0 2 4 6 1 3 5 7 in
// every 8; keys past S are zero.  planes: 4 planes of B KH S_pad hd floats.
template <int HD>
__global__ void __launch_bounds__(256)
flash_fwd_kernel_planes(const float* __restrict__ k, const float* __restrict__ v,
                        float* __restrict__ planes, int S, int S_pad, int KH, long long k_sb,
                        long long k_ss, long long v_sb, long long v_ss) {
  __shared__ float vs[PLANE_KEYS][HD + 1];
  const int bkv = blockIdx.y, b = bkv / KH, kh = bkv % KH, key0 = blockIdx.x * PLANE_KEYS;
  const long long plane = (long long)gridDim.y * S_pad * HD;
  const float* kb = k + b * k_sb + (long long)kh * HD;
  const float* vb = v + b * v_sb + (long long)kh * HD;
  float* khi = planes + ((long long)bkv * S_pad + key0) * HD;
  float* vhi = planes + 2 * plane + (long long)bkv * HD * S_pad + key0;
  for (int e = threadIdx.x; e < PLANE_KEYS * HD / 4; e += 256) {
    const int r = e / (HD / 4), c = (e % (HD / 4)) * 4, kp = key0 + r;
    float4 kx = make_float4(0.0f, 0.0f, 0.0f, 0.0f), vx = kx;
    if (kp < S) {
      kx = *reinterpret_cast<const float4*>(kb + kp * k_ss + c);
      vx = *reinterpret_cast<const float4*>(vb + kp * v_ss + c);
    }
    uint4 hi, lo;
    split(kx.x, hi.x, lo.x);
    split(kx.y, hi.y, lo.y);
    split(kx.z, hi.z, lo.z);
    split(kx.w, hi.w, lo.w);
    *reinterpret_cast<uint4*>(khi + r * HD + c) = hi;
    *reinterpret_cast<uint4*>(khi + plane + r * HD + c) = lo;
    vs[r][c] = vx.x;
    vs[r][c + 1] = vx.y;
    vs[r][c + 2] = vx.z;
    vs[r][c + 3] = vx.w;
  }
  __syncthreads();
  // 16 threads a row of V^T: thread u writes positions 4u .. 4u + 3, keys
  // 8 (u / 2) + u % 2 + {0, 2, 4, 6}
  for (int e = threadIdx.x; e < HD * 16; e += 256) {
    const int d = e / 16, u = e % 16, k0 = 8 * (u / 2) + u % 2;
    uint4 hi, lo;
    split(vs[k0][d], hi.x, lo.x);
    split(vs[k0 + 2][d], hi.y, lo.y);
    split(vs[k0 + 4][d], hi.z, lo.z);
    split(vs[k0 + 6][d], hi.w, lo.w);
    *reinterpret_cast<uint4*>(vhi + (long long)d * S_pad + 4 * u) = hi;
    *reinterpret_cast<uint4*>(vhi + plane + (long long)d * S_pad + 4 * u) = lo;
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_kernel_wgmma(const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v, const float* __restrict__ q,
                       float* __restrict__ o, float* __restrict__ lse, int S, int S_pad, int H,
                       int G, long long q_sb, long long q_ss, int causal, int window,
                       float softcap, float scale) {
  using C = Cfg<HD>;
  constexpr int BN = C::BN, TILE = C::TILE, ENTRY = C::ENTRY, NS = C::NS, NH = C::NH;
  constexpr int NC = C::NC;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t ring = base + 2 * C::Q_PLANE;  // Q hi, Q lo, then the ring
  const uint32_t full = ring + C::ENTRIES * ENTRY, empty = full + C::ENTRIES * 8;

  __shared__ int next_load;  // the next load of K or V^T to start (see produce)
  if (threadIdx.x == 0) {
    next_load = 0;
    for (int e = 0; e < C::ENTRIES; ++e) {
      mbar_init(full + 8 * e, 1);       // the producer's expect_tx; TMA's bytes
      mbar_init(empty + 8 * e, 2 * 4);  // one arrival from each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int h = blockIdx.x % H, b = blockIdx.x / H;
  const int bkv = b * (H / G) + h / G, bkh = gridDim.x / G;  // kv head row, B * KH
  const int q_lo = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest causal tiles first
  const int nk = (S + BN - 1) / BN;
  const int j_end = causal ? min(nk, (q_lo + BQ - 1) / BN + 1) : nk;
  int j_begin = 0;
  if (window > 0 && q_lo - window + 1 > 0) j_begin = (q_lo - window + 1) / BN;
  const int wg = threadIdx.x / 128;

  // Each warpgroup's first thread also produces: load n of the block
  // (K(j) for even n, V^T(j) for odd, j = j_begin + n / 2) goes by TMA into
  // ring entry n % ENTRIES once both warpgroups have released that entry.
  // They look at every wait of their own and claim a load by a CAS on
  // next_load, so a load goes as soon as either reaches a wait.  (A
  // producer warp of its own would cap every thread at 168 registers: 9 or
  // 12 warps put 3 on some SM sub-partition's 16K registers; with 8, a
  // thread has up to 255.)
  const int k_row = bkv * S_pad, v_row = bkv * HD;
  const int k_lo_row = bkh * S_pad, v_lo_row = bkh * HD;  // the lo planes' first rows
  const int loads = 2 * (j_end - j_begin);
  const bool producer = threadIdx.x % 128 == 0;
  const auto produce = [&]() {
    for (;;) {
      const int n = *reinterpret_cast<volatile int*>(&next_load);
      const int pe = n % C::ENTRIES;
      if (n >= loads || !mbar_test(empty + 8 * pe, ((n / C::ENTRIES) & 1) ^ 1)) return;
      if (atomicCAS(&next_load, n, n + 1) != n) continue;
      const int pj = j_begin + n / 2;
      const uint32_t bar = full + 8 * pe, dst = ring + pe * ENTRY;
      mbar_expect_tx(bar, ENTRY);
      if (n % 2 == 0) {
#pragma unroll
        for (int a = 0; a < HD / 16; ++a) {
          tma_load(dst + a * BN * ATOM, &map_k, bar, 16 * a, k_row + pj * BN);
          tma_load(dst + TILE + a * BN * ATOM, &map_k, bar, 16 * a, k_lo_row + k_row + pj * BN);
        }
      } else {
#pragma unroll
        for (int a = 0; a < BN / 16; ++a) {
          tma_load(dst + a * HD * ATOM, &map_v, bar, pj * BN + 16 * a, v_row);
          tma_load(dst + TILE + a * HD * ATOM, &map_v, bar, pj * BN + 16 * a, v_lo_row + v_row);
        }
      }
    }
  };
  const auto wait_full = [&](int e, uint32_t parity) {
    if (producer) {
      do produce();
      while (!mbar_test(full + 8 * e, parity));
    } else {
      mbar_wait(full + 8 * e, parity);
    }
    __syncwarp();
  };
  if (threadIdx.x == 0) produce();

  const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
  const int g = lane / 4, t = lane % 4;
  const int q_wg = q_lo + 64 * wg;        // this warpgroup's first query
  const int qr0 = q_wg + 16 * warp + g;   // this thread's rows: qr0 and qr0 + 8

  // this warpgroup's 64 rows of q, scaled and split once into Q's planes
  for (int e = threadIdx.x % 128; e < 64 * HD / 4; e += 128) {
    const int r = 64 * wg + e / (HD / 4), c = (e % (HD / 4)) * 4, qp = q_lo + r;
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (qp < S)
      x = *reinterpret_cast<const float4*>(q + b * q_sb + qp * q_ss + (long long)h * HD + c);
    uint4 hi, lo;
    split(x.x * scale, hi.x, lo.x);
    split(x.y * scale, hi.y, lo.y);
    split(x.z * scale, hi.z, lo.z);
    split(x.w * scale, hi.w, lo.w);
    const uint32_t off = swizzled(BQ, r, c);
    *reinterpret_cast<uint4*>(smem + off) = hi;
    *reinterpret_cast<uint4*>(smem + C::Q_PLANE + off) = lo;
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // visible to wgmma
  asm volatile("bar.sync %0, 128;" ::"r"(3 + wg) : "memory");

  const float inv_cap = 1.0f / softcap;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f}, oacc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) oacc[i] = 0.0f;
  int e = 0;
  uint32_t phase = 0;
  for (int j = j_begin; j < j_end; ++j) {
    const int k_lo = j * BN;
    // a tile no row of this warpgroup sees (past its last row, before its
    // first row's window, or every row past S): its entries are waited for
    // and released, nothing computed
    const bool dead = q_wg >= S || (causal && k_lo > q_wg + 63) ||
                      (window > 0 && q_wg - (k_lo + BN - 1) >= window);

    // S = Q K^T: slice c of hd into sacc[c], then sacc[0] += sacc[c] in order
    wait_full(e, phase);
    float sacc[NS][BN / 2];
    if (!dead) {
      // Q's and K's operands for hd columns 8 kk .. 8 kk + 7, plane 0 (hi) or 1 (lo)
      const uint64_t dq = desc64(base + wg * 64 * ATOM), dk = desc64(ring + e * ENTRY);
      const auto q_desc = [&](int plane, int kk) {
        return at(dq, plane * C::Q_PLANE + (kk / 2) * BQ * ATOM + (kk % 2) * 32);
      };
      const auto k_desc = [&](int plane, int kk) {
        return at(dk, plane * TILE + (kk / 2) * BN * ATOM + (kk % 2) * 32);
      };
#pragma unroll
      for (int c = 0; c < NS; ++c)
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) pin(sacc[c][i]);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < NS; ++c) {
        constexpr int W = 32;
        const int steps = (c + 1) * W <= HD ? 4 : (HD % W) / 8;
#pragma unroll
        for (int kk = 0; kk < steps; ++kk)
          wgmma_ss(sacc[c], q_desc(1, 4 * c + kk), k_desc(0, 4 * c + kk), kk > 0);
#pragma unroll
        for (int kk = 0; kk < steps; ++kk)
          wgmma_ss(sacc[c], q_desc(0, 4 * c + kk), k_desc(1, 4 * c + kk), 1);
#pragma unroll
        for (int kk = 0; kk < steps; ++kk)
          wgmma_ss(sacc[c], q_desc(0, 4 * c + kk), k_desc(0, 4 * c + kk), 1);
      }
      wgmma_commit();
    }
    if (!dead) {
      wgmma_wait_all();
#pragma unroll
      for (int c = 0; c < NS; ++c)
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) pin(sacc[c][i]);
    }
    if (lane == 0) mbar_arrive(empty + 8 * e);
    if (++e == C::ENTRIES) e = 0, phase ^= 1;

    float(&s)[BN / 2] = sacc[0];
    if (!dead) {
#pragma unroll
      for (int c = 1; c < NS; ++c)
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) s[i] += sacc[c][i];

      // online softmax over this tile; element 4 j + e2 of a thread is row
      // qr0 + 8 (e2 / 2), key k_lo + 8 j + 2 t + e2 % 2
      const bool edge = k_lo + BN > S || (causal && k_lo + BN - 1 > q_wg) ||
                        (window > 0 && q_wg + 63 - k_lo >= window);
      float rmax[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int jj = 0; jj < BN / 8; ++jj)
#pragma unroll
        for (int e2 = 0; e2 < 4; ++e2) {
          float x = s[4 * jj + e2];
          if (softcap > 0.0f) x = softcap * tanhf(x * inv_cap);
          if (edge) {
            const int kp = k_lo + 8 * jj + 2 * t + (e2 & 1), qp = qr0 + (e2 >> 1) * 8;
            bool ok = kp < S;
            if (causal) ok = ok && qp >= kp;
            if (window > 0) ok = ok && (qp - kp) < window;
            x = ok ? x : NEG_INF;
            rmax[e2 >> 1] = fmaxf(rmax[e2 >> 1], x);
            // a ragged key column is not a key at all: it must not add
            // exp(0) to a row that is all NEG_INF
            if (kp >= S) x = __int_as_float(0xff800000);  // -inf
          } else {
            rmax[e2 >> 1] = fmaxf(rmax[e2 >> 1], x);
          }
          s[4 * jj + e2] = x;
        }
      float corr[2], rsum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        rmax[i] = fmaxf(rmax[i], __shfl_xor_sync(0xffffffffu, rmax[i], 1));
        rmax[i] = fmaxf(rmax[i], __shfl_xor_sync(0xffffffffu, rmax[i], 2));
        const float m_new = fmaxf(m[i], rmax[i]);
        corr[i] = expf(m[i] - m_new);
        m[i] = m_new;
      }
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const float p = expf(s[i] - m[(i >> 1) & 1]);
        s[i] = p;
        rsum[(i >> 1) & 1] += p;
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        rsum[i] += __shfl_xor_sync(0xffffffffu, rsum[i], 1);
        rsum[i] += __shfl_xor_sync(0xffffffffu, rsum[i], 2);
        l[i] = l[i] * corr[i] + rsum[i];
      }
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) oacc[i] *= corr[(i >> 1) & 1];
    }

    // O += P V: each 32 keys and NC columns of hd summed in a fresh fragment.
    // P's accumulator fragment is P V's A fragment (V^T's keys reordered to
    // match): a = (c0, c2, c1, c3) of each 8 keys.
    uint32_t ph[BN / 8][4], pl[BN / 8][4];
    wait_full(e, phase);
    if (!dead) {
      const uint64_t dv = desc64(ring + e * ENTRY);
      const auto v_desc = [&](int plane, int kk, int c) {
        return at(dv, plane * TILE + (kk / 2) * HD * ATOM + c * NC * ATOM + (kk % 2) * 32);
      };
#pragma unroll
      for (int n = 0; n < NH; ++n) {
#pragma unroll
        for (int kk = 4 * n; kk < 4 * n + 4; ++kk) {
          split(s[4 * kk], ph[kk][0], pl[kk][0]);
          split(s[4 * kk + 2], ph[kk][1], pl[kk][1]);
          split(s[4 * kk + 1], ph[kk][2], pl[kk][2]);
          split(s[4 * kk + 3], ph[kk][3], pl[kk][3]);
        }
#pragma unroll
        for (int c = 0; c < HD / NC; ++c) {
          float p1[NC / 2];
#pragma unroll
          for (int kk = 4 * n; kk < 4 * n + 4; ++kk)
#pragma unroll
            for (int i = 0; i < 4; ++i) pin(ph[kk][i]), pin(pl[kk][i]);
#pragma unroll
          for (int i = 0; i < NC / 2; ++i) pin(p1[i]);
          wgmma_fence();
#pragma unroll
          for (int kk = 4 * n; kk < 4 * n + 4; ++kk)
            wgmma_rs(p1, pl[kk], v_desc(0, kk, c), kk > 4 * n);
#pragma unroll
          for (int kk = 4 * n; kk < 4 * n + 4; ++kk)
            wgmma_rs(p1, ph[kk], v_desc(1, kk, c), 1);
#pragma unroll
          for (int kk = 4 * n; kk < 4 * n + 4; ++kk)
            wgmma_rs(p1, ph[kk], v_desc(0, kk, c), 1);
          wgmma_commit();
          wgmma_wait_all();
#pragma unroll
          for (int i = 0; i < NC / 2; ++i) pin(p1[i]);
#pragma unroll
          for (int i = 0; i < NC / 2; ++i) oacc[c * NC / 2 + i] += p1[i];
        }
      }
    }
    if (lane == 0) mbar_arrive(empty + 8 * e);
    if (++e == C::ENTRIES) e = 0, phase ^= 1;
  }

  // O's accumulator (64 x hd a warpgroup): element 4 j + e2 of a thread is
  // row qr0 + 8 (e2 / 2), column 8 j + 2 t + e2 % 2
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qp = qr0 + 8 * i;
    if (qp >= S) continue;
    const float inv = 1.0f / fmaxf(l[i], 1e-30f);
    if (lse != nullptr && t == 0)
      lse[((long long)b * H + h) * S + qp] = m[i] + logf(fmaxf(l[i], 1e-30f));
    float* orow = o + (((long long)b * S + qp) * H + h) * HD + 2 * t;
#pragma unroll
    for (int jj = 0; jj < HD / 8; ++jj)
      *reinterpret_cast<float2*>(&orow[jj * 8]) =
          make_float2(oacc[4 * jj + 2 * i] * inv, oacc[4 * jj + 2 * i + 1] * inv);
  }
}

template <int HD>
int launch(const float* q, const float* k, const float* v, float* o, float* lse, float* planes,
           int B, int S, int H, int KH, long long q_sb, long long q_ss, long long k_sb,
           long long k_ss, long long v_sb, long long v_ss, int causal, int window,
           float softcap, float scale, cudaStream_t st) {
  using C = Cfg<HD>;
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const int S_pad = (S + PLANE_KEYS - 1) / PLANE_KEYS * PLANE_KEYS, bkh = B * KH;
  const long long plane = (long long)bkh * S_pad * HD;
  CUtensorMap map_k, map_v;  // K's planes (2 B KH S_pad, hd); V^T's (2 B KH hd, S_pad)
  if (!encode(enc, &map_k, planes, 2LL * bkh * S_pad, HD, 16, C::BN, CU_TENSOR_MAP_SWIZZLE_64B) ||
      !encode(enc, &map_v, planes + 2 * plane, 2LL * bkh * HD, S_pad, 16, HD,
              CU_TENSOR_MAP_SWIZZLE_64B))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel_wgmma<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  flash_fwd_kernel_planes<HD><<<dim3((unsigned)(S_pad / PLANE_KEYS), (unsigned)bkh), 256, 0, st>>>(
      k, v, planes, S, S_pad, KH, k_sb, k_ss, v_sb, v_ss);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(B * H), (unsigned)((S + BQ - 1) / BQ));
  flash_fwd_kernel_wgmma<HD><<<grid, THREADS, C::SMEM, st>>>(
      map_k, map_v, q, o, lse, S, S_pad, H, H / KH, q_sb, q_ss, causal, window, softcap, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// the forward at hd 64, 80, 112, 128 (csrc/flash_attention.cu's entry routes
// them here); planes: scratch of 4 B KH S_pad hd floats, S_pad = S rounded
// up to 64
int seifer_flash_fwd_wgmma(const float* q, const float* k, const float* v, float* o,
                           float* lse, float* planes, int B, int S, int H, int KH, int hd,
                           long long q_sb, long long q_ss, long long k_sb, long long k_ss,
                           long long v_sb, long long v_ss, int causal, int window,
                           float softcap, float scale, cudaStream_t st) {
  switch (hd) {
#define SEIFER_FLASH_WGMMA_CASE(D)                                                       \
  case D:                                                                                \
    return launch<D>(q, k, v, o, lse, planes, B, S, H, KH, q_sb, q_ss, k_sb, k_ss, v_sb, \
                     v_ss, causal, window, softcap, scale, st);
    SEIFER_FLASH_WGMMA_CASE(64)
    SEIFER_FLASH_WGMMA_CASE(80)
    SEIFER_FLASH_WGMMA_CASE(112)
    SEIFER_FLASH_WGMMA_CASE(128)
#undef SEIFER_FLASH_WGMMA_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

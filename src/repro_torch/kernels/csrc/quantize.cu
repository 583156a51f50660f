// Blockwise int8 boundary codec for Hopper (sm_90a): quantize, dequantize,
// and the fused dequantize-into-matmul of the receiving stage.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/quantize/kernel.py:
//   quantize_int8_tpu   (_quant_kernel)  -> quantize_int8_kernel
//   dequantize_int8_tpu (_dequant_kernel) -> dequantize_int8_kernel
//   dequant_matmul_tpu  (_dqmm_kernel)    -> dequant_matmul_kernel
//
// What bounds them on an H100, and what the design does about it:
//
// * quantize / dequantize are memory-bound (about one operation per byte
//   moved; the card needs ~20 f32 operations per byte before compute
//   matters).  Each input byte is read once and each output byte written
//   once: quantize gives one warp to one (row, block) slice, reduces |x|
//   with warp shuffles in registers, and writes codes and the scale
//   straight out; the ragged last block is masked, never padded in device
//   memory.  Codes and scales are bit-identical to the plain version: the
//   scale is max|x| * f32(1/127), as the JAX package computes it under jit
//   (XLA rewrites the division by a constant), the codes take an IEEE
//   division (no --use_fast_math) and rintf, which rounds half to even like
//   torch.round / jnp.round.
// * dequantize writes 4 bytes (f32) for every byte it reads, so its time is
//   its stores.  The vector path gives a warp 512 consecutive codes: each
//   lane loads 16 of them with one 16-byte load and stages them in shared
//   memory, then writes 4-code groups so that every store instruction of
//   the warp covers 512 (f32) or 256 (bf16) contiguous bytes.  A lane that
//   stores its own 16 codes' outputs instead (four float4 stores, lanes 64
//   bytes apart) leaves every 32-byte sector of a store instruction half
//   written, and timed far slower on an H100.  Row and scale block come
//   from one division per 16 codes and one per 4-code group, none per
//   element.  The scalar path (one element a thread) takes what the vector
//   path cannot: d or block not a multiple of 16, q or out not 16-byte
//   aligned.  Both multiply in f32 and round to bf16 to nearest even, as
//   the plain version does, so the output is the same bits.
// * dequant_matmul is bound by operations: 2*n*d*dout FLOPs against
//   n*d + d*dout*4 bytes.  It runs on the TF32 tensor cores (mma.sync
//   m16n8k8) and still holds the 1e-5 f32 pin: the int8 codes are exact in
//   TF32, so only w is split into hi + lo (split_tf32.cuh) and each product
//   costs two passes, FLOPs * 2 / 495 TFLOP/s at least.  The scale stays out
//   of the A operand: each quantisation block's q_blk @ w_blk is summed in
//   its own accumulator, then added times scale[row, blk] into the output
//   accumulator, so the dequantized activation is never formed, not even in
//   shared memory.  The TPU kernel keeps all of w resident in VMEM; here a
//   block owns 128 x 128 outputs and streams 64-deep slices of codes and w
//   through a 4-stage cp.async ring, so the next slices load while this one
//   multiplies.  Blocks are rastered in groups of 8 row tiles, so w is read
//   from device memory about once per 8 row tiles, not once per row tile.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "split_tf32.cuh"

namespace {

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// One warp per (row, block) slice of x (n, d): scale = max|x| * (1/127),
// q = clip(rint(x / max(scale, 1e-12)), -127, 127).
template <typename T>
__global__ void quantize_int8_kernel(const T* __restrict__ x,
                                     int8_t* __restrict__ q,
                                     float* __restrict__ s, long long n, int d,
                                     int block, int nb) {
  const long long slice =
      (long long)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (slice >= n * nb) return;
  const long long row = slice / nb;
  const int b = (int)(slice % nb);
  const int c0 = b * block;
  const int c1 = min(c0 + block, d);  // ragged last block: masked
  const T* xr = x + row * d;
  float amax = 0.0f;
  for (int c = c0 + lane; c < c1; c += 32) amax = fmaxf(amax, fabsf(load_f32(xr + c)));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float scale = amax * (1.0f / 127.0f);
  const float safe = fmaxf(scale, 1e-12f);
  int8_t* qr = q + row * d;
  for (int c = c0 + lane; c < c1; c += 32) {
    float r = rintf(load_f32(xr + c) / safe);
    r = fminf(fmaxf(r, -127.0f), 127.0f);
    qr[c] = (int8_t)(int)r;
  }
  if (lane == 0) s[row * nb + b] = scale;
}

template <typename T>
__device__ __forceinline__ void store_as(T* p, float v);
template <>
__device__ __forceinline__ void store_as<float>(float* p, float v) { *p = v; }
template <>
__device__ __forceinline__ void store_as<__nv_bfloat16>(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Scalar path, one thread per element: out = q * scale[row, col / block].
template <typename T>
__global__ void dequantize_int8_kernel(const int8_t* __restrict__ q,
                                       const float* __restrict__ s,
                                       T* __restrict__ out, long long n, int d,
                                       int block, int nb) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n * d) return;
  const long long row = i / d;
  const int col = (int)(i % d);
  store_as<T>(out + i, (float)q[i] * s[row * nb + col / block]);
}

constexpr int DQ_THREADS = 256;

__device__ __forceinline__ float code_of(int word, int byte) {
  return (float)(int8_t)(word >> (8 * byte));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

// The 4 outputs of one 4-code word at element e (16-byte aligned for f32).
__device__ __forceinline__ void store4(float* out, size_t e, int word, float sc) {
  *reinterpret_cast<float4*>(out + e) =
      make_float4(code_of(word, 0) * sc, code_of(word, 1) * sc,
                  code_of(word, 2) * sc, code_of(word, 3) * sc);
}
__device__ __forceinline__ void store4(__nv_bfloat16* out, size_t e, int word, float sc) {
  *reinterpret_cast<uint2*>(out + e) =
      make_uint2(pack_bf16x2(code_of(word, 0) * sc, code_of(word, 1) * sc),
                 pack_bf16x2(code_of(word, 2) * sc, code_of(word, 3) * sc));
}

// Vector path.  Codes are counted in vectors of 16 (nvec of them, vpr a
// row, vpb a quantisation block); each warp takes 32 vectors.  Lane t
// loads vector t into shared memory; then in step j it converts the 4-code
// word 32j + t of the warp's 512 codes, which lies in vector 8j + t/4, so
// the warp's 32 lanes store 128 contiguous outputs per step.
template <typename T>
__global__ void __launch_bounds__(DQ_THREADS)
dequantize_int8_vec_kernel(const int8_t* __restrict__ q, const float* __restrict__ s,
                           T* __restrict__ out, unsigned nvec, unsigned vpr,
                           unsigned vpb, unsigned nb) {
  __shared__ int4 stage[DQ_THREADS / 32][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned v0 = (blockIdx.x * (DQ_THREADS / 32) + warp) * 32;
  if (v0 >= nvec) return;
  if (v0 + lane < nvec)
    stage[warp][lane] = __ldg(reinterpret_cast<const int4*>(q) + v0 + lane);
  __syncwarp();
  const int* words = reinterpret_cast<const int*>(stage[warp]);
  unsigned v = v0 + lane / 4;
  unsigned row = v / vpr, c16 = v - row * vpr;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (v < nvec) {
      const float sc = __ldg(s + (size_t)row * nb + c16 / vpb);
      store4(out, (size_t)v * 16 + 4 * (lane & 3), words[32 * j + lane], sc);
    }
    v += 8;  // the next step's vector: 8 further on, maybe rows further
    c16 += 8;
    while (c16 >= vpr) {
      c16 -= vpr;
      ++row;
    }
  }
}

// The vector path takes d and block multiples of 16, q and out 16-byte
// aligned and fewer than 2**31 vectors of 16 codes; the scalar path the rest.
template <typename T>
int launch_dequantize(const int8_t* q, const float* s, T* out, long long n, int d,
                      int block, int nb, cudaStream_t st) {
  const long long nvec = n * d / 16;
  const bool vec = d % 16 == 0 && block % 16 == 0 && (uintptr_t)q % 16 == 0 &&
                   (uintptr_t)out % 16 == 0 && nvec < (1ll << 31);
  if (vec) {
    const unsigned per_block = DQ_THREADS / 32 * 32;
    dequantize_int8_vec_kernel<T><<<(unsigned)((nvec + per_block - 1) / per_block),
                                    DQ_THREADS, 0, st>>>(
        q, s, out, (unsigned)nvec, (unsigned)(d / 16), (unsigned)(block / 16),
        (unsigned)nb);
  } else {
    dequantize_int8_kernel<T><<<(unsigned)((n * d + DQ_THREADS - 1) / DQ_THREADS),
                                DQ_THREADS, 0, st>>>(q, s, out, n, d, block, nb);
  }
  return (int)cudaGetLastError();
}

// dequant_matmul on the tensor cores.  out (n, dout) f32 = sum over
// quantisation blocks of scale[row, blk] * (q_blk @ w_blk): the codes go in
// as exact TF32 A operands and w as hi + lo (two passes per product), each
// block's sum is taken in its own accumulator and then scaled into the
// output accumulator.  A block tile is 128 x 128 outputs, 8 warps of 64 x 32
// (255 registers a thread, one block per SM); k advances 64 at a time
// through a ring of 4 shared-memory stages (int8 codes, rows padded to 80
// bytes; w, rows padded to 132 floats: fragment reads are free of bank
// conflicts).  A tile inside one quantisation block (every tile when the
// block is a multiple of 64, as on the served path) runs its 8 k steps with
// no branch; a tile where a block ends steps through masked passes.  VEC
// (d % 16 == 0, dout % 4 == 0, 16-byte aligned q and w) stages by
// cp.async, 16 bytes per copy; otherwise each element is loaded and
// zero-filled by hand.
constexpr int MM_BM = 128, MM_BN = 128, MM_BK = 64, MM_STAGES = 4;
constexpr int MM_THREADS = 256;
constexpr int MM_AS = MM_BK + 16;  // bytes per staged code row
constexpr int MM_WS = MM_BN + 4;   // floats per staged w row
constexpr int MM_GROUP = 8;        // row tiles that share a band of w in L2
constexpr size_t MM_A_BYTES = (size_t)MM_BM * MM_AS;
constexpr size_t MM_W_BYTES = sizeof(float) * MM_BK * MM_WS;
constexpr size_t MM_SMEM = MM_STAGES * (MM_A_BYTES + MM_W_BYTES);

template <bool VEC>
__device__ __forceinline__ void dqmm_load_stage(int8_t* As, float* Ws,
                                                const int8_t* __restrict__ q,
                                                const float* __restrict__ w,
                                                long long n, int d, int dout,
                                                long long row0, int col0, int k0,
                                                int tid) {
  if (VEC) {
#pragma unroll
    for (int i = 0; i < MM_BM * MM_BK / 16 / MM_THREADS; ++i) {
      const int e = tid + i * MM_THREADS, r = e / (MM_BK / 16), c = (e % (MM_BK / 16)) * 16;
      const long long gr = row0 + r;
      const bool in = gr < n && k0 + c < d;
      split_tf32::cp_async16(As + r * MM_AS + c, q + (in ? gr * d + k0 + c : 0), in ? 16 : 0);
    }
#pragma unroll
    for (int i = 0; i < MM_BK * MM_BN / 4 / MM_THREADS; ++i) {
      const int e = tid + i * MM_THREADS, r = e / (MM_BN / 4), c = (e % (MM_BN / 4)) * 4;
      const int gk = k0 + r, gc = col0 + c;
      const bool in = gk < d && gc < dout;
      split_tf32::cp_async16(Ws + r * MM_WS + c, w + (in ? (long long)gk * dout + gc : 0),
                             in ? 16 : 0);
    }
  } else {
    for (int e = tid; e < MM_BM * MM_BK; e += MM_THREADS) {
      const int r = e / MM_BK, kk = e % MM_BK;
      const long long gr = row0 + r;
      const int gk = k0 + kk;
      As[r * MM_AS + kk] = (gr < n && gk < d) ? q[gr * d + gk] : (int8_t)0;
    }
    for (int e = tid; e < MM_BK * MM_BN; e += MM_THREADS) {
      const int r = e / MM_BN, c = e % MM_BN;
      const int gk = k0 + r, gc = col0 + c;
      Ws[r * MM_WS + c] = (gk < d && gc < dout) ? w[(long long)gk * dout + gc] : 0.0f;
    }
  }
}

constexpr int MM_MT = 4, MM_NT = 4;  // 16-row and 8-column fragments per warp

// the A fragments of MM_MT row groups at k step k0: codes at k0 + 2t and
// k0 + 2t + 1 of rows g and g + 8, a = (c(g, 2t), c(g + 8, 2t), c(g, 2t + 1),
// c(g + 8, 2t + 1)), exact in TF32
__device__ __forceinline__ void dqmm_codes(uint32_t (&a)[MM_MT][4], const int8_t* At, int k0) {
#pragma unroll
  for (int mt = 0; mt < MM_MT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const uint32_t pair =
          *reinterpret_cast<const uint16_t*>(At + (mt * 16 + half * 8) * MM_AS + k0);
      a[mt][half] = __float_as_uint((float)(int8_t)(pair & 0xffu));
      a[mt][half + 2] = __float_as_uint((float)(int8_t)(pair >> 8));
    }
}

// acc += a (codes) . w over one 8-deep k step, w split into hi + lo
__device__ __forceinline__ void dqmm_step(float (&acc)[MM_MT][MM_NT][4],
                                          const uint32_t (&a)[MM_MT][4],
                                          const float* wk) {
#pragma unroll
  for (int nt = 0; nt < MM_NT; ++nt) {
    uint32_t bh0, bl0, bh1, bl1;
    split_tf32::split(wk[nt * 8], bh0, bl0);
    split_tf32::split(wk[MM_WS + nt * 8], bh1, bl1);
#pragma unroll
    for (int mt = 0; mt < MM_MT; ++mt) {
      split_tf32::mma(acc[mt][nt], a[mt], bl0, bl1);
      split_tf32::mma(acc[mt][nt], a[mt], bh0, bh1);
    }
  }
}

// out += scale[row, blk] * bacc and bacc = 0; rows beyond n read no scale
__device__ __forceinline__ void dqmm_flush(float (&oacc)[MM_MT][MM_NT][4],
                                           float (&bacc)[MM_MT][MM_NT][4],
                                           const float* __restrict__ s, long long row,
                                           long long n, int nb, int blk) {
  if (blk >= nb) return;  // only zero-filled codes past d
#pragma unroll
  for (int mt = 0; mt < MM_MT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long gr = row + mt * 16 + half * 8;
      const float sc = gr < n ? s[gr * nb + blk] : 0.0f;
#pragma unroll
      for (int nt = 0; nt < MM_NT; ++nt)
#pragma unroll
        for (int e = 2 * half; e < 2 * half + 2; ++e) {
          oacc[mt][nt][e] = fmaf(sc, bacc[mt][nt][e], oacc[mt][nt][e]);
          bacc[mt][nt][e] = 0.0f;
        }
    }
}

template <bool VEC>
__global__ void __launch_bounds__(MM_THREADS, 1)
dequant_matmul_kernel(const int8_t* __restrict__ q, const float* __restrict__ s,
                      const float* __restrict__ w, float* __restrict__ out,
                      long long n, int d, int dout, int block, int nb) {
  extern __shared__ __align__(16) unsigned char mm_smem[];
  int8_t* As = reinterpret_cast<int8_t*>(mm_smem);
  float* Ws = reinterpret_cast<float*>(mm_smem + MM_STAGES * MM_A_BYTES);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps of 64 x 32

  // grouped raster: MM_GROUP row tiles walk the column tiles together
  const int num_m = (int)((n + MM_BM - 1) / MM_BM), num_n = (dout + MM_BN - 1) / MM_BN;
  const int per_group = MM_GROUP * num_n, first_m = (blockIdx.x / per_group) * MM_GROUP;
  const int gsize = min(num_m - first_m, MM_GROUP);
  const int tile_m = first_m + (blockIdx.x % per_group) % gsize;
  const int tile_n = (blockIdx.x % per_group) / gsize;
  const long long row0 = (long long)tile_m * MM_BM;
  const int col0 = tile_n * MM_BN;

  float bacc[MM_MT][MM_NT][4], oacc[MM_MT][MM_NT][4];
#pragma unroll
  for (int mt = 0; mt < MM_MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < MM_NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) bacc[mt][nt][e] = oacc[mt][nt][e] = 0.0f;

  const long long row_w = row0 + wm * 64 + g;  // this lane's first row

  const int KT = (d + MM_BK - 1) / MM_BK;
#pragma unroll
  for (int st = 0; st < MM_STAGES - 1; ++st) {
    if (st < KT)
      dqmm_load_stage<VEC>(As + st * MM_A_BYTES, Ws + st * MM_BK * MM_WS, q, w, n, d, dout,
                           row0, col0, st * MM_BK, tid);
    split_tf32::cp_async_commit();
  }

  int blk = 0, next_flush = block;  // k where the current quantisation block ends
  for (int kt = 0; kt < KT; ++kt) {
    split_tf32::cp_async_wait<MM_STAGES - 2>();  // tile kt has landed
    __syncthreads();  // ... for every thread, and tile kt - 1 is consumed
    const int ahead = kt + MM_STAGES - 1;
    if (ahead < KT) {
      const int st = ahead % MM_STAGES;
      dqmm_load_stage<VEC>(As + st * MM_A_BYTES, Ws + st * MM_BK * MM_WS, q, w, n, d, dout,
                           row0, col0, ahead * MM_BK, tid);
    }
    split_tf32::cp_async_commit();

    const int st = kt % MM_STAGES;
    const int8_t* At = As + st * MM_A_BYTES + (wm * 64 + g) * MM_AS + 2 * t;
    const float* Wt = Ws + st * MM_BK * MM_WS + 2 * t * MM_WS + wn * 32 + g;
    const int k_tile = kt * MM_BK;
    if (next_flush >= k_tile + MM_BK) {  // no quantisation block ends inside the tile
#pragma unroll
      for (int k0 = 0; k0 < MM_BK; k0 += 8) {
        uint32_t a[MM_MT][4];
        dqmm_codes(a, At, k0);
        dqmm_step(bacc, a, Wt + k0 * MM_WS);
      }
      if (next_flush == k_tile + MM_BK) {
        dqmm_flush(oacc, bacc, s, row_w, n, nb, blk++);
        next_flush += block;
      }
      continue;
    }
    // a block ends inside the tile: one masked pass per block a step touches
#pragma unroll 1
    for (int k0 = 0; k0 < MM_BK; k0 += 8) {
      uint32_t a[MM_MT][4];
      dqmm_codes(a, At, k0);
      const int kg = k_tile + k0;
      for (int lo = kg; lo < kg + 8;) {
        const int hi = min(next_flush, kg + 8);
        const bool keep0 = kg + 2 * t >= lo && kg + 2 * t < hi;
        const bool keep1 = kg + 2 * t + 1 >= lo && kg + 2 * t + 1 < hi;
        uint32_t am[MM_MT][4];
#pragma unroll
        for (int mt = 0; mt < MM_MT; ++mt) {
          am[mt][0] = keep0 ? a[mt][0] : 0u;
          am[mt][1] = keep0 ? a[mt][1] : 0u;
          am[mt][2] = keep1 ? a[mt][2] : 0u;
          am[mt][3] = keep1 ? a[mt][3] : 0u;
        }
        dqmm_step(bacc, am, Wt + k0 * MM_WS);
        if (hi == next_flush) {
          dqmm_flush(oacc, bacc, s, row_w, n, nb, blk++);
          next_flush += block;
        }
        lo = hi;
      }
    }
  }
  dqmm_flush(oacc, bacc, s, row_w, n, nb, blk);  // the last block, ragged or cut by d

#pragma unroll
  for (int mt = 0; mt < MM_MT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long gr = row0 + wm * 64 + mt * 16 + g + half * 8;
      if (gr >= n) continue;
#pragma unroll
      for (int nt = 0; nt < MM_NT; ++nt) {
        const int gc = col0 + wn * 32 + nt * 8 + 2 * t;
        float* dst = out + gr * dout + gc;
        if ((dout & 1) == 0 && gc + 1 < dout) {
          *reinterpret_cast<float2*>(dst) =
              make_float2(oacc[mt][nt][2 * half], oacc[mt][nt][2 * half + 1]);
        } else {
          if (gc < dout) dst[0] = oacc[mt][nt][2 * half];
          if (gc + 1 < dout) dst[1] = oacc[mt][nt][2 * half + 1];
        }
      }
    }
}

template <bool VEC>
int launch_dequant_matmul(const int8_t* q, const float* s, const float* w, float* out,
                          long long n, int d, int dout, int block, int nb,
                          cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(dequant_matmul_kernel<VEC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)MM_SMEM);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = ((n + MM_BM - 1) / MM_BM) * ((dout + MM_BN - 1) / MM_BN);
  dequant_matmul_kernel<VEC><<<(unsigned)tiles, MM_THREADS, MM_SMEM, st>>>(
      q, s, w, out, n, d, dout, block, nb);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x_dtype: 0 = float32, 1 = bfloat16.
int seifer_quantize_int8(const void* x, int x_dtype, void* q, void* s,
                         long long n, int d, int block, int nb, void* stream) {
  const int threads = 256, warps = threads / 32;
  const long long slices = n * nb;
  const unsigned grid = (unsigned)((slices + warps - 1) / warps);
  cudaStream_t st = (cudaStream_t)stream;
  if (x_dtype == 0)
    quantize_int8_kernel<float><<<grid, threads, 0, st>>>(
        (const float*)x, (int8_t*)q, (float*)s, n, d, block, nb);
  else
    quantize_int8_kernel<__nv_bfloat16><<<grid, threads, 0, st>>>(
        (const __nv_bfloat16*)x, (int8_t*)q, (float*)s, n, d, block, nb);
  return (int)cudaGetLastError();
}

// out_dtype: 0 = float32, 1 = bfloat16.
int seifer_dequantize_int8(const void* q, const void* s, void* out,
                           int out_dtype, long long n, int d, int block, int nb,
                           void* stream) {
  const int8_t* qi = (const int8_t*)q;
  const float* sf = (const float*)s;
  cudaStream_t st = (cudaStream_t)stream;
  return out_dtype == 0
             ? launch_dequantize(qi, sf, (float*)out, n, d, block, nb, st)
             : launch_dequantize(qi, sf, (__nv_bfloat16*)out, n, d, block, nb, st);
}

int seifer_dequant_matmul(const void* q, const void* s, const void* w, void* out,
                          long long n, int d, int dout, int block, int nb,
                          void* stream) {
  const bool vec = d % 16 == 0 && dout % 4 == 0 && (uintptr_t)q % 16 == 0 &&
                   (uintptr_t)w % 16 == 0;
  const int8_t* qi = (const int8_t*)q;
  const float *sf = (const float*)s, *wf = (const float*)w;
  float* of = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  return vec ? launch_dequant_matmul<true>(qi, sf, wf, of, n, d, dout, block, nb, st)
             : launch_dequant_matmul<false>(qi, sf, wf, of, n, d, dout, block, nb, st);
}

}  // extern "C"

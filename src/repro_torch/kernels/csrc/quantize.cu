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
// * dequant_matmul is bound by operations: 2*n*d*dout f32 FLOPs against
//   n*d + d*dout*4 bytes.  It runs on the f32 FMA units (no TF32, so it
//   holds the 1e-5 f32 pin).  The TPU kernel keeps all of w resident in
//   VMEM; a Hopper block has 227 KB of shared memory, so this kernel tiles
//   both dout and d: a 128x128 output tile per block, a 16-deep slice of d
//   per step, 8x8 outputs per thread in registers (256 threads).  The int8 activation
//   tile is widened and scaled while it is staged into shared memory, so
//   the dequantized activation never reaches device memory.  Tensor cores
//   (wgmma) and TMA pipelining are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

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

// One thread per element: out = q * scale[row, col / block].
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

constexpr int MM_BM = 128, MM_BN = 128, MM_BK = 16;
constexpr int MM_THREADS = 256;  // 16 x 16 threads, 8 x 8 outputs each

// out (n, dout) f32 = dequant(q (n, d), s (n, nb)) @ w (d, dout), f32 FMAs.
// Thread (ty, tx) owns rows {ty*4 + i, 64 + ty*4 + i} and columns
// {tx*4 + j, 64 + tx*4 + j}, i, j < 4: its float4 reads of a shared-memory
// row then fall on 8 consecutive 16-byte words per quarter warp (no bank
// conflicts).  ``vec`` (d % 16 == 0 and block % 8 == 0) stages the int8
// tile as one 8-byte load per thread, 8 codes sharing one scale.
__global__ void __launch_bounds__(MM_THREADS)
dequant_matmul_kernel(const int8_t* __restrict__ q, const float* __restrict__ s,
                      const float* __restrict__ w, float* __restrict__ out,
                      long long n, int d, int dout, int block, int nb, int vec) {
  __shared__ __align__(16) float As[MM_BK][MM_BM];  // dequantized tile, k-major
  __shared__ __align__(16) float Bs[MM_BK][MM_BN];  // weight tile
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const long long row0 = (long long)blockIdx.y * MM_BM;
  const int col0 = blockIdx.x * MM_BN;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < d; k0 += MM_BK) {
    if (vec) {
      const int r = tid / 2, kk0 = (tid % 2) * 8;
      const long long gr = row0 + r;
      float v[8];
      if (gr < n) {
        const int gk = k0 + kk0;
        const int2 raw = *reinterpret_cast<const int2*>(q + gr * d + gk);
        const int8_t* c = reinterpret_cast<const int8_t*>(&raw);
        const float sc = s[gr * nb + gk / block];
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = (float)c[j] * sc;
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = 0.0f;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) As[kk0 + j][r] = v[j];
    } else {
      for (int e = tid; e < MM_BM * MM_BK; e += MM_THREADS) {
        const int r = e / MM_BK, kk = e % MM_BK;
        const long long gr = row0 + r;
        const int gk = k0 + kk;
        float v = 0.0f;
        if (gr < n && gk < d) v = (float)q[gr * d + gk] * s[gr * nb + gk / block];
        As[kk][r] = v;
      }
    }
    for (int e = tid; e < MM_BK * MM_BN; e += MM_THREADS) {
      const int kk = e / MM_BN, c = e % MM_BN;
      const int gk = k0 + kk, gc = col0 + c;
      Bs[kk][c] = (gk < d && gc < dout) ? w[(long long)gk * dout + gc] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < MM_BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long gr = row0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (gr >= n) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gc = col0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (gc < dout) out[gr * dout + gc] = acc[i][j];
    }
  }
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
  const int threads = 256;
  const unsigned grid = (unsigned)((n * d + threads - 1) / threads);
  cudaStream_t st = (cudaStream_t)stream;
  if (out_dtype == 0)
    dequantize_int8_kernel<float><<<grid, threads, 0, st>>>(
        (const int8_t*)q, (const float*)s, (float*)out, n, d, block, nb);
  else
    dequantize_int8_kernel<__nv_bfloat16><<<grid, threads, 0, st>>>(
        (const int8_t*)q, (const float*)s, (__nv_bfloat16*)out, n, d, block, nb);
  return (int)cudaGetLastError();
}

int seifer_dequant_matmul(const void* q, const void* s, const void* w, void* out,
                          long long n, int d, int dout, int block, int nb,
                          void* stream) {
  const dim3 grid((unsigned)((dout + MM_BN - 1) / MM_BN),
                  (unsigned)((n + MM_BM - 1) / MM_BM));
  const int vec = (d % 16 == 0) && (block % 8 == 0);
  dequant_matmul_kernel<<<grid, MM_THREADS, 0, (cudaStream_t)stream>>>(
      (const int8_t*)q, (const float*)s, (const float*)w, (float*)out, n, d,
      dout, block, nb, vec);
  return (int)cudaGetLastError();
}

}  // extern "C"

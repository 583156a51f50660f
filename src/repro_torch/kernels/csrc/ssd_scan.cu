// Chunked Mamba2 SSD scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ssd_chunked_tpu (_ssd_kernel) in
// src/repro/kernels/ssm_scan/kernel.py:66.  For each chunk of Q rows:
//   y     = (C B^T o L o dt) x + (C state^T) o exp(cum)
//   state = state * exp(cum_last) + x^T (B o exp(cum_last - cum) dt)
// with cum the in-chunk prefix sum of dt * a and L = tril(exp(cum_t - cum_s)).
//
// What bounds it on an H100, and what the design does about it:
//
// * Bytes: xs in and y out (B*S*H*dh f32 each) plus bm, cm, dt -- 1.37 GB at
//   the served shape (B=4, S=8192, H=80, dh=N=64), 0.41 ms at 3.35 TB/s.
// * Operations: per (batch row, head, chunk) the three products C B^T and
//   (scores) x over the lower triangle, and C state^T and x^T (B decay) in
//   full, and the state's decay: Q(Q+1)(N+dh) + 4*Q*N*dh + N*dh FLOPs,
//   1.59 MFLOP at Q=N=dh=64, 64.9 GFLOP at the served shape (0.97 ms at
//   67 TFLOP/s f32).  The fewest of any chunking are at Q=4..8: 47.3 GFLOP,
//   0.71 ms, the bound.  So the kernel is bound by operations on the f32
//   FMA units, and Q=64 costs it 37% more of them.  It stays in f32
//   (no TF32 tensor cores): the port holds it to the plain version at
//   1e-5 of max|y|, which TF32's ~1e-3 would break.
// * The TPU runs the chunk axis as the last, sequential grid axis and
//   carries the state in VMEM scratch.  Here one block of 256 threads owns
//   one (batch row, head) and loops over the chunks in order; the (dh, N)
//   state stays in shared memory for the whole sequence.  The TPU kernel
//   takes the chunk cumsum from outside the pallas_call; here warp 0 sums
//   dt * a per chunk in the plain version's fixed order (in order within
//   blocks of 16, then the block totals; no FMA contraction), so cum -- and
//   the decays built from it -- are bit-identical to the plain version's.
// * The kernel tiles at its own chunk, KERNEL_CHUNK = 64, whatever chunk
//   the caller asks for (the math is chunk-invariant): a Q x Q f32 score
//   tile at Q = seq = 8192 would be 256 MiB.  A ragged last chunk and
//   dh, N < 64 are masked (zero-padded in shared memory, never in device
//   memory).  Shared memory: five 64 x 68 f32 tiles (x, B^T aliased by the
//   scores, B o decay, C^T, state^T) = 86 KB, two blocks per SM.  Each
//   thread computes a 4x4 register tile of every product; tiles above the
//   diagonal are skipped.  Tensor cores (wgmma), TMA staging and more
//   than one block per (batch row, head) are later work.

#include <cuda_runtime.h>

constexpr int Q = 64;     // KERNEL_CHUNK: rows per chunk
constexpr int T = 64;     // dh and N are zero-padded to 64 in shared memory
constexpr int LD = 68;    // row stride of the shared tiles, in floats
constexpr int NT = 256;   // threads: a 16 x 16 grid, 4 x 4 outputs each
constexpr int SCAN_BLOCK = 16;  // cum's summation blocks (ref.SCAN_BLOCK)
constexpr int TILE = T * LD;

static size_t smem_bytes() { return (5 * TILE + 3 * Q) * sizeof(float); }

static __device__ __forceinline__ void outer4(float (&acc)[4][4], const float4 a,
                                       const float4 b) {
  const float av[4] = {a.x, a.y, a.z, a.w};
  const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
}

static __device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// grid (H, B): one block per (head, batch row), looping over the chunks.
static __global__ void __launch_bounds__(NT, 2)
ssd_scan_kernel(const float* __restrict__ xs, const float* __restrict__ bm,
                const float* __restrict__ cm, const float* __restrict__ dt,
                const float* __restrict__ a, float* __restrict__ y, int S,
                int H, int dh, int N) {
  extern __shared__ __align__(16) float smem[];
  float* sx = smem;          // x[s][d]
  float* sbt = sx + TILE;    // B^T[n][s]; then the scores S^T[s][t]
  float* sbd = sbt + TILE;   // B[s][n] * exp(cum_last - cum_s) * dt_s
  float* sct = sbd + TILE;   // C^T[n][t]
  float* sst = sct + TILE;   // state^T[n][d]
  float* scum = sst + TILE;  // cum[t]
  float* sw = scum + Q;      // exp(cum_last - cum[s]) * dt[s]
  float* sdt = sw + Q;       // dt[s]

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x;
  const int r0 = (tid >> 4) * 4, c0 = (tid & 15) * 4;
  const float ah = a[h];

  for (int i = tid; i < TILE; i += NT) sst[i] = 0.0f;

  for (int t0 = 0; t0 < S; t0 += Q) {
    const int qv = min(Q, S - t0);
    const long long g0 = (long long)b * S + t0;  // first row of the chunk

    // 1. stage the chunk; warp 0 also builds cum in the plain version's
    //    order: in order within blocks of 16, then the block totals in order
    if (tid < 32) {
      for (int t = tid; t < Q; t += 32)
        sdt[t] = t < qv ? dt[(g0 + t) * H + h] : 0.0f;
      __syncwarp();
      if (tid < Q / SCAN_BLOCK) {
        float run = 0.0f;
        for (int t = tid * SCAN_BLOCK; t < (tid + 1) * SCAN_BLOCK; ++t) {
          run = __fadd_rn(run, __fmul_rn(sdt[t], ah));  // no FMA contraction
          scum[t] = run;
        }
      }
      __syncwarp();
      float within[2], excl[2];
      for (int k = 0; k < 2; ++k) {
        const int t = tid + 32 * k;
        within[k] = scum[t];
        excl[k] = 0.0f;
        for (int j = 0; j < t / SCAN_BLOCK; ++j)
          excl[k] = __fadd_rn(excl[k], scum[j * SCAN_BLOCK + SCAN_BLOCK - 1]);
      }
      __syncwarp();
      for (int k = 0; k < 2; ++k) scum[tid + 32 * k] = __fadd_rn(excl[k], within[k]);
    }
    for (int i = tid; i < Q * T; i += NT) {
      const int t = i / T, c = i % T;  // c indexes d or n
      const bool row = t < qv;
      const long long g = g0 + t;
      sx[t * LD + c] = (row && c < dh) ? xs[(g * H + h) * dh + c] : 0.0f;
      const float bv = (row && c < N) ? bm[g * N + c] : 0.0f;
      sbt[c * LD + t] = bv;
      sbd[t * LD + c] = bv;
      sct[c * LD + t] = (row && c < N) ? cm[g * N + c] : 0.0f;
    }
    __syncthreads();
    const float cum_last = scum[qv - 1];

    // 2. scores S[t][s] = (C_t . B_s) * exp(cum_t - cum_s) * dt_s, s <= t
    float acc[4][4] = {};
    if (c0 <= r0 + 3) {  // the tile touches the lower triangle
#pragma unroll 8
      for (int n = 0; n < T; ++n) outer4(acc, ld4(&sct[n * LD + r0]), ld4(&sbt[n * LD + c0]));
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = r0 + i, s = c0 + j;
        acc[i][j] = s <= t ? acc[i][j] * expf(scum[t] - scum[s]) * sdt[s] : 0.0f;
      }
    if (tid < Q) sw[tid] = expf(cum_last - scum[tid]) * sdt[tid];
    __syncthreads();  // every thread is done reading B^T
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&sbt[(c0 + j) * LD + r0]) =
          make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
    for (int i = tid; i < Q * T; i += NT) sbd[i / T * LD + i % T] *= sw[i / T];
    __syncthreads();

    // 3. y[t][d] = sum_{s<=t} S[t][s] x[s][d] + exp(cum_t) sum_n C[t][n] state[d][n]
    float yi[4][4] = {}, yo[4][4] = {};
    const int s_end = r0 + 4;
    for (int s = 0; s < s_end; ++s) outer4(yi, ld4(&sbt[s * LD + r0]), ld4(&sx[s * LD + c0]));
#pragma unroll 8
    for (int n = 0; n < T; ++n) outer4(yo, ld4(&sct[n * LD + r0]), ld4(&sst[n * LD + c0]));
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = r0 + i;
      if (t >= qv) continue;
      const float e = expf(scum[t]);
      float* yr = y + ((g0 + t) * H + h) * dh;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (c0 + j < dh) yr[c0 + j] = yi[i][j] + yo[i][j] * e;
    }

    // 4. state^T[n][d] = state^T[n][d] * exp(cum_last) + sum_s Bd[s][n] x[s][d]
    float sa[4][4] = {};
#pragma unroll 8
    for (int s = 0; s < Q; ++s) outer4(sa, ld4(&sbd[s * LD + r0]), ld4(&sx[s * LD + c0]));
    const float el = expf(cum_last);
    __syncthreads();  // every thread is done reading the old state (and the tiles)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float* st = &sst[(r0 + i) * LD + c0];
#pragma unroll
      for (int j = 0; j < 4; ++j) st[j] = st[j] * el + sa[i][j];
    }
  }
}

extern "C" int seifer_ssd_scan(const void* xs, const void* bm, const void* cm,
                               const void* dt, const void* a, void* y, int B,
                               int S, int H, int dh, int N, void* stream) {
  if (dh < 1 || dh > T || N < 1 || N > T) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ssd_scan_kernel<<<dim3((unsigned)H, (unsigned)B), NT, smem, (cudaStream_t)stream>>>(
      (const float*)xs, (const float*)bm, (const float*)cm, (const float*)dt,
      (const float*)a, (float*)y, S, H, dh, N);
  return (int)cudaGetLastError();
}

// Flash-attention backward for Hopper (sm_90a): dq, dk, dv in f32 from q, k,
// v, the forward's o and logsumexp, and dO; products on the TF32 tensor
// cores under split precision (split_tf32.cuh).
//
// Replaces the JAX package's custom VJP of its blockwise flash attention,
// src/repro/kernels/flash_attention/ops.py _backward / _bwd_block (jnp, not
// a Pallas call; the Pallas kernel flash_attention_tpu is forward only).
// The math is _bwd_block's: s = q.k scale, capped c tanh(s / c), masked;
// p = exp(capped - lse); D = rowsum(o dO); ds = p (dp - D) (1 - (capped /
// c)^2) with dp = dO.v; dv = p^T dO and dk = ds^T q scale summed over the G
// query heads of each kv head (GQA, H = G KH); dq = ds k scale.  Only O(S)
// residuals are kept (o and lse); the probabilities are recomputed tile by
// tile and never leave the block.
//
// What bounds it on an H100, and what the design does about it: 8 hd
// operations per live (query, key) pair for dK/dV (S^T, dP^T, dV, dK) and
// 6 hd for dQ (S and dP again, then dQ), against reading q, k, v, o, dO and
// writing dq, dk, dv once: bound by operations by two orders of magnitude,
// at three TF32 tensor-core passes per product under split precision.
//
// Three kernels, no atomics (so the gradients are deterministic, as the
// bit-exact resume check needs; the JAX backward adds dq in a fixed order
// too):
//   (a) flash_bwd_dsum_kernel: D = rowsum(o dO), one warp a (b, s, h) row,
//       into a (B, H, S) scratch beside lse;
//   (b) flash_bwd_dkdv_kernel: a block owns 64 keys of one kv head (16 a
//       warp) and loops over the G query heads and the 32-query tiles the
//       causal and window masks leave alive, keeping its dK and dV tiles in
//       mma fragments in registers;
//   (c) flash_bwd_dq_kernel: a block owns 64 queries of one head (16 a warp)
//       and loops over the live 32-key tiles, recomputing s and dp.
// Each product sums at most 12 mma steps in a fresh fragment before it is
// added in f32 (a 32-wide slice of hd for S and dP, one 32-row tile for the
// accumulations), and starts with __syncwarp().  Tiles are loaded by 16-byte
// cp.async (ragged rows zero-filled), single-buffered: two or more blocks
// an SM overlap one block's loads with another's products.  At hd > 128 the
// dK/dV and dQ accumulators would pass the register file, so each block
// writes half of the output columns (grid z = 2) and recomputes S and dP for
// its half.  Masking runs on every element; rows past S are masked, not
// padded.  q, k, v may be strided views of a fused projection (rows at the
// batch and sequence strides given, each row's (heads, hd) block packed and
// 16-byte aligned); o, dO, dq, dk, dv are contiguous.

#include <cuda_runtime.h>

#include "split_tf32.cuh"

namespace {

using split_tf32::cp_async16;
using split_tf32::cp_async_commit;
using split_tf32::cp_async_wait;
using split_tf32::mma;
using split_tf32::split;

constexpr int NW = 4, NT = NW * 32;  // 4 warps a block
constexpr int BR = 16 * NW;          // rows a block owns: keys in (b), queries in (c)
constexpr int BC = 32;               // rows of the tiles a block steps over
constexpr int NCT = BC / 8;          // 8-wide column fragments of an S tile

template <int HD>
struct Dims {
  static constexpr int LD = HD + 8;                   // row stride of every shared tile
  static constexpr int DC = HD <= 128 ? HD : HD / 2;  // output columns a block writes
  static constexpr int NZ = HD / DC;
  static constexpr int NDT = DC / 8;
};

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)(2 * BR + 2 * BC) * Dims<HD>::LD + 2 * BC);
}

// rows [lo, lo + ROWS) of one head, at row stride ss, into a tile of stride LD
template <int HD, int ROWS>
__device__ __forceinline__ void load_rows(float* dst, const float* src, long long ss, int lo,
                                          int S, int tid) {
  constexpr int CH = HD / 4, LD = Dims<HD>::LD;  // 16-byte chunks a row
#pragma unroll 4
  for (int e = tid; e < ROWS * CH; e += NT) {
    const int r = e / CH, c = (e % CH) * 4, p = lo + r;
    const bool in = p < S;
    cp_async16(dst + r * LD + c, src + (long long)(in ? p : 0) * ss + c, in ? 16 : 0);
  }
}

// acc (16 x BC) += A B^T over hd columns [kc, kc + W): arow points at this
// lane's A row g (column 2t), brow at B row g (column 2t); rows g + 8 of A
// and rows 8 nt + g of B follow at the tile stride.  3 split-TF32 mma per 8
// columns into a fresh fragment, W / 8 * 3 <= 12 steps, then added in f32.
template <int LD, int W>
__device__ __forceinline__ void dot_slice(float (&acc)[NCT][4], const float* arow,
                                          const float* brow, int kc) {
  float part[NCT][4] = {};
  __syncwarp();
#pragma unroll
  for (int kk = kc; kk < kc + W; kk += 8) {
    const float2 x0 = *reinterpret_cast<const float2*>(arow + kk);
    const float2 x1 = *reinterpret_cast<const float2*>(arow + 8 * LD + kk);
    uint32_t ah[4], al[4];
    split(x0.x, ah[0], al[0]);
    split(x1.x, ah[1], al[1]);
    split(x0.y, ah[2], al[2]);
    split(x1.y, ah[3], al[3]);
#pragma unroll
    for (int nt = 0; nt < NCT; ++nt) {
      const float2 y = *reinterpret_cast<const float2*>(brow + nt * 8 * LD + kk);
      uint32_t bh0, bl0, bh1, bl1;
      split(y.x, bh0, bl0);
      split(y.y, bh1, bl1);
      mma(part[nt], al, bh0, bh1);
      mma(part[nt], ah, bl0, bl1);
      mma(part[nt], ah, bh0, bh1);
    }
  }
#pragma unroll
  for (int nt = 0; nt < NCT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] += part[nt][e];
}

// acc = A B^T over all of hd (a head dim that is not a multiple of 32 ends
// in one 16-wide slice)
template <int HD>
__device__ __forceinline__ void dot_rows(float (&acc)[NCT][4], const float* arow,
                                         const float* brow) {
  constexpr int LD = Dims<HD>::LD;
#pragma unroll
  for (int nt = 0; nt < NCT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;
#pragma unroll 1
  for (int kc = 0; kc < HD - HD % 32; kc += 32) dot_slice<LD, 32>(acc, arow, brow, kc);
  if constexpr (HD % 32 != 0) dot_slice<LD, HD % 32>(acc, arow, brow, HD - HD % 32);
}

// a C fragment (16 x BC) split into hi + lo A fragments: column t is key
// 2t, column t + 4 key 2t + 1, so a = (c0, c2, c1, c3) with no shuffles
__device__ __forceinline__ void to_frag(const float (&c)[NCT][4], uint32_t (&h)[NCT][4],
                                        uint32_t (&l)[NCT][4]) {
#pragma unroll
  for (int kt = 0; kt < NCT; ++kt) {
    split(c[kt][0], h[kt][0], l[kt][0]);
    split(c[kt][2], h[kt][1], l[kt][1]);
    split(c[kt][1], h[kt][2], l[kt][2]);
    split(c[kt][3], h[kt][3], l[kt][3]);
  }
}

// out (16 x DC) += P (16 x BC) B (BC x DC): bcol points at B row 2t, output
// column g of this block's first column.  Each 8-column fragment sums one
// tile's 4 x 3 = 12 mma steps fresh, then is added in f32.
template <int NDT, int LD>
__device__ __forceinline__ void acc_pb(float (&out)[NDT][4], const uint32_t (&ph)[NCT][4],
                                       const uint32_t (&pl)[NCT][4], const float* bcol) {
#pragma unroll
  for (int dt = 0; dt < NDT; ++dt) {
    float part[4] = {};
    __syncwarp();
#pragma unroll
    for (int kt = 0; kt < NCT; ++kt) {
      uint32_t bh0, bl0, bh1, bl1;
      split(bcol[kt * 8 * LD + dt * 8], bh0, bl0);
      split(bcol[(kt * 8 + 1) * LD + dt * 8], bh1, bl1);
      mma(part, pl[kt], bh0, bh1);
      mma(part, ph[kt], bl0, bl1);
      mma(part, ph[kt], bh0, bh1);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) out[dt][e] += part[e];
  }
}

// p and ds of one (query, key) pair from the raw q.k and dO.v
__device__ __forceinline__ void pair_grads(float& s_p, float& dp_ds, int qp, int kp, int S,
                                           int causal, int window, float softcap, float scale,
                                           float lse, float dsum) {
  float s = s_p * scale, dcap = 1.0f;
  if (softcap > 0.0f) {
    const float r = tanhf(s / softcap);
    s = softcap * r;
    dcap = 1.0f - r * r;
  }
  bool ok = qp < S && kp < S;
  if (causal) ok = ok && qp >= kp;
  if (window > 0) ok = ok && (qp - kp) < window;
  const float p = ok ? expf(s - lse) : 0.0f;
  s_p = p;
  dp_ds = p * (dp_ds - dsum) * dcap;
}

__global__ void flash_bwd_dsum_kernel(const float* __restrict__ o, const float* __restrict__ dout,
                                      float* __restrict__ dsum, long long rows, int S, int H,
                                      int HD) {
  const long long row = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const float* orow = o + row * HD;
  const float* drow = dout + row * HD;
  float acc = 0.0f;
  for (int c = lane; c < HD; c += 32) acc += orow[c] * drow[c];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const long long h = row % H, s = (row / H) % S, b = row / ((long long)H * S);
    dsum[(b * H + h) * S + s] = acc;
  }
}

template <int HD>
__global__ void __launch_bounds__(NT)
flash_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ dsum,
                      float* __restrict__ dk, float* __restrict__ dv, int S, int H, int KH,
                      long long q_sb, long long q_ss, long long k_sb, long long k_ss,
                      long long v_sb, long long v_ss, int causal, int window, float softcap,
                      float scale) {
  using D = Dims<HD>;
  constexpr int LD = D::LD, DC = D::DC, NDT = D::NDT;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;           // [BR][LD] this block's keys
  float* Vs = Ks + BR * LD;   // [BR][LD]
  float* Qs = Vs + BR * LD;   // [BC][LD] one query tile
  float* Gs = Qs + BC * LD;   // [BC][LD] its dO
  float* Ls = Gs + BC * LD;   // [BC] its lse
  float* Ds = Ls + BC;        // [BC] its D
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int z = blockIdx.x % D::NZ, bk = blockIdx.x / D::NZ;
  const int kvh = bk % KH, b = bk / KH, G = H / KH;
  const int k_lo = blockIdx.y * BR;  // the heaviest causal tiles (lowest keys) first
  const int c0 = z * DC;
  const int nq = (S + BC - 1) / BC;
  const int i_begin = causal ? k_lo / BC : 0;
  const int i_end = window > 0 ? min(nq, (k_lo + BR + window - 2) / BC + 1) : nq;
  const long long go_ss = (long long)H * HD;  // dO's row stride

  load_rows<HD, BR>(Ks, k + b * k_sb + (long long)kvh * HD, k_ss, k_lo, S, tid);
  load_rows<HD, BR>(Vs, v + b * v_sb + (long long)kvh * HD, v_ss, k_lo, S, tid);
  cp_async_commit();

  const int kr = warp * 16;  // this warp's keys: k_lo + kr + g and + 8
  float dka[NDT][4], dva[NDT][4];
#pragma unroll
  for (int dt = 0; dt < NDT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[dt][e] = dva[dt][e] = 0.0f;

  for (int gi = 0; gi < G; ++gi) {
    const int h = kvh * G + gi;
    const float* qbase = q + b * q_sb + (long long)h * HD;
    const float* gbase = dout + (long long)b * S * go_ss + (long long)h * HD;
    const float* lrow = lse + ((long long)b * H + h) * S;
    const float* drow = dsum + ((long long)b * H + h) * S;
    for (int i = i_begin; i < i_end; ++i) {
      const int q_lo = i * BC;
      __syncthreads();  // every warp is done with the last query tile
      load_rows<HD, BC>(Qs, qbase, q_ss, q_lo, S, tid);
      load_rows<HD, BC>(Gs, gbase, go_ss, q_lo, S, tid);
      cp_async_commit();
      if (tid < BC) {
        const int qp = q_lo + tid;
        Ls[tid] = qp < S ? lrow[qp] : 0.0f;
        Ds[tid] = qp < S ? drow[qp] : 0.0f;
      }
      cp_async_wait<0>();
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T: rows keys, columns queries
      float sp[NCT][4], dp[NCT][4];
      dot_rows<HD>(sp, Ks + (kr + g) * LD + 2 * t, Qs + g * LD + 2 * t);
      dot_rows<HD>(dp, Vs + (kr + g) * LD + 2 * t, Gs + g * LD + 2 * t);
#pragma unroll
      for (int nt = 0; nt < NCT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = nt * 8 + 2 * t + (e & 1);
          pair_grads(sp[nt][e], dp[nt][e], q_lo + col, k_lo + kr + g + 8 * (e >> 1), S, causal,
                     window, softcap, scale, Ls[col], Ds[col]);
        }
      uint32_t fh[NCT][4], fl[NCT][4];
      to_frag(sp, fh, fl);  // P^T
      acc_pb<NDT, LD>(dva, fh, fl, Gs + 2 * t * LD + c0 + g);
      to_frag(dp, fh, fl);  // dS^T
      acc_pb<NDT, LD>(dka, fh, fl, Qs + 2 * t * LD + c0 + g);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kp = k_lo + kr + g + 8 * i;
    if (kp >= S) continue;
    const long long off = (((long long)b * S + kp) * KH + kvh) * HD + c0 + 2 * t;
#pragma unroll
    for (int dt = 0; dt < NDT; ++dt) {
      *reinterpret_cast<float2*>(dk + off + dt * 8) =
          make_float2(dka[dt][2 * i] * scale, dka[dt][2 * i + 1] * scale);
      *reinterpret_cast<float2*>(dv + off + dt * 8) =
          make_float2(dva[dt][2 * i], dva[dt][2 * i + 1]);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ dsum,
                    float* __restrict__ dq, int S, int H, int KH, long long q_sb,
                    long long q_ss, long long k_sb, long long k_ss, long long v_sb,
                    long long v_ss, int causal, int window, float softcap, float scale) {
  using D = Dims<HD>;
  constexpr int LD = D::LD, DC = D::DC, NDT = D::NDT;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;           // [BR][LD] this block's queries
  float* Gs = Qs + BR * LD;   // [BR][LD] their dO
  float* Ks = Gs + BR * LD;   // [BC][LD] one key tile
  float* Vs = Ks + BC * LD;   // [BC][LD]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int z = blockIdx.x % D::NZ, bh = blockIdx.x / D::NZ;
  const int h = bh % H, b = bh / H, kvh = h / (H / KH);
  const int q_lo = (gridDim.y - 1 - blockIdx.y) * BR;  // heaviest causal tiles first
  const int c0 = z * DC;
  const int nk = (S + BC - 1) / BC;
  const int j_end = causal ? min(nk, (q_lo + BR - 1) / BC + 1) : nk;
  const int j_begin = (window > 0 && q_lo - window + 1 > 0) ? (q_lo - window + 1) / BC : 0;
  const long long go_ss = (long long)H * HD;
  const float* kbase = k + b * k_sb + (long long)kvh * HD;
  const float* vbase = v + b * v_sb + (long long)kvh * HD;

  load_rows<HD, BR>(Qs, q + b * q_sb + (long long)h * HD, q_ss, q_lo, S, tid);
  load_rows<HD, BR>(Gs, dout + (long long)b * S * go_ss + (long long)h * HD, go_ss, q_lo, S,
                    tid);
  cp_async_commit();

  const int qr = warp * 16;  // this warp's queries: q_lo + qr + g and + 8
  float lr[2], dr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qp = q_lo + qr + g + 8 * i;
    const long long at = ((long long)b * H + h) * S + qp;
    lr[i] = qp < S ? lse[at] : 0.0f;
    dr[i] = qp < S ? dsum[at] : 0.0f;
  }
  float dqa[NDT][4];
#pragma unroll
  for (int dt = 0; dt < NDT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[dt][e] = 0.0f;

  for (int j = j_begin; j < j_end; ++j) {
    const int k_lo = j * BC;
    __syncthreads();  // every warp is done with the last key tile
    load_rows<HD, BC>(Ks, kbase, k_ss, k_lo, S, tid);
    load_rows<HD, BC>(Vs, vbase, v_ss, k_lo, S, tid);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    // S = Q K^T and dP = dO V^T: rows queries, columns keys
    float sp[NCT][4], dp[NCT][4];
    dot_rows<HD>(sp, Qs + (qr + g) * LD + 2 * t, Ks + g * LD + 2 * t);
    dot_rows<HD>(dp, Gs + (qr + g) * LD + 2 * t, Vs + g * LD + 2 * t);
#pragma unroll
    for (int nt = 0; nt < NCT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        pair_grads(sp[nt][e], dp[nt][e], q_lo + qr + g + 8 * (e >> 1),
                   k_lo + nt * 8 + 2 * t + (e & 1), S, causal, window, softcap, scale,
                   lr[e >> 1], dr[e >> 1]);
    uint32_t fh[NCT][4], fl[NCT][4];
    to_frag(dp, fh, fl);  // dS
    acc_pb<NDT, LD>(dqa, fh, fl, Ks + 2 * t * LD + c0 + g);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qp = q_lo + qr + g + 8 * i;
    if (qp >= S) continue;
    float* row = dq + (((long long)b * S + qp) * H + h) * HD + c0 + 2 * t;
#pragma unroll
    for (int dt = 0; dt < NDT; ++dt)
      *reinterpret_cast<float2*>(row + dt * 8) =
          make_float2(dqa[dt][2 * i] * scale, dqa[dt][2 * i + 1] * scale);
  }
}

template <int HD>
int launch(const float* q, const float* k, const float* v, const float* o, const float* dout,
           const float* lse, float* dsum, float* dq, float* dk, float* dv, int B, int S, int H,
           int KH, long long q_sb, long long q_ss, long long k_sb, long long k_ss,
           long long v_sb, long long v_ss, int causal, int window, float softcap, float scale,
           cudaStream_t st) {
  const size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long rows = (long long)B * S * H;
  flash_bwd_dsum_kernel<<<(unsigned)((rows + 7) / 8), 256, 0, st>>>(o, dout, dsum, rows, S, H,
                                                                     HD);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const unsigned ny = (unsigned)((S + BR - 1) / BR);
  flash_bwd_dkdv_kernel<HD><<<dim3((unsigned)(B * KH * Dims<HD>::NZ), ny), NT, smem, st>>>(
      q, k, v, dout, lse, dsum, dk, dv, S, H, KH, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, causal,
      window, softcap, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_kernel<HD><<<dim3((unsigned)(B * H * Dims<HD>::NZ), ny), NT, smem, st>>>(
      q, k, v, dout, lse, dsum, dq, S, H, KH, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, causal, window,
      softcap, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dsum is a (B, H, S) f32 scratch; o, dout, dq (B, S, H, hd), dk, dv (B, S,
// KH, hd) and lse (B, H, S) are contiguous f32.
extern "C" int seifer_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const void* lse, void* dsum, void* dq, void* dk, void* dv, int B, int S, int H, int KH,
    int hd, long long q_sb, long long q_ss, long long k_sb, long long k_ss, long long v_sb,
    long long v_ss, int causal, int window, float softcap, float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const float *qf = (const float*)q, *kf = (const float*)k, *vf = (const float*)v;
  const float *of = (const float*)o, *gf = (const float*)dout, *lf = (const float*)lse;
  float *sf = (float*)dsum, *dqf = (float*)dq, *dkf = (float*)dk, *dvf = (float*)dv;
  switch (hd) {
#define SEIFER_FLASH_BWD_CASE(D)                                                            \
  case D:                                                                                   \
    return launch<D>(qf, kf, vf, of, gf, lf, sf, dqf, dkf, dvf, B, S, H, KH, q_sb, q_ss,   \
                     k_sb, k_ss, v_sb, v_ss, causal, window, softcap, scale, st);
    SEIFER_FLASH_BWD_CASE(64)
    SEIFER_FLASH_BWD_CASE(80)
    SEIFER_FLASH_BWD_CASE(112)
    SEIFER_FLASH_BWD_CASE(128)
    SEIFER_FLASH_BWD_CASE(160)
    SEIFER_FLASH_BWD_CASE(256)
#undef SEIFER_FLASH_BWD_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

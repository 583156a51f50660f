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
// What bounds it on an H100: 10 hd operations per live (query, key) pair
// (S, dP, dV, dK, dQ) against reading q, k, v, o, dO and writing dq, dk, dv
// once -- bound by operations by two orders of magnitude, at three TF32
// tensor-core passes per product under split precision.  This design does
// 14 hd: S and dP twice, once in each of its two kernels, so that dq needs
// no adds across blocks.  A one-pass design (dq summed by the kv-tile blocks
// in a fixed order through per-slice counters in global memory) was built and
// measured on the card: each step's ordered read-add-write of a dq tile in
// L2 cost more than recomputing S and dP (PERF.md, section 6).
//   (a) flash_bwd_dsum_kernel: D = rowsum(o dO), one warp a (b, s, h) row,
//       into a (B, H, S) scratch beside lse;
//   (b) flash_bwd_dkdv_kernel: a block owns BR keys of one kv head and walks
//       the 32-query tiles the causal and window masks leave alive, from the
//       last down, and within each the G query heads; it takes S^T and dP^T
//       and adds P^T dO and dS^T Q into dV and dK, kept in mma fragments in
//       registers;
//   (c) flash_bwd_dq_kernel: a block owns BR queries of one head and walks
//       the live 32-key tiles, taking S and dP and adding dS K into dQ.
// What the design does about its bound:
//   - hd 160 and 256 without recomputing S and dP: there two warps share 16
//     rows, each owning half of the hd columns of the accumulators (the
//     registers a warp has would not hold all of them); each takes S and dP
//     over its half of hd and the pair adds the halves through shared
//     memory.
//   - Copies overlap products: the streamed tiles (q, dO, lse and D in (b);
//     k and v in (c)) go through a two-stage cp.async ring, tile n + 1 in
//     flight while tile n is used; rows past S are zero-filled and masked.
//   - Splits: at hd 64 the kernels are bound by the instructions that split
//     operands, not by the tensor cores.  An A fragment is split once per
//     warp and reused across the fragment's n tiles.  S's operands are split
//     rounded on the f32 pipe (split_fp: four f32 instructions, not four
//     integer and one f32); the other four products' are truncated
//     (split_trunc: two instructions), whose larger error S alone would pass
//     through exp.  Staging tiles split in shared memory would double the
//     ring and the resident tiles, which at 128 rows and hd 128 already fill
//     the 227 KB.
//   - Occupancy: tiles by head dim (Cfg) so that hd 64 runs three blocks of
//     4 warps an SM, hd 80 two, hd 112-256 one block of 8 or 4 warps.
// Each product sums at most 12 mma steps in a fresh fragment before it is
// added in f32 (a 32-wide slice of hd for S and dP, one 32-row tile for the
// accumulations) and starts with __syncwarp().  No atomics: two runs give
// equal gradients.  q, k, v may be strided views of a fused projection (rows
// at the batch and sequence strides given, each row's (heads, hd) block
// packed and 16-byte aligned); o, dO, dq, dk, dv are contiguous.

#include <cuda_runtime.h>

#include "split_tf32.cuh"

namespace {

using split_tf32::cp_async16;
using split_tf32::cp_async4;
using split_tf32::cp_async_commit;
using split_tf32::cp_async_wait;
using split_tf32::mma;

// S's operands split rounded (split_fp), every other product's truncated
// (split_trunc, two instructions): S's error passes through exp, the
// others' do not (kernels/split_precision.flash_backward_emulated)
template <bool ROUND>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  if constexpr (ROUND)
    split_tf32::split_fp(x, hi, lo);
  else
    split_tf32::split_trunc(x, hi, lo);
}

constexpr int BC = 32;       // rows of the tiles a block streams: queries in (b), keys in (c)
constexpr int NCT = BC / 8;  // 8-wide column fragments of an S tile

// Tiles by head dim: KS warps share 16 rows (2 above hd 128, each owning
// half of the accumulators' columns), NKG such groups a block; the block
// owns BR = 16 NKG rows (keys in (b), queries in (c)).  hd 64 runs three
// blocks of 4 warps an SM, hd 80 two, hd 112-160 one of 8 warps, hd 256 one
// of 4 warps over 32 rows, what its tiles leave room for.  Keep BWD_ROWS in
// ../flash_attention/kernel.py equal to BR.
template <int HD>
struct Cfg {
  static constexpr int KS = HD > 128 ? 2 : 1;
  static constexpr int NKG = HD <= 80 ? 4 : HD <= 128 ? 8 : HD == 160 ? 4 : 2;
  static constexpr int NW = NKG * KS, NT = NW * 32;
  static constexpr int BR = 16 * NKG;
  static constexpr int LD = HD + 8;   // row stride of every q, dO, k, v tile
  static constexpr int DW = HD / KS;  // accumulator columns a warp owns
  static constexpr int NDT = DW / 8;
  static constexpr int XCH = KS == 2 ? NW * 2 * NCT * 4 * 32 : 0;  // S, dP halves
  // (b): k, v [BR][LD]; 2 stages of q, dO [BC][LD] and lse, D [BC]
  static constexpr size_t SMEM_DKDV =
      sizeof(float) * (2 * BR * LD + 2 * (2 * BC * LD + 2 * BC) + XCH);
  // (c): q, dO [BR][LD]; 2 stages of k, v [BC][LD]
  static constexpr size_t SMEM_DQ = sizeof(float) * (2 * BR * LD + 2 * 2 * BC * LD + XCH);
  static constexpr int MINB = HD == 64 ? 3 : HD == 80 ? 2 : 1;
};

// rows [lo, lo + ROWS) of one head, at row stride ss, into a tile of stride LD
template <int HD, int ROWS, int NT>
__device__ __forceinline__ void load_rows(float* dst, const float* src, long long ss, int lo,
                                          int S, int tid) {
  constexpr int CH = HD / 4, LD = HD + 8;  // 16-byte chunks a row
#pragma unroll 4
  for (int e = tid; e < ROWS * CH; e += NT) {
    const int r = e / CH, c = (e % CH) * 4, p = lo + r;
    const bool in = p < S;
    cp_async16(dst + r * LD + c, src + (long long)(in ? p : 0) * ss + c, in ? 16 : 0);
  }
}

// acc (16 x BC) += A B^T over columns [kc, kc + W): arow points at this
// lane's A row g (column 2t), brow at B row g (column 2t); rows g + 8 of A
// and rows 8 nt + g of B follow at the tile stride.  3 split-TF32 mma per 8
// columns into a fresh fragment, W / 8 * 3 <= 12 steps, then added in f32.
template <int LD, int W, bool ROUND>
__device__ __forceinline__ void dot_slice(float (&acc)[NCT][4], const float* arow,
                                          const float* brow, int kc) {
  float part[NCT][4] = {};
  __syncwarp();
#pragma unroll
  for (int kk = kc; kk < kc + W; kk += 8) {
    const float2 x0 = *reinterpret_cast<const float2*>(arow + kk);
    const float2 x1 = *reinterpret_cast<const float2*>(arow + 8 * LD + kk);
    uint32_t ah[4], al[4];
    split<ROUND>(x0.x, ah[0], al[0]);
    split<ROUND>(x1.x, ah[1], al[1]);
    split<ROUND>(x0.y, ah[2], al[2]);
    split<ROUND>(x1.y, ah[3], al[3]);
#pragma unroll
    for (int nt = 0; nt < NCT; ++nt) {
      const float2 y = *reinterpret_cast<const float2*>(brow + nt * 8 * LD + kk);
      uint32_t bh0, bl0, bh1, bl1;
      split<ROUND>(y.x, bh0, bl0);
      split<ROUND>(y.y, bh1, bl1);
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

// acc = A B^T over W columns (a width that is not a multiple of 32 ends in
// one 16-wide slice)
template <int LD, int W, bool ROUND>
__device__ __forceinline__ void dot_rows(float (&acc)[NCT][4], const float* arow,
                                         const float* brow) {
#pragma unroll
  for (int nt = 0; nt < NCT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;
#pragma unroll 1
  for (int kc = 0; kc < W - W % 32; kc += 32) dot_slice<LD, 32, ROUND>(acc, arow, brow, kc);
  if constexpr (W % 32 != 0) dot_slice<LD, W % 32, ROUND>(acc, arow, brow, W - W % 32);
}

// a C fragment (16 x BC) split into hi + lo A fragments: column t is the
// tile's column 2t, column t + 4 its 2t + 1, so a = (c0, c2, c1, c3) with
// no shuffles
__device__ __forceinline__ void to_frag(const float (&c)[NCT][4], uint32_t (&h)[NCT][4],
                                        uint32_t (&l)[NCT][4]) {
#pragma unroll
  for (int kt = 0; kt < NCT; ++kt) {
    split<false>(c[kt][0], h[kt][0], l[kt][0]);
    split<false>(c[kt][2], h[kt][1], l[kt][1]);
    split<false>(c[kt][1], h[kt][2], l[kt][2]);
    split<false>(c[kt][3], h[kt][3], l[kt][3]);
  }
}

// out (16 x 8 NDT) += P (16 x BC) B (BC x 8 NDT): bcol points at B row 2t,
// this warp's first output column + g.  Each 8-column fragment sums one
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
      split<false>(bcol[kt * 8 * LD + dt * 8], bh0, bl0);
      split<false>(bcol[(kt * 8 + 1) * LD + dt * 8], bh1, bl1);
      mma(part, pl[kt], bh0, bh1);
      mma(part, ph[kt], bl0, bl1);
      mma(part, ph[kt], bh0, bh1);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) out[dt][e] += part[e];
  }
}

// with two warps on 16 rows (KS = 2), each holds S and dP over its half of
// hd: the pair adds the halves through shared memory (both then hold the
// same sums, a + b and b + a being equal in f32).  Every thread calls it.
template <int KS>
__device__ __forceinline__ void add_halves(float (&sp)[NCT][4], float (&dp)[NCT][4], float* Xs,
                                           int warp, int lane) {
  if constexpr (KS == 2) {
    float* mine = Xs + warp * (2 * NCT * 4 * 32) + lane;
    const float* other = Xs + (warp ^ 1) * (2 * NCT * 4 * 32) + lane;
#pragma unroll
    for (int nt = 0; nt < NCT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        mine[(nt * 4 + e) * 32] = sp[nt][e];
        mine[(NCT * 4 + nt * 4 + e) * 32] = dp[nt][e];
      }
    __syncthreads();
#pragma unroll
    for (int nt = 0; nt < NCT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sp[nt][e] += other[(nt * 4 + e) * 32];
        dp[nt][e] += other[(NCT * 4 + nt * 4 + e) * 32];
      }
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
__global__ void __launch_bounds__(Cfg<HD>::NT, Cfg<HD>::MINB)
flash_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ dsum,
                      float* __restrict__ dk, float* __restrict__ dv, int S, int H, int KH,
                      long long q_sb, long long q_ss, long long k_sb, long long k_ss,
                      long long v_sb, long long v_ss, int causal, int window, float softcap,
                      float scale) {
  using C = Cfg<HD>;
  constexpr int LD = C::LD, BR = C::BR, NT = C::NT, KS = C::KS, DW = C::DW, NDT = C::NDT;
  constexpr int STAGE = 2 * BC * LD + 2 * BC;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                // [BR][LD] this block's keys
  float* Vs = Ks + BR * LD;        // [BR][LD]
  float* ring = Vs + BR * LD;      // 2 stages: q [BC][LD], dO [BC][LD], lse [BC], D [BC]
  float* Xs = ring + 2 * STAGE;    // S^T, dP^T halves (KS = 2)
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kr = (warp / KS) * 16;  // this warp's keys: k_lo + kr + g and + 8
  const int c0 = (warp % KS) * DW;  // and its dK/dV columns [c0, c0 + DW)
  const int kvh = blockIdx.x % KH, b = blockIdx.x / KH, G = H / KH;
  const int k_lo = blockIdx.y * BR;  // the heaviest causal tiles (lowest keys) first
  const int nq = (S + BC - 1) / BC;
  const int i_begin = causal ? k_lo / BC : 0;
  const int i_end = window > 0 ? min(nq, (k_lo + BR + window - 2) / BC + 1) : nq;
  const int n_steps = G * (i_end - i_begin);
  const long long go_ss = (long long)H * HD;  // dO's row stride

  // step n: q tile i_end - 1 - n / G, query head kvh G + n % G
  auto load_step = [&](int n) {
    const int h = kvh * G + n % G, q_lo = (i_end - 1 - n / G) * BC;
    float* st = ring + (n & 1) * STAGE;
    load_rows<HD, BC, NT>(st, q + b * q_sb + (long long)h * HD, q_ss, q_lo, S, tid);
    load_rows<HD, BC, NT>(st + BC * LD, dout + (long long)b * S * go_ss + (long long)h * HD,
                          go_ss, q_lo, S, tid);
    if (tid < 2 * BC) {
      const int qp = q_lo + tid % BC;
      const float* src = (tid < BC ? lse : dsum) + ((long long)b * H + h) * S;
      cp_async4(st + 2 * BC * LD + tid, src + (qp < S ? qp : 0), qp < S ? 4 : 0);
    }
  };

  load_rows<HD, BR, NT>(Ks, k + b * k_sb + (long long)kvh * HD, k_ss, k_lo, S, tid);
  load_rows<HD, BR, NT>(Vs, v + b * v_sb + (long long)kvh * HD, v_ss, k_lo, S, tid);
  load_step(0);
  cp_async_commit();

  float dka[NDT][4], dva[NDT][4];
#pragma unroll
  for (int dt = 0; dt < NDT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[dt][e] = dva[dt][e] = 0.0f;

  for (int n = 0; n < n_steps; ++n) {
    const int q_lo = (i_end - 1 - n / G) * BC;
    const float* Qs = ring + (n & 1) * STAGE;
    const float* Gs = Qs + BC * LD;
    const float* Ls = Gs + BC * LD;
    const float* Ds = Ls + BC;
    cp_async_wait<0>();
    __syncthreads();  // tile n landed; every warp is done with tile n - 1
    if (n + 1 < n_steps) load_step(n + 1);
    cp_async_commit();

    // S^T = K Q^T and dP^T = V dO^T over this warp's hd columns: rows keys,
    // columns queries
    float sp[NCT][4], dp[NCT][4];
    dot_rows<LD, DW, true>(sp, Ks + (kr + g) * LD + c0 + 2 * t, Qs + g * LD + c0 + 2 * t);
    dot_rows<LD, DW, false>(dp, Vs + (kr + g) * LD + c0 + 2 * t, Gs + g * LD + c0 + 2 * t);
    add_halves<KS>(sp, dp, Xs, warp, lane);
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
  cp_async_wait<0>();

#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int kp = k_lo + kr + g + 8 * u;
    if (kp >= S) continue;
    const long long off = (((long long)b * S + kp) * KH + kvh) * HD + c0 + 2 * t;
#pragma unroll
    for (int dt = 0; dt < NDT; ++dt) {
      *reinterpret_cast<float2*>(dk + off + dt * 8) =
          make_float2(dka[dt][2 * u] * scale, dka[dt][2 * u + 1] * scale);
      *reinterpret_cast<float2*>(dv + off + dt * 8) =
          make_float2(dva[dt][2 * u], dva[dt][2 * u + 1]);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(Cfg<HD>::NT, Cfg<HD>::MINB)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ dsum,
                    float* __restrict__ dq, int S, int H, int KH, long long q_sb,
                    long long q_ss, long long k_sb, long long k_ss, long long v_sb,
                    long long v_ss, int causal, int window, float softcap, float scale) {
  using C = Cfg<HD>;
  constexpr int LD = C::LD, BR = C::BR, NT = C::NT, KS = C::KS, DW = C::DW, NDT = C::NDT;
  constexpr int STAGE = 2 * BC * LD;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                // [BR][LD] this block's queries
  float* Gs = Qs + BR * LD;        // [BR][LD] their dO
  float* ring = Gs + BR * LD;      // 2 stages: k [BC][LD], v [BC][LD]
  float* Xs = ring + 2 * STAGE;    // S, dP halves (KS = 2)
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int qr = (warp / KS) * 16;  // this warp's queries: q_lo + qr + g and + 8
  const int c0 = (warp % KS) * DW;  // and its dQ columns [c0, c0 + DW)
  const int h = blockIdx.x % H, b = blockIdx.x / H, kvh = h / (H / KH);
  const int q_lo = (gridDim.y - 1 - blockIdx.y) * BR;  // heaviest causal tiles first
  const int nk = (S + BC - 1) / BC;
  const int j_end = causal ? min(nk, (q_lo + BR - 1) / BC + 1) : nk;
  const int j_begin = (window > 0 && q_lo - window + 1 > 0) ? (q_lo - window + 1) / BC : 0;
  const int n_steps = j_end - j_begin;
  const long long go_ss = (long long)H * HD;
  const float* kbase = k + b * k_sb + (long long)kvh * HD;
  const float* vbase = v + b * v_sb + (long long)kvh * HD;

  // step n: key tile j_begin + n
  auto load_step = [&](int n) {
    float* st = ring + (n & 1) * STAGE;
    load_rows<HD, BC, NT>(st, kbase, k_ss, (j_begin + n) * BC, S, tid);
    load_rows<HD, BC, NT>(st + BC * LD, vbase, v_ss, (j_begin + n) * BC, S, tid);
  };

  load_rows<HD, BR, NT>(Qs, q + b * q_sb + (long long)h * HD, q_ss, q_lo, S, tid);
  load_rows<HD, BR, NT>(Gs, dout + (long long)b * S * go_ss + (long long)h * HD, go_ss, q_lo, S,
                        tid);
  load_step(0);
  cp_async_commit();

  float lr[2], dr[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int qp = q_lo + qr + g + 8 * u;
    const long long at = ((long long)b * H + h) * S + qp;
    lr[u] = qp < S ? lse[at] : 0.0f;
    dr[u] = qp < S ? dsum[at] : 0.0f;
  }
  float dqa[NDT][4];
#pragma unroll
  for (int dt = 0; dt < NDT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[dt][e] = 0.0f;

  for (int n = 0; n < n_steps; ++n) {
    const int k_lo = (j_begin + n) * BC;
    const float* Ks = ring + (n & 1) * STAGE;
    const float* Vs = Ks + BC * LD;
    cp_async_wait<0>();
    __syncthreads();  // tile n landed; every warp is done with tile n - 1
    if (n + 1 < n_steps) load_step(n + 1);
    cp_async_commit();

    // S = Q K^T and dP = dO V^T over this warp's hd columns: rows queries,
    // columns keys
    float sp[NCT][4], dp[NCT][4];
    dot_rows<LD, DW, true>(sp, Qs + (qr + g) * LD + c0 + 2 * t, Ks + g * LD + c0 + 2 * t);
    dot_rows<LD, DW, false>(dp, Gs + (qr + g) * LD + c0 + 2 * t, Vs + g * LD + c0 + 2 * t);
    add_halves<KS>(sp, dp, Xs, warp, lane);
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
  for (int u = 0; u < 2; ++u) {
    const int qp = q_lo + qr + g + 8 * u;
    if (qp >= S) continue;
    float* row = dq + ((long long)b * S + qp) * go_ss + (long long)h * HD + c0 + 2 * t;
#pragma unroll
    for (int dt = 0; dt < NDT; ++dt)
      *reinterpret_cast<float2*>(row + dt * 8) =
          make_float2(dqa[dt][2 * u] * scale, dqa[dt][2 * u + 1] * scale);
  }
}

template <int HD>
int launch(const float* q, const float* k, const float* v, const float* o, const float* dout,
           const float* lse, float* dsum, float* dq, float* dk, float* dv, int B, int S, int H,
           int KH, long long q_sb, long long q_ss, long long k_sb, long long k_ss,
           long long v_sb, long long v_ss, int causal, int window, float softcap, float scale,
           cudaStream_t st) {
  using C = Cfg<HD>;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)C::SMEM_DKDV);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)C::SMEM_DQ);
  if (err != cudaSuccess) return (int)err;
  const long long rows = (long long)B * S * H;
  flash_bwd_dsum_kernel<<<(unsigned)((rows + 7) / 8), 256, 0, st>>>(o, dout, dsum, rows, S, H,
                                                                     HD);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const unsigned ny = (unsigned)((S + C::BR - 1) / C::BR);
  flash_bwd_dkdv_kernel<HD><<<dim3((unsigned)(B * KH), ny), C::NT, C::SMEM_DKDV, st>>>(
      q, k, v, dout, lse, dsum, dk, dv, S, H, KH, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, causal,
      window, softcap, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_kernel<HD><<<dim3((unsigned)(B * H), ny), C::NT, C::SMEM_DQ, st>>>(
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

// Backward of the chunked Mamba2 SSD scan for Hopper (sm_90a): dxs, dbm,
// dcm, ddt and da in f32 from the scan's inputs and dy.
//
// Replaces what the JAX package differentiates with jax.grad: the jnp chunk
// scan of mamba_forward (src/repro/models/ssm.py:105-130, ssd_ref in
// src/repro/kernels/ssm_scan/ref.py:19).  The Pallas ssd_chunked_tpu has no
// VJP.  The math is ref.ssd_backward_ref's, per chunk of Q rows and per
// (batch row, head), with L_ts = exp(cum_t - cum_s) for s <= t (masked
// before exp), G = C B^T, P = dy x^T, e_t = exp(cum_t), o_s = exp(cum_L -
// cum_s), h the state entering the chunk and dH the gradient of the state
// leaving it:
//   dx   = (G o L dt)^T dy + (o dt) (B dH^T)
//   dC   = (P o L dt) B + e (dy h)           summed over heads
//   dB   = (P o L dt)^T C + (o dt) (x dH)    summed over heads
//   ddt  = colsum(P o G o L) + r + dda a,  r_s = o_s x_s . (dH B_s)
//   da   = sum M_ts (T_t - T_s) + ... (pairwise, see ssd_backward_ref)
// and the two recurrences h <- exp(cum_L) h + x^T (B o o dt) (forward) and
// dH <- exp(cum_L) dH + dy^T (C o e) (reverse).
//
// What bounds it on an H100: operations, narrowly.  Reading xs, dy, bm,
// cm, dt once and writing the five gradients once is 1.03 GB at zamba2's
// microbatch (B=4, S=4096, H=80, dh=N=64): 0.31 ms at 3.35 TB/s.  The
// products take r (r + 1) (2 dh + 2 N) + 10 r dh N + 2 dh N FLOPs per head
// and chunk of r rows, and r (r + 1) N for C B^T, which the heads share:
// 58.05 GFLOP at the cheapest chunking (r = 8), 0.3518 ms at three
// split-TF32 passes (chip_smoke.py's ssd_bwd_flops).  This design does them
// at r = 64 (75.73 GFLOP) and passes h and dH through device memory: 3.23 GB
// moved at zamba2's microbatch, 0.96 ms at 3.35 TB/s.  On the card the
// chunk kernel takes two thirds of the time, held by the instructions
// around its mma (fragment loads and splits; PERF.md), the state passes
// the rest, held by bytes.
//
// The design, no atomics (two runs are equal, as a bit-exact resume needs):
// 1. State walks.  ssd_bwd_states_kernel walks each (batch row, head)
//    sequence once in each direction, both directions in one launch (grid
//    (2, H, B)), writing every chunk-entry h and chunk-exit dH (transposed,
//    N x dh padded to 64 x 64) to scratch.  A chunk's x or dy tile and B or
//    C tile stream through a two-stage cp.async ring; warp 0 builds the next
//    chunk's cum in the plain version's fixed order while the others
//    compute; the 64 x 64 x 64 state product runs on split-TF32 mma.sync.
//    The walks are not cut into segments as ssd_scan.cu's are: at zamba2's
//    microbatch its 640 blocks already fill the card, and the segments'
//    extra pass over xs and dy made the backward 11% slower (PERF.md).
// 2. Head groups.  ssd_bwd_chunk_kernel (16 warps, one block an SM) takes
//    one (chunk, group of G heads, batch row): B and C are staged once for
//    the group and G = C B^T is computed once, into registers, for all its
//    heads; each head's x, dy, h and dH tiles stream through a two-stage
//    cp.async ring (head k + 1 lands while head k computes).  dB and dC are
//    summed over the group's heads in registers, in head order, and one
//    partial per group goes to (B, S, ceil(H / G), N) scratch, which
//    ssd_bwd_reduce_kernel sums over the groups in order.  A short last
//    group is masked.  Warp 0 takes a head's row vectors while the other
//    warps start the next head.  ref.ssd_backward_ref_grouped is the same
//    decomposition.
// 3. Tensor cores.  Every product -- C B^T, dy x^T, the scores' products
//    with dy, B and C, dy h, B dH^T, x dH and the states' -- runs on
//    mma.sync m16n8k8 TF32, each f32 operand split into hi + lo by
//    split_trunc (the CPU model split_precision.ssd_backward_emulated lands
//    within a third of the 5e-6 pin with it everywhere) in three passes, at
//    most 12 mma a fresh fragment before an f32 add.  The masks before exp,
//    the decays, ddt's row and column sums, the reverse cumsum of dcum and
//    the pairwise da stay on the FMA units in f32, each in one fixed order.
// Tiles are Q = 64 rows (KERNEL_CHUNK) whatever chunk the caller asks for,
// zero-filled past a ragged last chunk and past dh or N, so padded rows add
// nothing and are never written.  All tiles have a row stride of 68 floats
// and every product relabels k within each group of 8 (A's column t is k =
// 2t, t + 4 is 2t + 1; B's rows alike), so a fragment read of a tile or of
// its transpose hits 32 banks.

#include <cuda_runtime.h>

#include "split_tf32.cuh"

using split_tf32::cp_async16;
using split_tf32::cp_async4;
using split_tf32::cp_async_commit;
using split_tf32::cp_async_wait;

namespace {

constexpr int Q = 64;     // KERNEL_CHUNK: rows per chunk
constexpr int T = 64;     // dh and N are zero-padded to 64 in shared memory and scratch
constexpr int LD = 68;    // row stride of every shared tile, in floats
constexpr int NT = 256;   // threads of the state kernels: 8 warps
constexpr int SCAN_BLOCK = 16;  // cum's summation blocks (ref.SCAN_BLOCK)
constexpr int TILE = Q * LD;
constexpr int KG = 4;         // k steps a fresh mma fragment takes: 12 mma
constexpr int DT_SLOTS = 3;   // states kernel: dt of chunks k, k + 1 (cum), k + 2 (landing)
constexpr int MAX_GROUP = 8;  // most heads a chunk block takes (their vectors fill its smem)

// acc[nt] (16 x 8 each, mma C layout) += A (16 x 8 per k step) . B (8 x 8
// per k step and tile) over k steps [ks_begin, ks_end), for the tiles nt <
// ntiles, on the tensor cores in split-TF32: each operand as hi + lo
// (split_trunc), three passes small terms first.  A fresh fragment takes KG
// k steps (12 mma) and is then added in f32.  fa(ks, g, t, v) gives the A
// fragment (a0..a3) of k step ks of lane 4 g + t, fb(ks, nt, g, t, v) its
// B fragment of tile nt (b0, b1).  The bounds and ntiles are warp-uniform.
template <int NTILES, class FA, class FB>
__device__ __forceinline__ void mma_range(float (&acc)[NTILES][4], int ntiles, int ks_begin,
                                          int ks_end, FA fa, FB fb) {
  using split_tf32::mma;
  using split_tf32::split_trunc;
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  __syncwarp();  // mma.sync is .aligned: every lane of the warp, converged
  for (int k0 = ks_begin; k0 < ks_end; k0 += KG) {
    float f[NTILES][4] = {};
#pragma unroll
    for (int kk = 0; kk < KG; ++kk) {
      const int ks = k0 + kk;
      if (ks >= ks_end) continue;
      float av[4];
      fa(ks, g, t, av);
      uint32_t ah[4], al[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) split_trunc(av[i], ah[i], al[i]);
#pragma unroll
      for (int nt = 0; nt < NTILES; ++nt) {
        if (nt >= ntiles) continue;
        float bv[2];
        fb(ks, nt, g, t, bv);
        uint32_t bh0, bl0, bh1, bl1;
        split_trunc(bv[0], bh0, bl0);
        split_trunc(bv[1], bh1, bl1);
        mma(f[nt], al, bh0, bh1);
        mma(f[nt], ah, bl0, bl1);
        mma(f[nt], ah, bh0, bh1);
      }
    }
#pragma unroll
    for (int nt = 0; nt < NTILES; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[nt][i] += f[nt][i];
  }
}

// Fragment reads of a shared tile M (row stride LD), lane = 4 g + t, with k
// relabelled (position t -> 2t, t + 4 -> 2t + 1).
// A (rows r0 + [0, 16), k step ks) of M itself: A[r][k] = M[r][k].
__device__ __forceinline__ void a_rows(const float* M, int r0, int ks, int g, int t, float* v) {
  const float2 lo = *reinterpret_cast<const float2*>(M + (r0 + g) * LD + 8 * ks + 2 * t);
  const float2 hi = *reinterpret_cast<const float2*>(M + (r0 + g + 8) * LD + 8 * ks + 2 * t);
  v[0] = lo.x;
  v[1] = hi.x;
  v[2] = lo.y;
  v[3] = hi.y;
}
// A of M^T: A[r][k] = M[k][r].
__device__ __forceinline__ void a_cols(const float* M, int r0, int ks, int g, int t, float* v) {
  const float* p = M + (8 * ks + 2 * t) * LD + r0 + g;
  v[0] = p[0];
  v[1] = p[8];
  v[2] = p[LD];
  v[3] = p[LD + 8];
}
// B (k step ks, columns c0 + [0, 8)) with B[k][c] = M[c][k].
__device__ __forceinline__ void b_rows(const float* M, int c0, int ks, int g, int t, float* v) {
  const float2 p = *reinterpret_cast<const float2*>(M + (c0 + g) * LD + 8 * ks + 2 * t);
  v[0] = p.x;
  v[1] = p.y;
}
// B with B[k][c] = M[k][c].
__device__ __forceinline__ void b_cols(const float* M, int c0, int ks, int g, int t, float* v) {
  const float* p = M + (8 * ks + 2 * t) * LD + c0 + g;
  v[0] = p[0];
  v[1] = p[LD];
}

// mma_range's operands: A over rows r0 + [0, 16) of M (ROWS) or of M^T; B
// over the columns c0 + step nt of M^T (ROWS: B[k][c] = M[c][k]) or of M.
template <bool ROWS>
__device__ __forceinline__ auto a_of(const float* M, int r0) {
  return [=](int ks, int g, int t, float* v) {
    if constexpr (ROWS) a_rows(M, r0, ks, g, t, v);
    else a_cols(M, r0, ks, g, t, v);
  };
}
template <bool ROWS>
__device__ __forceinline__ auto b_of(const float* M, int c0, int step = 8) {
  return [=](int ks, int nt, int g, int t, float* v) {
    if constexpr (ROWS) b_rows(M, c0 + step * nt, ks, g, t, v);
    else b_cols(M, c0 + step * nt, ks, g, t, v);
  };
}

// Rows [0, Q) of a slab (row r at src + r * stride, `width` floats) into a
// shared tile, asynchronously; rows >= qv and columns >= width are
// zero-filled, never read.  V4: width, stride and src are 16-byte multiples.
template <bool V4, int NTHREADS>
__device__ __forceinline__ void stage_tile(float* dst, const float* src, long long stride, int qv,
                                           int width, int tid) {
  if (V4) {
    for (int i = tid; i < Q * (T / 4); i += NTHREADS) {
      const int r = i / (T / 4), c = (i % (T / 4)) * 4;
      const bool ok = r < qv && c < width;
      cp_async16(dst + r * LD + c, ok ? src + r * stride + c : src, ok ? 16 : 0);
    }
  } else {
    for (int i = tid; i < Q * T; i += NTHREADS) {
      const int r = i / T, c = i % T;
      const bool ok = r < qv && c < width;
      cp_async4(dst + r * LD + c, ok ? src + r * stride + c : src, ok ? 4 : 0);
    }
  }
}

// One warp: cum of a chunk in the plain version's order (in order within
// blocks of 16, then the block totals in order; no FMA contraction) into
// scum, from dt (zero past the chunk's rows) times ah.  Lane l sums rows l
// and l + 32 from the start of their blocks; the block totals come by
// shuffles, so no lane reads shared memory another lane writes.  Returns
// this lane's cum of rows l and l + 32 and (every lane) cum of row 63.
__device__ __forceinline__ float chunk_cum(const float* sdt, float* scum, float ah, int lane,
                                           float (&cum)[2]) {
  constexpr unsigned ALL = 0xffffffffu;
  float within[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int t = lane + 32 * k;
    float run = 0.0f;
    for (int i = t & ~(SCAN_BLOCK - 1); i <= t; ++i) run = __fadd_rn(run, __fmul_rn(sdt[i], ah));
    within[k] = run;
  }
  // block j's total is row 16 j + 15: lane 15 or 31, row half j / 2
  const float tot[3] = {__shfl_sync(ALL, within[0], 15), __shfl_sync(ALL, within[0], 31),
                        __shfl_sync(ALL, within[1], 15)};
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int blk = (lane + 32 * k) / SCAN_BLOCK;
    float excl = 0.0f;
#pragma unroll
    for (int j = 0; j < 3; ++j)
      if (j < blk) excl = __fadd_rn(excl, tot[j]);
    cum[k] = __fadd_rn(excl, within[k]);
    if (scum) scum[lane + 32 * k] = cum[k];
  }
  return __shfl_sync(ALL, cum[1], 31);  // rows past the chunk add 0: row 63 is the last row's
}

// grid (2, H, B): block x = 0 walks the sequence forward (the state h
// entering each chunk: st <- st exp(cum_L) + sum_s (B_s w_s) x_s^T, w_s =
// exp(cum_L - cum_s) dt_s), block x = 1 in reverse (dH leaving each chunk:
// st <- st exp(cum_L) + sum_t (C_t e_t) dy_t^T, e_t = exp(cum_t)).  st is
// kept transposed (N x dh) in this warp's mma fragments; every chunk's value
// before its update goes to states or dstates [b][h][c] (64 x 64).
template <bool V4>
__global__ void __launch_bounds__(NT, 3)
ssd_bwd_states_kernel(const float* __restrict__ xs, const float* __restrict__ bm,
                      const float* __restrict__ cm, const float* __restrict__ dt,
                      const float* __restrict__ a, const float* __restrict__ dy,
                      float* __restrict__ states, float* __restrict__ dstates, int S, int H,
                      int dh, int N) {
  extern __shared__ __align__(16) float smem[];
  float* sv = smem;                 // x[s][d] or dy[t][d], two chunks
  float* sw = sv + 2 * TILE;        // B[s][n] or C[t][n], two chunks
  float* sdt = sw + 2 * TILE;       // dt, DT_SLOTS chunks
  float* swt = sdt + DT_SLOTS * Q;  // the weights w or e, two chunks
  float* sel = swt + 2 * Q;         // exp(cum_L), two chunks

  const bool rev = blockIdx.x == 1;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  // this warp's outputs: rows m0 + [0, 16) (n) by columns n0 + [0, 32) (d)
  const int m0 = 16 * (warp >> 1), n0 = 32 * (warp & 1);
  const float ah = a[h];
  const int nk = (S + Q - 1) / Q;
  const long long seq = (long long)b * H + h;
  const float* vsrc = rev ? dy : xs;
  const float* wsrc = rev ? cm : bm;

  const auto chunk_at = [&](int k) { return rev ? nk - 1 - k : k; };
  const auto rows_of = [&](int k) { return min(Q, S - chunk_at(k) * Q); };
  const auto row0 = [&](int k) { return (long long)b * S + (long long)chunk_at(k) * Q; };
  const auto stage = [&](int k) {
    const long long g0 = row0(k);
    stage_tile<V4, NT>(sv + (k & 1) * TILE, vsrc + (g0 * H + h) * dh, (long long)H * dh,
                       rows_of(k), dh, tid);
    stage_tile<V4, NT>(sw + (k & 1) * TILE, wsrc + g0 * N, N, rows_of(k), N, tid);
  };
  const auto stage_dt = [&](int k) {
    if (tid < Q) {
      const bool ok = tid < rows_of(k);
      cp_async4(sdt + (k % DT_SLOTS) * Q + tid, dt + (row0(k) + (ok ? tid : 0)) * H + h,
                ok ? 4 : 0);
    }
  };
  // warp 0: chunk k's weights and exp(cum_L)
  const auto weights = [&](int k) {
    const float* d = sdt + (k % DT_SLOTS) * Q;
    float cum[2];
    const float last = chunk_cum(d, nullptr, ah, lane, cum);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int t = lane + 32 * i;
      swt[(k & 1) * Q + t] = rev ? expf(cum[i]) : expf(last - cum[i]) * d[t];
    }
    if (lane == 0) sel[k & 1] = expf(last);
  };
  const auto frag_row = [&](int e) { return m0 + g + 8 * (e >> 1); };
  const auto frag_col = [&](int nt, int e) { return n0 + 8 * nt + 2 * t4 + (e & 1); };
  const auto put = [&](float* dst, const float (&v)[4][4]) {  // a 64 x 64 value, row stride T
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; e += 2)
        *reinterpret_cast<float2*>(dst + frag_row(e) * T + frag_col(nt, e)) =
            make_float2(v[nt][e], v[nt][e + 1]);
  };

  stage(0);
  stage_dt(0);
  if (nk > 1) stage_dt(1);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if (warp == 0) weights(0);
  float st[4][4] = {};
  float* out = (rev ? dstates : states) + seq * nk * (T * T);

  for (int k = 0; k < nk; ++k) {
    const bool last = k + 1 == nk;
    if (!last) stage(k + 1);
    if (k + 2 < nk) stage_dt(k + 2);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // chunk k landed (dt of k + 1 too); its weights written
    if (warp == 0 && !last) weights(k + 1);
    put(out + (long long)chunk_at(k) * (T * T), st);
    if (last) break;
    const float* v = sv + (k & 1) * TILE;
    const float* w = sw + (k & 1) * TILE;
    const float* wt = swt + (k & 1) * Q;
    // sa[n][d] = sum_s (w_s W[s][n]) V[s][d]: A = (W o w)^T, B = V
    float sa[4][4] = {};
    mma_range<4>(sa, 4, 0, Q / 8,
                 [&](int ks, int g, int t, float* r) {
                   a_cols(w, m0, ks, g, t, r);
                   const float w0 = wt[8 * ks + 2 * t], w1 = wt[8 * ks + 2 * t + 1];
                   r[0] *= w0;
                   r[1] *= w0;
                   r[2] *= w1;
                   r[3] *= w1;
                 },
                 b_of<false>(v, n0));
    const float el = sel[k & 1];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[nt][e] = st[nt][e] * el + sa[nt][e];
    __syncthreads();  // the ring slot of chunk k is free
  }
}

// One chunk of one group of G heads of one batch row, 16 warps: warp w owns
// rows 16 (w / 4) + [0, 16) and columns 16 (w % 4) + [0, 16) of every 64 x 64
// output, and of the lower triangle of G and P the column tiles w % 4 and
// w % 4 + 4 of 8 that its rows reach.  Shared: B, C (the group's), the
// scores of the head in hand (G L dt and P L dt), a ring of two heads' x,
// dy, h^T and dH^T tiles; then every head's dt, cum, T, e and o, and the
// warps' row and column partials.
constexpr int NTC = 512;  // threads of the chunk kernel
constexpr int WC = NTC / 32;
constexpr int VEC = Q * MAX_GROUP;
constexpr int PART1 = 12 * Q + WC;  // phase 1's partials of one head: row, column, da sums
constexpr size_t CHUNK_SMEM =
    (size_t)(12 * TILE + 5 * VEC + 2 * PART1 + 8 * Q + WC + Q) * sizeof(float);

template <bool V4>
__global__ void __launch_bounds__(NTC, 1)
ssd_bwd_chunk_kernel(const float* __restrict__ xs, const float* __restrict__ bm,
                     const float* __restrict__ cm, const float* __restrict__ dt,
                     const float* __restrict__ a, const float* __restrict__ dy,
                     const float* __restrict__ states, const float* __restrict__ dstates,
                     float* __restrict__ dxs, float* __restrict__ ddt,
                     float* __restrict__ dbp, float* __restrict__ dcp, float* __restrict__ dap,
                     int S, int H, int dh, int N, int G) {
  extern __shared__ __align__(16) float smem[];
  float* sb = smem;            // B[s][n]
  float* sc = sb + TILE;       // C[t][n]
  float* ssg = sc + TILE;      // G[t][s] L dt_s
  float* ssp = ssg + TILE;     // P[t][s] L dt_s
  float* ring = ssp + TILE;    // per slot: x[s][d], dy[t][d], h^T[n][d], dH^T[n][d]
  float* sdt = ring + 8 * TILE;  // [head][row]
  float* scum = sdt + VEC;
  float* stt = scum + VEC;     // T, the in-chunk cumsum of dt
  float* se = stt + VEC;       // exp(cum_t)
  float* so = se + VEC;        // exp(cum_L - cum_s)
  // phase 1's partials, two heads (by head parity): [4][Q] row sums of M
  // over each column quarter, [4][Q] column sums of M and [4][Q] of Z = P G L
  // over each row block, [WC] per-warp sums of M_ts (T_t - T_s)
  float* spart = so + VEC;
  float* sevp = spart + 2 * PART1;  // [4][Q] dy_t.(h C_t) over each column quarter
  float* srp = sevp + 4 * Q;        // [4][Q] x_s.u_s over each column quarter
  float* shdh = srp + 4 * Q;        // [WC] per-warp <dH, h>
  float* sdcum = shdh + WC;         // dcum, then dda

  const int c = blockIdx.x, grp = blockIdx.y, b = blockIdx.z;
  const int h0 = grp * G, gn = min(G, H - h0), n_groups = gridDim.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wi = warp >> 2, jq = warp & 3;
  const int m0 = 16 * wi, n0 = 16 * jq;  // this warp's rows and (full outputs) columns
  // triangle column tiles jq + 4 m, m < n_tri, that rows m0.. reach (< 2 wi + 2)
  const int n_tri = (jq <= 2 * wi + 1) + (jq + 4 <= 2 * wi + 1);
  const int nc = (S + Q - 1) / Q;
  const int qv = min(Q, S - c * Q);
  const long long row0 = (long long)b * S + (long long)c * Q;

  const auto stage_head = [&](int k) {  // head h0 + k into ring slot k & 1
    float* slot = ring + (k & 1) * 4 * TILE;
    const int hh = h0 + k;
    const long long cs = (((long long)b * H + hh) * nc + c) * (T * T);
    stage_tile<V4, NTC>(slot, xs + (row0 * H + hh) * dh, (long long)H * dh, qv, dh, tid);
    stage_tile<V4, NTC>(slot + TILE, dy + (row0 * H + hh) * dh, (long long)H * dh, qv, dh, tid);
    stage_tile<true, NTC>(slot + 2 * TILE, states + cs, T, Q, T, tid);
    stage_tile<true, NTC>(slot + 3 * TILE, dstates + cs, T, Q, T, tid);
  };
  stage_tile<V4, NTC>(sb, bm + row0 * N, N, qv, N, tid);
  stage_tile<V4, NTC>(sc, cm + row0 * N, N, qv, N, tid);
  for (int i = tid; i < Q * gn; i += NTC) {
    const int k = i / Q, t = i % Q;
    const bool ok = t < qv;
    cp_async4(sdt + k * Q + t, dt + (row0 + (ok ? t : 0)) * H + h0 + k, ok ? 4 : 0);
  }
  stage_head(0);
  cp_async_commit();
  if (gn > 1) stage_head(1);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  // warp k: head k's cum, T, e and o
  if (warp < gn) {
    const float* d = sdt + warp * Q;
    float cum[2], tt[2];
    const float last = chunk_cum(d, scum + warp * Q, a[h0 + warp], lane, cum);
    chunk_cum(d, stt + warp * Q, 1.0f, lane, tt);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int t = lane + 32 * i;
      se[warp * Q + t] = expf(cum[i]);
      so[warp * Q + t] = expf(last - cum[i]);
    }
  }
  // G[t][s] = C_t . B_s over this warp's triangle tiles, shared by every
  // head of the group
  float gf[2][4] = {};
  mma_range<2>(gf, n_tri, 0, T / 8, a_of<true>(sc, m0), b_of<true>(sb, 8 * jq, 32));
  float dbacc[2][4] = {}, dcacc[2][4] = {};  // dB[s][n], dC[t][n] over the group's heads
  const auto frag_row = [&](int e) { return m0 + g + 8 * (e >> 1); };
  const auto frag_col = [&](int nt, int e) { return n0 + 8 * nt + 2 * t4 + (e & 1); };

  // 5. Warp 0, for head k, once its partials are in: the row vectors, each
  //    in one fixed order: dcum, dda (its sum from the end), ddt and this
  //    chunk's share of da.  Head k's runs while the other warps compute
  //    head k + 1's first phase, whose partials take the other buffer.
  const auto row_vectors = [&](int k) {
    const float* dtk = sdt + k * Q;
    const float* cum = scum + k * Q;
    const float* tt = stt + k * Q;
    const float* ek = se + k * Q;
    const float* odec = so + k * Q;
    const float* srowp = spart + (k & 1) * PART1;
    const float* scolm = srowp + 4 * Q;
    const float* scolz = scolm + 4 * Q;
    const float* sdap = scolz + 4 * Q;
    const int hh = h0 + k;
    const float ah = a[hh];
    float hdh_all = 0.0f, da_pairs = 0.0f;
    for (int w = 0; w < WC; ++w) {
      hdh_all += shdh[w];
      da_pairs += sdap[w];
    }
    float colz[2], r[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int t = lane + 32 * i;
      float cm_ = 0.0f, cz = 0.0f;
      for (int rb = t / 16; rb < 4; ++rb) {  // row blocks that reach column t
        cm_ += scolm[rb * Q + t];
        cz += scolz[rb * Q + t];
      }
      float rowm = 0.0f, ev = 0.0f, xu = 0.0f;
      for (int q = 0; q < 4; ++q) {
        rowm += srowp[q * Q + t];
        ev += sevp[q * Q + t];
        xu += srp[q * Q + t];
      }
      ev *= ek[t];
      colz[i] = cz;
      r[i] = xu * odec[t];
      sdcum[t] = rowm - cm_ + ev - r[i] * dtk[t];
      // the first partials' rows now take ev_t T_t + r_t dt_t (T_L - T_t) and r_t dt_t
      sevp[t] = ev * tt[t] + r[i] * dtk[t] * (tt[Q - 1] - tt[t]);
      srp[t] = r[i] * dtk[t];
    }
    __syncwarp();
    if (lane == 0) {
      float rdt = 0.0f, part = 0.0f;
      for (int s = 0; s < Q; ++s) {
        rdt += srp[s];
        part += sevp[s];
      }
      const float hl = expf(cum[Q - 1]) * hdh_all;
      sdcum[Q - 1] += hl + rdt;
      float run = 0.0f;
      for (int t = Q - 1; t >= 0; --t) {
        run += sdcum[t];
        sdcum[t] = run;
      }
      dap[((long long)b * H + hh) * nc + c] = da_pairs + part + hl * tt[Q - 1];
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int t = lane + 32 * i;
      if (t < qv) ddt[(row0 + t) * H + hh] = colz[i] + r[i] + sdcum[t] * ah;
    }
  };

  for (int k = 0; k < gn; ++k) {
    // head k's tiles landed (waited below); its vectors in; head k - 1's
    // partials in, and head k - 2's read
    __syncthreads();
    const float* sx = ring + (k & 1) * 4 * TILE;
    const float* sdy = sx + TILE;
    const float* shT = sx + 2 * TILE;
    const float* sdhT = sx + 3 * TILE;
    const float* dtk = sdt + k * Q;
    const float* cum = scum + k * Q;
    const float* tt = stt + k * Q;
    const float* ek = se + k * Q;
    const float* odec = so + k * Q;
    float* srowp = spart + (k & 1) * PART1;
    float* scolm = srowp + 4 * Q;
    float* scolz = scolm + 4 * Q;
    float* sdap = scolz + 4 * Q;
    if (warp == 0 && k > 0) row_vectors(k - 1);  // beside the other warps' phase 1

    // 1. P[t][s] = dy_t . x_s over the triangle tiles; the scores G L dt and
    //    P L dt to shared memory; the row and column sums of M = P G L dt and
    //    Z = P G L and this warp's share of sum M_ts (T_t - T_s)
    float pf[2][4] = {};
    mma_range<2>(pf, n_tri, 0, T / 8, a_of<true>(sdy, m0), b_of<true>(sx, 8 * jq, 32));
    float rowm[2] = {}, da_part = 0.0f;
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      if (m >= n_tri) continue;
      const int s = 8 * (jq + 4 * m) + 2 * t4;
      float colm[2] = {}, colz[2] = {};
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int t = frag_row(e);
        float vg[2], vp[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const bool live = s + u <= t;
          const float l = live ? expf(cum[t] - cum[s + u]) : 0.0f;  // masked before exp
          const float w = l * dtk[s + u];
          const float z = pf[m][e + u] * gf[m][e + u] * l;
          const float mv = z * dtk[s + u];
          rowm[e >> 1] += mv;
          colm[u] += mv;
          colz[u] += z;
          if (live) da_part += mv * (tt[t] - tt[s + u]);
          vg[u] = gf[m][e + u] * w;
          vp[u] = pf[m][e + u] * w;
        }
        *reinterpret_cast<float2*>(ssg + t * LD + s) = make_float2(vg[0], vg[1]);
        *reinterpret_cast<float2*>(ssp + t * LD + s) = make_float2(vp[0], vp[1]);
      }
#pragma unroll
      for (int u = 0; u < 2; ++u)  // over the lane's 8 rows g: lanes t4 alike
#pragma unroll
        for (int x = 4; x < 32; x <<= 1) {
          colm[u] += __shfl_xor_sync(0xffffffffu, colm[u], x);
          colz[u] += __shfl_xor_sync(0xffffffffu, colz[u], x);
        }
      if (g == 0) {
        *reinterpret_cast<float2*>(scolm + wi * Q + s) = make_float2(colm[0], colm[1]);
        *reinterpret_cast<float2*>(scolz + wi * Q + s) = make_float2(colz[0], colz[1]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rowm[i] += __shfl_xor_sync(0xffffffffu, rowm[i], 1);
      rowm[i] += __shfl_xor_sync(0xffffffffu, rowm[i], 2);
    }
    if (t4 == 0) {  // zero where the warp has no triangle tile
      srowp[jq * Q + m0 + g] = rowm[0];
      srowp[jq * Q + m0 + g + 8] = rowm[1];
    }
#pragma unroll
    for (int x = 1; x < 32; x <<= 1) da_part += __shfl_xor_sync(0xffffffffu, da_part, x);
    if (lane == 0) sdap[warp] = da_part;
    __syncthreads();  // the scores are in

    // 2. vh[t][n] = sum_d dy[t][d] h[d][n]; dy_t.(h C_t); dC[t][n] = sum_{s
    //    <= t} (P L dt)[t][s] B[s][n] + e_t vh[t][n], into dcacc
    {
      float vh[2][4] = {};
      mma_range<2>(vh, 2, 0, T / 8, a_of<true>(sdy, m0), b_of<true>(shT, n0));
      float ev[2] = {};
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ev[e >> 1] += vh[nt][e] * sc[frag_row(e) * LD + frag_col(nt, e)];
      float dc[2][4] = {};
      mma_range<2>(dc, 2, 0, 2 * wi + 2, a_of<true>(ssp, m0), b_of<false>(sb, n0));
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) dcacc[nt][e] += dc[nt][e] + ek[frag_row(e)] * vh[nt][e];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        ev[i] += __shfl_xor_sync(0xffffffffu, ev[i], 1);
        ev[i] += __shfl_xor_sync(0xffffffffu, ev[i], 2);
      }
      if (t4 == 0) {
        sevp[jq * Q + m0 + g] = ev[0];
        sevp[jq * Q + m0 + g + 8] = ev[1];
      }
    }
    // 3. dB[s][n] = sum_{t >= s} (P L dt)[t][s] C[t][n] + o_s dt_s sum_d
    //    x[s][d] dH[d][n], into dbacc
    {
      float db[2][4] = {}, xd[2][4] = {};
      mma_range<2>(db, 2, 2 * wi, T / 8, a_of<false>(ssp, m0), b_of<false>(sc, n0));
      mma_range<2>(xd, 2, 0, T / 8, a_of<true>(sx, m0), b_of<true>(sdhT, n0));
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int s = frag_row(e);
          dbacc[nt][e] += db[nt][e] + odec[s] * dtk[s] * xd[nt][e];
        }
    }
    // 4. dx[s][d] = sum_{t >= s} (G L dt)[t][s] dy[t][d] + o_s dt_s u[s][d],
    //    u[s][d] = sum_n B[s][n] dH[d][n]; x_s.u_s
    {
      float dx[2][4] = {}, u[2][4] = {};
      mma_range<2>(dx, 2, 2 * wi, T / 8, a_of<false>(ssg, m0), b_of<false>(sdy, n0));
      mma_range<2>(u, 2, 0, T / 8, a_of<true>(sb, m0), b_of<false>(sdhT, n0));
      float xu[2] = {};
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int s = frag_row(e);
        const float odt = odec[s] * dtk[s];
        float* out = dxs + ((row0 + s) * H + h0 + k) * dh;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int d = frag_col(nt, e);
          xu[e >> 1] += sx[s * LD + d] * u[nt][e] + sx[s * LD + d + 1] * u[nt][e + 1];
          const float v0 = dx[nt][e] + odt * u[nt][e], v1 = dx[nt][e + 1] + odt * u[nt][e + 1];
          if (s < qv) {
            if (V4) {  // dh is a multiple of 4: the pair is in the row, 8-byte aligned
              if (d < dh) *reinterpret_cast<float2*>(out + d) = make_float2(v0, v1);
            } else {
              if (d < dh) out[d] = v0;
              if (d + 1 < dh) out[d + 1] = v1;
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        xu[i] += __shfl_xor_sync(0xffffffffu, xu[i], 1);
        xu[i] += __shfl_xor_sync(0xffffffffu, xu[i], 2);
      }
      if (t4 == 0) {
        srp[jq * Q + m0 + g] = xu[0];
        srp[jq * Q + m0 + g + 8] = xu[1];
      }
    }
    // <dH, h> over this thread's elements, in a fixed order
    float hdh = 0.0f;
    for (int i = tid; i < T * T; i += NTC) {
      const int n = i / T, d = i % T;
      hdh += shT[n * LD + d] * sdhT[n * LD + d];
    }
#pragma unroll
    for (int x = 1; x < 32; x <<= 1) hdh += __shfl_xor_sync(0xffffffffu, hdh, x);
    if (lane == 0) shdh[warp] = hdh;
    __syncthreads();  // head k's tiles are read; its partials are in

    if (k + 2 < gn) stage_head(k + 2);  // into the slot head k leaves
    cp_async_commit();
    cp_async_wait<1>();  // head k + 1 landed (the barrier at the loop's top publishes it)
  }
  if (warp == 0) row_vectors(gn - 1);

  // this group's dB and dC partials
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int t = frag_row(e);
    if (t >= qv) continue;
    float* ob = dbp + ((row0 + t) * n_groups + grp) * N;
    float* oc = dcp + ((row0 + t) * n_groups + grp) * N;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int n = frag_col(nt, e);
      if (n < N) {
        ob[n] = dbacc[nt][e];
        oc[n] = dcacc[nt][e];
      }
    }
  }
}

// dbm / dcm [b][s][n] = sum over the head groups, in order, of the partials.
__global__ void ssd_bwd_reduce_kernel(const float* __restrict__ dbp,
                                      const float* __restrict__ dcp, float* __restrict__ dbm,
                                      float* __restrict__ dcm, long long rows, int n_groups,
                                      int N) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows * N) return;
  const long long r = i / N;
  const int n = (int)(i % N);
  const float* pb = dbp + r * n_groups * N + n;
  const float* pc = dcp + r * n_groups * N + n;
  float sb = 0.0f, sc = 0.0f;
  for (int q = 0; q < n_groups; ++q) {
    sb += pb[(long long)q * N];
    sc += pc[(long long)q * N];
  }
  dbm[i] = sb;
  dcm[i] = sc;
}

// da[h] = sum over batch rows, then chunks, in order, of the partials.
__global__ void ssd_bwd_da_kernel(const float* __restrict__ dap, float* __restrict__ da,
                                  int B, int H, int nc) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= H) return;
  float s = 0.0f;
  for (int b = 0; b < B; ++b)
    for (int c = 0; c < nc; ++c) s += dap[((long long)b * H + h) * nc + c];
  da[h] = s;
}

constexpr size_t STATES_SMEM = (size_t)(4 * TILE + (DT_SLOTS + 2) * Q + 2) * sizeof(float);

template <bool V4>
cudaError_t launch(const float* xs, const float* bm, const float* cm, const float* dt,
                   const float* a, const float* dy, float* dxs, float* dbm, float* dcm,
                   float* ddt, float* da, float* states, float* dstates, float* dbp, float* dcp,
                   float* dap, int B, int S, int H, int dh, int N, int G, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(ssd_bwd_states_kernel<V4>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)STATES_SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_bwd_chunk_kernel<V4>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)CHUNK_SMEM);
  if (err != cudaSuccess) return err;
  ssd_bwd_states_kernel<V4><<<dim3(2u, (unsigned)H, (unsigned)B), NT, STATES_SMEM, st>>>(
      xs, bm, cm, dt, a, dy, states, dstates, S, H, dh, N);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int nc = (S + Q - 1) / Q, n_groups = (H + G - 1) / G;
  ssd_bwd_chunk_kernel<V4><<<dim3((unsigned)nc, (unsigned)n_groups, (unsigned)B), NTC, CHUNK_SMEM,
                             st>>>(xs, bm, cm, dt, a, dy, states, dstates, dxs, ddt, dbp, dcp,
                                   dap, S, H, dh, N, G);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long rows = (long long)B * S;
  ssd_bwd_reduce_kernel<<<(unsigned)((rows * N + 255) / 256), 256, 0, st>>>(dbp, dcp, dbm, dcm,
                                                                             rows, n_groups, N);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_da_kernel<<<(unsigned)((H + 127) / 128), 128, 0, st>>>(dap, da, B, H, nc);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return ((unsigned long long)p & 15u) == 0; }

}  // namespace

// states and dstates: (B, H, nc, 64, 64) f32 scratch (h^T and dH^T of every
// chunk); dbp, dcp: (B, S, ceil(H / G), N); dap: (B, H, nc).  Outputs dxs
// (B, S, H, dh), dbm, dcm (B, S, N), ddt (B, S, H), da (H,).  G heads per
// chunk block (1..8).  Returns cudaGetLastError() after the last launch.
extern "C" int seifer_ssd_scan_bwd(const void* xs, const void* bm, const void* cm,
                                   const void* dt, const void* a, const void* dy, void* dxs,
                                   void* dbm, void* dcm, void* ddt, void* da, void* states,
                                   void* dstates, void* dbp, void* dcp, void* dap, int B, int S,
                                   int H, int dh, int N, int G, void* stream) {
  if (dh < 1 || dh > T || N < 1 || N > T || B < 1 || S < 1 || H < 1 || G < 1 || G > MAX_GROUP)
    return (int)cudaErrorInvalidValue;
  const bool v4 = dh % 4 == 0 && N % 4 == 0 && aligned16(xs) && aligned16(dy) &&
                  aligned16(bm) && aligned16(cm);
  const auto run = v4 ? launch<true> : launch<false>;
  return (int)run((const float*)xs, (const float*)bm, (const float*)cm, (const float*)dt,
                  (const float*)a, (const float*)dy, (float*)dxs, (float*)dbm, (float*)dcm,
                  (float*)ddt, (float*)da, (float*)states, (float*)dstates, (float*)dbp,
                  (float*)dcp, (float*)dap, B, S, H, dh, N, G, (cudaStream_t)stream);
}

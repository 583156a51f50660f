// Chunked Mamba2 SSD scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ssd_chunked_tpu (_ssd_kernel) in
// src/repro/kernels/ssm_scan/kernel.py:66.  For each chunk of Q rows:
//   y     = (C B^T o L o dt) x + (C state^T) o exp(cum)
//   state = state * exp(cum_last) + x^T (B o exp(cum_last - cum) dt)
// with cum the in-chunk prefix sum of dt * a and L = tril(exp(cum_t - cum_s)).
//
// What bounds it on an H100: bytes -- xs in and y out (B*S*H*dh f32 each)
// plus bm, cm, dt, 1.37 GB at the served shape (B=4, S=8192, H=80,
// dh=N=64), 0.41 ms at 3.35 TB/s; the operations, Q(Q+1)(N+dh) + 4*Q*N*dh +
// N*dh FLOPs a chunk (64.9 GFLOP here; 47.3 at the cheapest chunking, 0.29
// ms at 3 split-TF32 passes), bound it less.  The design, in three steps:
//
// 1. Segments fill the card.  The TPU runs the chunk axis as the last,
//    sequential grid axis and carries the state in VMEM; one block per
//    (batch row, head) looping over all chunks gives 320 blocks here, 1.2
//    waves.  Each sequence is cut into P segments of whole chunks (the
//    wrapper picks P from the SM count: 2 at the served shape).  A state
//    kernel scans every segment but the last from a zero state for its end
//    state L_p and its decay D_p (the product, in chunk order, of the
//    chunks' exp(cum_last)); the output kernel folds s = s D_p' + L_p' over
//    the earlier segments, in order, and scans its own segment from s.
//    That re-reads xs, bm and dt and repeats the state product for all but
//    the last segment; ref.ssd_ref_segmented is the same decomposition.
// 2. Loads overlap the math.  A block stages chunk k + 1 with 16-byte
//    cp.async (4-byte where dh or N is not a multiple of 4) into a ring of
//    two x and B tiles while chunk k computes; C, read only by the first two
//    products, is staged into its one tile once they are done.  Tiles keep
//    their memory layout, zero-filled past a ragged last chunk and past dh
//    or N.  dt runs two chunks ahead, so warp 0 builds chunk k + 1's cum
//    while the others compute chunk k.  cum is summed in the plain version's
//    fixed order (in order within blocks of 16, then the block totals; no
//    FMA contraction), bit-identical to the plain version's.
// 3. The four products -- C state^T, C B^T (lower-triangle tiles only),
//    scores x and (B w)^T x -- run on the tensor cores: mma.sync m16n8k8
//    TF32, each f32 operand split into hi + lo (truncating: two
//    instructions) and multiplied in three passes, every sum at most 12
//    mma in a fresh fragment before an f32 add.  cum, the decays, the mask
//    before exp and the scaling by dt and w stay on the FMA units.  The
//    state lives in registers as the state product's fragments, and in
//    shared memory (as state^T) only for C state^T, in the tile the scores
//    then take over.  Row strides of 68 (x, B, C) and 72 (state / scores)
//    floats put every fragment load of 32 lanes in 32 banks.
//
// Grouped B and C (Mamba2's ngroups, Zamba2-7B's 2): bm and cm are (B, S, G,
// N), and head h reads group h / (H / G).  G = 1 is the (B, S, N) layout:
// the same offsets, strides and instructions.
//
// Two 107 KB blocks of 8 warps share an SM (three 71 KB state-kernel
// blocks).  What holds the kernel back now is neither bytes nor the tensor
// pipe but, as far as timings without a profiler of the SM can tell, the
// latency of five barriers a chunk at 16 warps an SM (PERF.md).  It tiles at its
// own chunk, KERNEL_CHUNK = 64, whatever chunk the caller asks for (the math
// is chunk-invariant): a Q x Q f32 score tile at Q = seq = 8192 would be
// 256 MiB.

#include <cuda_runtime.h>

#include "split_tf32.cuh"

using split_tf32::cp_async16;
using split_tf32::cp_async4;
using split_tf32::cp_async_commit;
using split_tf32::cp_async_wait;

constexpr int Q = 64;     // KERNEL_CHUNK: rows per chunk
constexpr int T = 64;     // dh and N are zero-padded to 64 in shared memory
constexpr int LD = 68;    // row stride of the x, B and C tiles, in floats
constexpr int LDR = 72;   // row stride of the state^T / scores tile
constexpr int NT = 256;   // threads: 8 warps
constexpr int SCAN_BLOCK = 16;  // cum's summation blocks (ref.SCAN_BLOCK)
constexpr int TILE = Q * LD;
constexpr int TILE_R = Q * LDR;
constexpr int DT_SLOTS = 3;  // dt of chunks k (scores), k + 1 (cum), k + 2 (landing)
constexpr int GROUP = 4;     // k steps a fresh mma fragment takes: 12 mma

// x[2], B[2], C, state^T / scores (FULL); x[2], B[2] otherwise; then dt,
// cum and w
static size_t smem_bytes(bool full) {
  return ((full ? 5 * TILE + TILE_R : 4 * TILE) + (DT_SLOTS + 2 + 2) * Q) * sizeof(float);
}

// acc[nt] (16 x 8 each, mma C layout) += A (16 x 8 K_STEPS) . B (8 K_STEPS x 8
// per tile), k steps ks0.., for the tiles nt < ntiles, on the tensor cores in
// split-TF32: each operand as hi + lo (split_trunc, two instructions), three
// passes small terms first.  A fresh fragment takes G k steps (3 G <= 12
// mma) and is then added in f32: the tensor cores' own accumulation loses
// bits over longer sums.
// fa(ks, v) gives this lane's A fragment of k step ks (a0..a3), fb(ks, nt,
// v) its B fragment of tile nt (b0, b1), as f32.  Unrolled, so the loads
// of later steps are issued while earlier mma run.
template <int NTILES, int K_STEPS, int G, class FA, class FB>
static __device__ __forceinline__ void mma_product(float (&acc)[NTILES][4], int ntiles, int ks0,
                                                   FA fa, FB fb) {
  static_assert(K_STEPS % G == 0 && 3 * G <= 12, "at most 12 mma a fresh fragment");
  using split_tf32::mma;
  using split_tf32::split_trunc;
  __syncwarp();  // mma.sync is .aligned: every lane of the warp, converged
#pragma unroll
  for (int k0 = 0; k0 < K_STEPS; k0 += G) {
    float f[NTILES][4] = {};
#pragma unroll
    for (int kk = 0; kk < G; ++kk) {
      const int ks = ks0 + k0 + kk;
      float av[4];
      fa(ks, av);
      uint32_t ah[4], al[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) split_trunc(av[i], ah[i], al[i]);
#pragma unroll
      for (int nt = 0; nt < NTILES; ++nt) {
        if (nt >= ntiles) continue;  // warp-uniform
        float bv[2];
        fb(ks, nt, bv);
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

// Rows [0, Q) of a slab (row r at src + r * stride, `width` floats) into a
// shared tile, asynchronously; rows >= qv and columns >= width are
// zero-filled, never read.  V4: width and stride are multiples of 4.
template <bool V4>
static __device__ __forceinline__ void stage_tile(float* dst, const float* src,
                                                  long long stride, int qv, int width,
                                                  int tid) {
  if (V4) {
    for (int i = tid; i < Q * (T / 4); i += NT) {
      const int r = i / (T / 4), c = (i % (T / 4)) * 4;
      const bool ok = r < qv && c < width;
      cp_async16(dst + r * LD + c, ok ? src + r * stride + c : src, ok ? 16 : 0);
    }
  } else {
    for (int i = tid; i < Q * T; i += NT) {
      const int r = i / T, c = i % T;
      const bool ok = r < qv && c < width;
      cp_async4(dst + r * LD + c, ok ? src + r * stride + c : src, ok ? 4 : 0);
    }
  }
}

// Warp 0: cum of a chunk in the plain version's order (in order within
// blocks of 16, then the block totals in order; no FMA contraction), and
// w[s] = exp(cum_last - cum[s]) dt[s].  dt is zero past the qv rows.  Lane
// l sums rows l and l + 32 from the start of their blocks, in order (the
// same additions as one running sum a block); the block totals come by
// shuffles, so no lane reads shared memory another lane of the warp writes.
static __device__ __forceinline__ void chunk_cum(const float* sdt, float* scum, float* sw,
                                                 float ah, int qv, int lane) {
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
  float cum[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int blk = (lane + 32 * k) / SCAN_BLOCK;
    float excl = 0.0f;
#pragma unroll
    for (int j = 0; j < 3; ++j)
      if (j < blk) excl = __fadd_rn(excl, tot[j]);
    cum[k] = __fadd_rn(excl, within[k]);
    scum[lane + 32 * k] = cum[k];
  }
  const int last = qv - 1;
  const float c0 = __shfl_sync(ALL, cum[0], last & 31), c1 = __shfl_sync(ALL, cum[1], last & 31);
  const float cum_last = last < 32 ? c0 : c1;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int t = lane + 32 * k;
    sw[t] = expf(cum_last - cum[k]) * sdt[t];
  }
}

// The first chunk of segment p of n_chunks (ref.segment_starts).
static __device__ __forceinline__ int segment_start(int p, int n_chunks, int P) {
  return (int)((long long)p * n_chunks / P);
}

// grid (segments, H, B): one block per segment of one (head, batch row),
// looping over the segment's chunks.  FULL: y of the segment, from the
// state folded from the earlier segments' end states.  Otherwise (the
// segments but the last) only the state, from zero: its end state goes to
// ends[b][h][p] (state^T, N x dh padded to T x T) and the product of the
// chunks' exp(cum_last), in chunk order, to decays[b][h][p].
template <bool FULL, bool V4>
static __global__ void __launch_bounds__(NT, FULL ? 2 : 3)
ssd_scan_kernel(const float* __restrict__ xs, const float* __restrict__ bm,
                const float* __restrict__ cm, const float* __restrict__ dt,
                const float* __restrict__ a, float* __restrict__ y,
                float* __restrict__ ends, float* __restrict__ decays, int S, int H,
                int dh, int N, int G, int P) {
  extern __shared__ __align__(16) float smem[];
  float* sx = smem;              // x[s][d], two chunks
  float* sb = sx + 2 * TILE;     // B[s][n], two chunks
  float* sc = sb + 2 * TILE;     // C[t][n] (FULL)
  float* sr = sc + TILE;         // state^T[n][d], then the scores S[t][s] (FULL)
  float* sdt = FULL ? sr + TILE_R : sc;  // dt[s], DT_SLOTS chunks
  float* scum = sdt + DT_SLOTS * Q;      // cum[t], two chunks
  float* sw = scum + 2 * Q;              // exp(cum_last - cum[s]) dt[s], two chunks

  const int seg = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // mma fragments: lane = 4 g + t; this warp's outputs are rows m0 + [0, 16)
  // (t of y, n of the state) by columns n0 + [0, 32) (d), four 8-wide tiles
  const int g = lane >> 2, t4 = lane & 3;
  const int wi = warp >> 1, m0 = 16 * wi, n0 = 32 * (warp & 1);
  const float ah = a[h];
  const int n_chunks = (S + Q - 1) / Q;
  const int c_begin = segment_start(seg, n_chunks, P);
  const int nk = segment_start(seg + 1, n_chunks, P) - c_begin;
  const long long seq = (long long)b * H + h;
  const int grp = h / (H / G);  // the B / C group this head reads
  const long long bc_stride = (long long)G * N;  // a row of B or C, every group

  const auto rows_of = [&](int k) { return min(Q, S - (c_begin + k) * Q); };
  const auto row0 = [&](int k) { return (long long)b * S + (long long)(c_begin + k) * Q; };
  const auto stage_xb = [&](int k) {
    const long long g0 = row0(k);
    stage_tile<V4>(sx + (k & 1) * TILE, xs + (g0 * H + h) * dh, (long long)H * dh,
                   rows_of(k), dh, tid);
    stage_tile<V4>(sb + (k & 1) * TILE, bm + g0 * bc_stride + (long long)grp * N, bc_stride,
                   rows_of(k), N, tid);
  };
  const auto stage_c = [&](int k) {
    stage_tile<V4>(sc, cm + row0(k) * bc_stride + (long long)grp * N, bc_stride, rows_of(k), N,
                   tid);
  };
  const auto stage_dt = [&](int k) {
    if (tid < Q) {
      const long long g0 = row0(k);
      const bool ok = tid < rows_of(k);
      cp_async4(sdt + (k % DT_SLOTS) * Q + tid, dt + (g0 + (ok ? tid : 0)) * H + h, ok ? 4 : 0);
    }
  };
  // element e of this lane's fragment of tile nt: row m0 + g (+ 8), column
  // n0 + 8 nt + 2 t4 (+ 1)
  const auto frag_row = [&](int e) { return m0 + g + 8 * (e >> 1); };
  const auto frag_col = [&](int nt, int e) { return n0 + 8 * nt + 2 * t4 + (e & 1); };

  stage_xb(0);
  if (FULL) stage_c(0);
  stage_dt(0);
  if (nk > 1) stage_dt(1);
  cp_async_commit();

  // the starting state^T in this warp's fragments: zero, or s = s D_p' + L_p'
  // over the earlier segments in order (ref.ssd_ref_segmented)
  float st[4][4] = {};
  if (FULL) {
    for (int q = 0; q < seg; ++q) {
      const float dq = decays[seq * (P - 1) + q];
      const float* lq = ends + (seq * (P - 1) + q) * (T * T);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          st[nt][e] = __fadd_rn(__fmul_rn(st[nt][e], dq), lq[frag_row(e) * T + frag_col(nt, e)]);
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; e += 2)
        *reinterpret_cast<float2*>(&sr[frag_row(e) * LDR + frag_col(nt, e)]) =
            make_float2(st[nt][e], st[nt][e + 1]);
  }
  cp_async_wait<0>();
  __syncthreads();
  if (warp == 0) chunk_cum(sdt, scum, sw, ah, rows_of(0), lane);
  float decay = 1.0f;

  for (int k = 0; k < nk; ++k) {
    const int qv = rows_of(k);
    const long long g0 = row0(k);
    const bool last = k + 1 == nk;
    if (!last) stage_xb(k + 1);
    if (k + 2 < nk) stage_dt(k + 2);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // chunk k landed (dt of k + 1 too); cum and w of chunk k written
    const float* x = sx + (k & 1) * TILE;
    float* bb = sb + (k & 1) * TILE;
    const float* cum = scum + (k & 1) * Q;
    const float* w = sw + (k & 1) * Q;
    const float* dtk = sdt + (k % DT_SLOTS) * Q;
    // warp 0 builds chunk k + 1's cum: at once in the state pass, after its
    // scores (the fewest of any warp) in the full one
    const auto next_cum = [&] {
      if (warp == 0 && !last)
        chunk_cum(sdt + ((k + 1) % DT_SLOTS) * Q, scum + ((k + 1) & 1) * Q,
                  sw + ((k + 1) & 1) * Q, ah, rows_of(k + 1), lane);
    };
    if (!FULL) next_cum();

    // 4. state^T[n][d] = state^T[n][d] exp(cum_last) + sum_s B[s][n] w[s] x[s][d]
    //    (sa, after the products of the full pass), rows n, k = s relabelled as
    //    in 3; B is scaled by w as it is read, x is the B operand of 3 too
    float sa[4][4] = {};
    const auto bw_frag = [&](int ks, float* v) {
      const float* r = bb + (8 * ks + 2 * t4) * LD + m0 + g;
      const float w0 = w[8 * ks + 2 * t4], w1 = w[8 * ks + 2 * t4 + 1];
      v[0] = r[0] * w0;
      v[1] = r[8] * w0;
      v[2] = r[LD] * w1;
      v[3] = r[LD + 8] * w1;
    };
    const auto x_frag = [&](int ks, int nt, float* v) {
      const float* r = x + (8 * ks + 2 * t4) * LD + n0 + 8 * nt + g;
      v[0] = r[0];
      v[1] = r[LD];
    };
    const float cum_last = cum[qv - 1];

    if (FULL) {
      // C's rows as A fragments (k = n), plain k labels: a0 (g, t), a1 (g + 8,
      // t), a2 (g, t + 4), a3 (g + 8, t + 4); LD = 68 puts them in 32 banks
      const auto c_frag = [&](int ks, float* v) {
        const float* c = sc + (m0 + g) * LD + 8 * ks + t4;
        v[0] = c[0];
        v[1] = c[8 * LD];
        v[2] = c[4];
        v[3] = c[8 * LD + 4];
      };
      // 1. yo[t][d] = sum_n C[t][n] state^T[n][d]
      float yo[4][4] = {};
      mma_product<4, T / 8, GROUP>(yo, 4, 0, c_frag, [&](int ks, int nt, float* v) {
        const float* r = sr + (8 * ks + t4) * LDR + n0 + 8 * nt + g;
        v[0] = r[0];
        v[1] = r[4 * LDR];
      });
      __syncthreads();  // done reading state^T: the tile takes the scores

      // 2. S[t][s] = (C_t . B_s) exp(cum_t - cum_s) dt_s for s <= t, else 0.
      //    Rows m0..m0 + 15 need the columns s < m0 + 16: 2 (wi + 1) tiles of 8,
      //    split between the two warps of these rows (tiles 2 m + warp % 2).
      float gs[4][4] = {};
      const int jw = warp & 1;
      mma_product<4, T / 8, GROUP>(gs, wi + 1, 0, c_frag, [&](int ks, int m, float* v) {
        const float* r = bb + (8 * (2 * m + jw) + g) * LD + 8 * ks + t4;
        v[0] = r[0];
        v[1] = r[4];
      });
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        if (m > wi) continue;
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const int t = frag_row(e), s = 8 * (2 * m + jw) + 2 * t4;
          float v[2];
#pragma unroll
          for (int u = 0; u < 2; ++u)
            v[u] = s + u <= t ? gs[m][e + u] * expf(cum[t] - cum[s + u]) * dtk[s + u] : 0.0f;
          *reinterpret_cast<float2*>(&sr[t * LDR + s]) = make_float2(v[0], v[1]);
        }
      }
      next_cum();
      __syncthreads();  // the scores are in; C and the raw B are read
      if (!last) {
        stage_c(k + 1);
        cp_async_commit();
      }

      // 3. y[t][d] = yo[t][d] exp(cum_t) + sum_{s <= t} S[t][s] x[s][d] over
      //    s < m0 + 16.  k labels relabelled in each group of 8 (A column t ->
      //    k = 2t, t + 4 -> 2t + 1): a lane reads a float2 of a score row; x
      //    rows 2t, 2t + 1 hit 32 banks
      float yi[4][4] = {};
      const auto s_frag = [&](int ks, float* v) {
        const float2 lo = *reinterpret_cast<const float2*>(&sr[(m0 + g) * LDR + 8 * ks + 2 * t4]);
        const float2 hi = *reinterpret_cast<const float2*>(&sr[(m0 + g + 8) * LDR + 8 * ks + 2 * t4]);
        v[0] = lo.x;
        v[1] = hi.x;
        v[2] = lo.y;
        v[3] = hi.y;
      };
      for (int kp = 0; kp <= wi; ++kp) mma_product<4, 2, 2>(yi, 4, 2 * kp, s_frag, x_frag);
#pragma unroll
      for (int e = 0; e < 4; e += 2) {  // a lane holds columns 2 t4, 2 t4 + 1
        const int t = frag_row(e);
        if (t >= qv) continue;
        const float ex = expf(cum[t]);
        float* yr = y + ((g0 + t) * H + h) * dh;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int d = frag_col(nt, e);
          const float y0 = yi[nt][e] + yo[nt][e] * ex, y1 = yi[nt][e + 1] + yo[nt][e + 1] * ex;
          if (V4) {  // dh is a multiple of 4: the pair is in the row, 8-byte aligned
            if (d < dh) *reinterpret_cast<float2*>(yr + d) = make_float2(y0, y1);
          } else {
            if (d < dh) yr[d] = y0;
            if (d + 1 < dh) yr[d + 1] = y1;
          }
        }
      }
      if (last) break;  // the segment's end state is not needed
    }
    mma_product<4, Q / 8, GROUP>(sa, 4, 0, bw_frag, x_frag);
    const float el = expf(cum_last);
    decay = __fmul_rn(decay, el);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[nt][e] = st[nt][e] * el + sa[nt][e];
    if (FULL) {
      __syncthreads();  // the scores are read: the tile takes the state back
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; e += 2)
          *reinterpret_cast<float2*>(&sr[frag_row(e) * LDR + frag_col(nt, e)]) =
              make_float2(st[nt][e], st[nt][e + 1]);
    }
    __syncthreads();  // the ring slot of chunk k, and the state tile, are free
  }
  if (!FULL) {  // this segment's end state and decay, for the later segments
    float* lp = ends + (seq * (P - 1) + seg) * (T * T);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; e += 2)
        *reinterpret_cast<float2*>(lp + frag_row(e) * T + frag_col(nt, e)) =
            make_float2(st[nt][e], st[nt][e + 1]);
    if (tid == 0) decays[seq * (P - 1) + seg] = decay;
  }
}

template <bool V4>
static cudaError_t launch(const float* xs, const float* bm, const float* cm, const float* dt,
                          const float* a, float* y, float* ends, float* decays, int B, int S,
                          int H, int dh, int N, int G, int P, cudaStream_t st) {
  const size_t part = smem_bytes(false), full = smem_bytes(true);
  cudaError_t err = cudaFuncSetAttribute(ssd_scan_kernel<false, V4>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)part);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_scan_kernel<true, V4>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)full);
  if (err != cudaSuccess) return err;
  if (P > 1) {
    ssd_scan_kernel<false, V4><<<dim3((unsigned)(P - 1), (unsigned)H, (unsigned)B), NT, part,
                                 st>>>(xs, bm, cm, dt, a, y, ends, decays, S, H, dh, N, G, P);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  ssd_scan_kernel<true, V4><<<dim3((unsigned)P, (unsigned)H, (unsigned)B), NT, full, st>>>(
      xs, bm, cm, dt, a, y, ends, decays, S, H, dh, N, G, P);
  return cudaGetLastError();
}

extern "C" int seifer_ssd_scan(const void* xs, const void* bm, const void* cm,
                               const void* dt, const void* a, void* y, void* ends,
                               void* decays, int B, int S, int H, int dh, int N, int G,
                               int P, void* stream) {
  if (dh < 1 || dh > T || N < 1 || N > T || P < 1 || G < 1 || H % G != 0)
    return (int)cudaErrorInvalidValue;
  const auto run = (dh % 4 == 0 && N % 4 == 0) ? launch<true> : launch<false>;
  return (int)run((const float*)xs, (const float*)bm, (const float*)cm, (const float*)dt,
                  (const float*)a, (float*)y, (float*)ends, (float*)decays, B, S, H, dh, N, G,
                  P, (cudaStream_t)stream);
}

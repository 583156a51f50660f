// Backward of the chunked Mamba2 SSD scan for Hopper (sm_90a): dxs, dbm,
// dcm, ddt and da in f32 from the scan's inputs and dy.
//
// Replaces what the JAX package differentiates with jax.grad: the jnp chunk
// scan of mamba_forward (src/repro/models/ssm.py:105-130, ssd_ref in
// src/repro/kernels/ssm_scan/ref.py:20).  The Pallas ssd_chunked_tpu has no
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
// products take r (r + 1) (dh + 2 N) + 10 r dh N FLOPs per head and chunk of
// r rows, and r (r + 1) N for C B^T, which the heads share: 57.3 GFLOP at
// the cheapest chunking (r = 8), 0.35 ms at three split-TF32 passes; 70.3
// GFLOP at this kernel's r = 64, 1.05 ms on the FMA units it uses
// (chip_smoke.py's ssd_bwd_flops).
//
// The design, simple first: four launches, no atomics (two runs are equal,
// as the flash backward's and as a bit-exact resume needs), every product
// on the FMA units in f32.
//   (a) ssd_bwd_states_kernel, grid (H, B, 2): the two recurrences, one
//       block per (head, batch row) and direction, walking the chunks in
//       order (z = 0: the state entering each chunk) or in reverse (z = 1:
//       dH leaving each chunk), into (B, H, nc, dh, N) scratch.  The only
//       sequential part of the backward, one 64 x 64 x 64 product a chunk.
//   (b) ssd_bwd_chunk_kernel, grid (nc, H, B): every chunk at once, given
//       its h and dH: dx and ddt written, the head's share of dB and dC
//       into (B, S, H, N) scratch and of da into (B, H, nc).
//   (c) ssd_bwd_reduce_kernel: dB and dC summed over heads, in head order.
//   (d) ssd_bwd_da_kernel: da summed over batch rows and chunks, in order.
// Tiles are Q = 64 rows (KERNEL_CHUNK) whatever chunk the caller asks for,
// zero-filled past a ragged last chunk and past dh or N, so padded rows add
// nothing and are never written.  cum (and T, the in-chunk sum of dt) is
// summed in ref.chunk_cumsum's fixed order, as the forward kernel does.
// Shared tiles have a row stride of 65 floats; a thread owns rows ty + 16 i
// and columns tx + 16 j of a 64 x 64 output, so the 16 lanes of a half-warp
// read 16 consecutive columns (distinct banks) and broadcast one row.

#include <cuda_runtime.h>

namespace {

constexpr int Q = 64;   // KERNEL_CHUNK: rows per chunk
constexpr int T = 64;   // dh and N are zero-padded to 64 in shared memory
constexpr int LD = 65;  // row stride of the shared tiles, in floats
constexpr int NT = 256;  // threads: a 16 x 16 grid, each owning 4 x 4 outputs
constexpr int SCAN_BLOCK = 16;  // ref.SCAN_BLOCK
constexpr int TILE = Q * LD;

// Row t of a chunk's inclusive cumsum of dt * ah, in ref.chunk_cumsum's
// order: in order within blocks of 16, plus the block totals before it,
// summed in order; no FMA contraction.  dt is zero past the chunk's rows.
__device__ __forceinline__ float chunk_cum_at(const float* sdt, float ah, int t) {
  float excl = 0.0f;
  for (int j = 0; j < t / SCAN_BLOCK; ++j) {
    float tot = __fmul_rn(sdt[SCAN_BLOCK * j], ah);
    for (int i = SCAN_BLOCK * j + 1; i < SCAN_BLOCK * (j + 1); ++i)
      tot = __fadd_rn(tot, __fmul_rn(sdt[i], ah));
    excl = __fadd_rn(excl, tot);
  }
  const int t0 = t & ~(SCAN_BLOCK - 1);
  float within = __fmul_rn(sdt[t0], ah);
  for (int i = t0 + 1; i <= t; ++i) within = __fadd_rn(within, __fmul_rn(sdt[i], ah));
  return __fadd_rn(excl, within);
}

// Rows [0, Q) of a slab (row r at src + r * stride, `width` floats) into a
// shared tile with row stride LD; rows >= qv and columns >= width are zero.
__device__ __forceinline__ void load_tile(float* dst, const float* src, long long stride,
                                          int qv, int width, int tid) {
  for (int i = tid; i < Q * T; i += NT) {
    const int r = i / T, c = i % T;
    dst[r * LD + c] = (r < qv && c < width) ? src[r * stride + c] : 0.0f;
  }
}

// dt of the chunk's rows (zero past qv) into sdt[0, Q).
__device__ __forceinline__ void load_dt(float* sdt, const float* dt, long long row0, int H,
                                       int h, int qv, int tid) {
  if (tid < Q) sdt[tid] = tid < qv ? dt[(row0 + tid) * H + h] : 0.0f;
}

// Sum over the 16 lanes of a half-warp (one row of the thread grid), in a
// fixed order; every lane gets the sum.
__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int m = 1; m < 16; m <<= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// Sum of one value from every thread, in thread order, for thread 0 (the
// others get 0).  Uses red[NT]; starts and ends with a barrier.
__device__ __forceinline__ float block_sum(float v, float* red, int tid) {
  __syncthreads();
  red[tid] = v;
  __syncthreads();
  float s = 0.0f;
  if (tid == 0)
    for (int i = 0; i < NT; ++i) s += red[i];
  __syncthreads();
  return s;
}

// (a) z = 0: st <- exp(cum_L) st + sum_s x_s (w_s B_s)^T, w_s = exp(cum_L -
// cum_s) dt_s, from zero; the state entering chunk c to states[.., c].
// z = 1: st <- exp(cum_L) st + sum_t dy_t (e_t C_t)^T, walked from the last
// chunk with st = 0; dH leaving chunk c to dstates[.., c].
__global__ void __launch_bounds__(NT, 3)
ssd_bwd_states_kernel(const float* __restrict__ xs, const float* __restrict__ bm,
                      const float* __restrict__ cm, const float* __restrict__ dt,
                      const float* __restrict__ a, const float* __restrict__ dy,
                      float* __restrict__ states, float* __restrict__ dstates, int S, int H,
                      int dh, int N) {
  extern __shared__ float smem[];
  float* sv = smem;          // x[s][d] (z = 0) or dy[t][d] (z = 1)
  float* sw = sv + TILE;     // B[s][n] or C[t][n]
  float* sdt = sw + TILE;    // dt
  float* scum = sdt + Q;     // cum
  float* swt = scum + Q;     // the weights w
  const int h = blockIdx.x, b = blockIdx.y;
  const bool reverse = blockIdx.z == 1;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int nc = (S + Q - 1) / Q;
  const float ah = a[h];
  const float* vsrc = reverse ? dy : xs;
  const float* wsrc = reverse ? cm : bm;
  float* out = (reverse ? dstates : states) + ((long long)b * H + h) * nc * dh * N;

  float st[4][4] = {};
  for (int k = 0; k < nc; ++k) {
    const int c = reverse ? nc - 1 - k : k;
    float* oc = out + (long long)c * dh * N;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int d = ty + 16 * i, n = tx + 16 * j;
        if (d < dh && n < N) oc[d * N + n] = st[i][j];
      }
    if (k + 1 == nc) break;
    const int qv = min(Q, S - c * Q);
    const long long row0 = (long long)b * S + (long long)c * Q;
    __syncthreads();  // the tiles of the last chunk are read
    load_tile(sv, vsrc + (row0 * H + h) * dh, (long long)H * dh, qv, dh, tid);
    load_tile(sw, wsrc + row0 * N, N, qv, N, tid);
    load_dt(sdt, dt, row0, H, h, qv, tid);
    __syncthreads();
    if (tid < Q) scum[tid] = chunk_cum_at(sdt, ah, tid);
    __syncthreads();
    const float cum_last = scum[Q - 1];  // rows past qv add 0 to cum
    if (tid < Q)
      swt[tid] = reverse ? expf(scum[tid]) : expf(cum_last - scum[tid]) * sdt[tid];
    __syncthreads();
    float acc[4][4] = {};
    for (int s = 0; s < Q; ++s) {
      const float wv = swt[s];
      float u[4], v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) u[i] = sv[s * LD + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = sw[s * LD + tx + 16 * j] * wv;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += u[i] * v[j];
    }
    const float el = expf(cum_last);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) st[i][j] = st[i][j] * el + acc[i][j];
  }
}

// (b) One chunk of one (head, batch row).  Shared: x, B, C, dy tiles, a
// state tile (h, then dH) and a score tile (G o L dt, then P o L dt), then
// the row vectors and the column partials of the 16 thread rows.
__global__ void __launch_bounds__(NT, 2)
ssd_bwd_chunk_kernel(const float* __restrict__ xs, const float* __restrict__ bm,
                     const float* __restrict__ cm, const float* __restrict__ dt,
                     const float* __restrict__ a, const float* __restrict__ dy,
                     const float* __restrict__ states, const float* __restrict__ dstates,
                     float* __restrict__ dxs, float* __restrict__ ddt,
                     float* __restrict__ dbp, float* __restrict__ dcp, float* __restrict__ dap,
                     int S, int H, int dh, int N) {
  extern __shared__ float smem[];
  float* sx = smem;          // x[s][d]
  float* sb = sx + TILE;     // B[s][n]
  float* sc = sb + TILE;     // C[t][n]
  float* sdy = sc + TILE;    // dy[t][d]
  float* shs = sdy + TILE;   // h[d][n], then dH[d][n]
  float* ssc = shs + TILE;   // scores[t][s]: G L dt, then P L dt
  float* sdt = ssc + TILE;   // dt[s]
  float* scum = sdt + Q;     // cum[t]
  float* stt = scum + Q;     // T[t], the in-chunk cumsum of dt
  float* se = stt + Q;       // exp(cum_t)
  float* so = se + Q;        // exp(cum_L - cum_s)
  float* srow = so + Q;      // sum_s M_ts
  float* sev = srow + Q;     // e_t dy_t.(h C_t)
  float* sr = sev + Q;       // r_s
  float* sdcum = sr + Q;     // dcum, then dda
  float* scolm = sdcum + Q;  // [16][Q] column partials of M
  float* scolz = scolm + 16 * Q;  // [16][Q] column partials of Z = P G L
  float* red = scolz + 16 * Q;    // [NT] block sums

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int nc = (S + Q - 1) / Q;
  const int qv = min(Q, S - c * Q);
  const long long row0 = (long long)b * S + (long long)c * Q;
  const long long seq = (long long)b * H + h;
  const float ah = a[h];
  const float* hc = states + (seq * nc + c) * dh * N;
  const float* dhc = dstates + (seq * nc + c) * dh * N;

  load_tile(sx, xs + (row0 * H + h) * dh, (long long)H * dh, qv, dh, tid);
  load_tile(sdy, dy + (row0 * H + h) * dh, (long long)H * dh, qv, dh, tid);
  load_tile(sb, bm + row0 * N, N, qv, N, tid);
  load_tile(sc, cm + row0 * N, N, qv, N, tid);
  load_tile(shs, hc, N, dh, N, tid);
  load_dt(sdt, dt, row0, H, h, qv, tid);
  __syncthreads();
  if (tid < Q) {
    scum[tid] = chunk_cum_at(sdt, ah, tid);
    stt[tid] = chunk_cum_at(sdt, 1.0f, tid);
  }
  __syncthreads();
  const float cum_last = scum[Q - 1];  // rows past qv add 0 to cum
  const float el = expf(cum_last);
  if (tid < Q) {
    se[tid] = expf(scum[tid]);
    so[tid] = expf(cum_last - scum[tid]);
  }

  // 1. G[t][s] = C_t . B_s and P[t][s] = dy_t . x_s at t = ty + 16 i, s =
  //    tx + 16 j; the masked decay, the scores and the sums of M and Z.
  float g[4][4] = {}, p[4][4] = {};
  for (int k = 0; k < T; ++k) {
    float cv[4], bv[4], yv[4], xv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      cv[i] = sc[(ty + 16 * i) * LD + k];
      yv[i] = sdy[(ty + 16 * i) * LD + k];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      bv[j] = sb[(tx + 16 * j) * LD + k];
      xv[j] = sx[(tx + 16 * j) * LD + k];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        g[i][j] += cv[i] * bv[j];
        p[i][j] += yv[i] * xv[j];
      }
  }
  __syncthreads();  // se, so written
  float da_part = 0.0f;  // sum M_ts (T_t - T_s) over this thread's pairs
  float colm[4] = {}, colz[4] = {};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = ty + 16 * i;
    float rowm = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int s = tx + 16 * j;
      const float l = s <= t ? expf(scum[t] - scum[s]) : 0.0f;  // masked before exp
      const float w = l * sdt[s];
      const float z = p[i][j] * g[i][j] * l;
      const float m = z * sdt[s];
      rowm += m;
      colm[j] += m;
      colz[j] += z;
      if (s <= t) da_part += m * (stt[t] - stt[s]);
      ssc[t * LD + s] = g[i][j] * w;
      p[i][j] *= w;  // the scores P L dt, kept for step 3
    }
    rowm = row_sum16(rowm);
    if (tx == 0) srow[t] = rowm;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    scolm[ty * Q + tx + 16 * j] = colm[j];
    scolz[ty * Q + tx + 16 * j] = colz[j];
  }
  __syncthreads();  // the G scores are in

  // 2. dx_intra[s][d] = sum_{t >= s} S[t][s] dy[t][d] (s = ty + 16 i, d =
  //    tx + 16 j), and vh[t][n] = sum_d dy[t][d] h[d][n] (t = ty + 16 i).
  float dx[4][4] = {}, vh[4][4] = {};
  for (int t = ty; t < Q; ++t) {
    float sv[4], yv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) sv[i] = ssc[t * LD + ty + 16 * i];
#pragma unroll
    for (int j = 0; j < 4; ++j) yv[j] = sdy[t * LD + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dx[i][j] += sv[i] * yv[j];
  }
  for (int d = 0; d < T; ++d) {
    float yv[4], hv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) yv[i] = sdy[(ty + 16 * i) * LD + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) hv[j] = shs[d * LD + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) vh[i][j] += yv[i] * hv[j];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // e_t dy_t.(h C_t) = e_t sum_n vh[t][n] C[t][n]
    const int t = ty + 16 * i;
    float ev = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) ev += vh[i][j] * sc[t * LD + tx + 16 * j];
    ev = row_sum16(ev) * se[t];
    if (tx == 0) sev[t] = ev;
  }
  __syncthreads();  // the G scores and h are read

  // 3. The P scores into the score tile; dH into the state tile, with
  //    <dH, h> on the way (each thread swaps the elements it owns).
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) ssc[(ty + 16 * i) * LD + tx + 16 * j] = p[i][j];
  float hdh = 0.0f;
  for (int i = tid; i < T * T; i += NT) {
    const int d = i / T, n = i % T;
    const float v = (d < dh && n < N) ? dhc[d * N + n] : 0.0f;
    hdh += shs[d * LD + n] * v;
    shs[d * LD + n] = v;
  }
  __syncthreads();

  // 4. dC[t][n] = sum_{s <= t} S[t][s] B[s][n] + e_t vh[t][n]: this head's
  //    share, to dcp (B, S, H, N).
  {
    float acc[4][4] = {};
    for (int s = 0; s < ty + 49; ++s) {  // s <= t for t up to ty + 48
      float sv[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = ssc[(ty + 16 * i) * LD + s];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = sb[s * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += sv[i] * bv[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = ty + 16 * i;
      if (t >= qv) continue;
      float* out = dcp + ((row0 + t) * H + h) * N;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = tx + 16 * j;
        if (n < N) out[n] = acc[i][j] + se[t] * vh[i][j];
      }
    }
  }
  // 5. dB[s][n] = sum_{t >= s} S[t][s] C[t][n] + o_s dt_s sum_d x[s][d]
  //    dH[d][n]: this head's share, to dbp.
  {
    float acc[4][4] = {}, xd[4][4] = {};
    for (int t = ty; t < Q; ++t) {
      float sv[4], cv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = ssc[t * LD + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) cv[j] = sc[t * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += sv[i] * cv[j];
    }
    for (int d = 0; d < T; ++d) {
      float xv[4], hv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) xv[i] = sx[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) hv[j] = shs[d * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) xd[i][j] += xv[i] * hv[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s = ty + 16 * i;
      if (s >= qv) continue;
      const float odt = so[s] * sdt[s];
      float* out = dbp + ((row0 + s) * H + h) * N;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = tx + 16 * j;
        if (n < N) out[n] = acc[i][j] + odt * xd[i][j];
      }
    }
  }
  // 6. u[s][d] = sum_n B[s][n] dH[d][n]; dx += o_s dt_s u; r_s = o_s x_s.u_s.
  {
    float u[4][4] = {};
    for (int n = 0; n < T; ++n) {
      float bv[4], hv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) bv[i] = sb[(ty + 16 * i) * LD + n];
#pragma unroll
      for (int j = 0; j < 4; ++j) hv[j] = shs[(tx + 16 * j) * LD + n];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) u[i][j] += bv[i] * hv[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s = ty + 16 * i;
      const float odt = so[s] * sdt[s];
      float xu = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) xu += sx[s * LD + tx + 16 * j] * u[i][j];
      xu = row_sum16(xu) * so[s];
      if (tx == 0) sr[s] = xu;
      if (s >= qv) continue;
      float* out = dxs + ((row0 + s) * H + h) * dh;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int d = tx + 16 * j;
        if (d < dh) out[d] = dx[i][j] + odt * u[i][j];
      }
    }
  }

  // 7. The row vectors: dcum, its sum from the end (dda), ddt, and this
  //    chunk's share of da, each in one fixed order.
  const float hdh_all = block_sum(hdh, red, tid);   // thread 0's
  const float da_pairs = block_sum(da_part, red, tid);
  if (tid < Q) {
    float cm_ = 0.0f, cz = 0.0f;
    for (int r = 0; r < 16; ++r) {
      cm_ += scolm[r * Q + tid];
      cz += scolz[r * Q + tid];
    }
    scolz[tid] = cz;  // row 0 of the partials now holds the column sums of Z
    sdcum[tid] = srow[tid] - cm_ + sev[tid] - sr[tid] * sdt[tid];
  }
  __syncthreads();
  if (tid == 0) {
    float rdt = 0.0f, part = 0.0f;
    for (int s = 0; s < Q; ++s) {
      rdt += sr[s] * sdt[s];
      part += sev[s] * stt[s] + sr[s] * sdt[s] * (stt[Q - 1] - stt[s]);
    }
    const float hl = el * hdh_all;
    sdcum[Q - 1] += hl + rdt;
    float run = 0.0f;
    for (int t = Q - 1; t >= 0; --t) {
      run += sdcum[t];
      sdcum[t] = run;
    }
    dap[seq * nc + c] = da_pairs + part + hl * stt[Q - 1];
  }
  __syncthreads();
  if (tid < qv) ddt[(row0 + tid) * H + h] = scolz[tid] + sr[tid] + sdcum[tid] * ah;
}

// (c) dbm / dcm [b][s][n] = sum over heads, in head order, of the partials.
__global__ void ssd_bwd_reduce_kernel(const float* __restrict__ dbp,
                                      const float* __restrict__ dcp, float* __restrict__ dbm,
                                      float* __restrict__ dcm, long long rows, int H, int N) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows * N) return;
  const long long r = i / N;
  const int n = (int)(i % N);
  const float* pb = dbp + r * H * N + n;
  const float* pc = dcp + r * H * N + n;
  float sb = 0.0f, sc = 0.0f;
  for (int h = 0; h < H; ++h) {
    sb += pb[(long long)h * N];
    sc += pc[(long long)h * N];
  }
  dbm[i] = sb;
  dcm[i] = sc;
}

// (d) da[h] = sum over batch rows, then chunks, in order, of the partials.
__global__ void ssd_bwd_da_kernel(const float* __restrict__ dap, float* __restrict__ da,
                                  int B, int H, int nc) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= H) return;
  float s = 0.0f;
  for (int b = 0; b < B; ++b)
    for (int c = 0; c < nc; ++c) s += dap[((long long)b * H + h) * nc + c];
  da[h] = s;
}

constexpr size_t STATES_SMEM = (2 * TILE + 3 * Q) * sizeof(float);
constexpr size_t CHUNK_SMEM = (6 * TILE + 10 * Q + 2 * 16 * Q + NT) * sizeof(float);

}  // namespace

// states and dstates: (B, H, nc, dh, N) f32 scratch; dbp, dcp: (B, S, H, N);
// dap: (B, H, nc).  Outputs dxs (B, S, H, dh), dbm, dcm (B, S, N), ddt (B, S,
// H), da (H,).  Returns cudaGetLastError() after the last launch.
extern "C" int seifer_ssd_scan_bwd(const void* xs, const void* bm, const void* cm,
                                   const void* dt, const void* a, const void* dy, void* dxs,
                                   void* dbm, void* dcm, void* ddt, void* da, void* states,
                                   void* dstates, void* dbp, void* dcp, void* dap, int B, int S,
                                   int H, int dh, int N, void* stream) {
  if (dh < 1 || dh > T || N < 1 || N > T || B < 1 || S < 1 || H < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int nc = (S + Q - 1) / Q;
  const float *xf = (const float*)xs, *bf = (const float*)bm, *cf = (const float*)cm;
  const float *tf = (const float*)dt, *af = (const float*)a, *yf = (const float*)dy;
  float *sf = (float*)states, *gf = (float*)dstates;
  cudaError_t err = cudaFuncSetAttribute(ssd_bwd_states_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)STATES_SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_bwd_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)CHUNK_SMEM);
  if (err != cudaSuccess) return (int)err;
  ssd_bwd_states_kernel<<<dim3((unsigned)H, (unsigned)B, 2), NT, STATES_SMEM, st>>>(
      xf, bf, cf, tf, af, yf, sf, gf, S, H, dh, N);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_bwd_chunk_kernel<<<dim3((unsigned)nc, (unsigned)H, (unsigned)B), NT, CHUNK_SMEM, st>>>(
      xf, bf, cf, tf, af, yf, sf, gf, (float*)dxs, (float*)ddt, (float*)dbp, (float*)dcp,
      (float*)dap, S, H, dh, N);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const long long rows = (long long)B * S;
  const long long n_out = rows * N;
  ssd_bwd_reduce_kernel<<<(unsigned)((n_out + 255) / 256), 256, 0, st>>>(
      (const float*)dbp, (const float*)dcp, (float*)dbm, (float*)dcm, rows, H, N);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_bwd_da_kernel<<<(unsigned)((H + 127) / 128), 128, 0, st>>>((const float*)dap, (float*)da,
                                                                   B, H, nc);
  return (int)cudaGetLastError();
}

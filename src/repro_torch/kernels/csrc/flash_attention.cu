// Flash-attention forward for Hopper (sm_90a): f32 in and out, products on
// the TF32 tensor cores under split precision (split_tf32.cuh).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// flash_attention_tpu (_fa_kernel): online softmax (m, l, acc) across kv
// tiles, causal and sliding-window masks, gemma2 logit softcap
// c*tanh(s/c), hd^-0.5 scaling, GQA (H = G*KH), fully dead tiles skipped,
// masked logits at NEG_INF = -1e30 and l clamped at 1e-30 as there.
//
// What bounds it on an H100, and what the design does about it: the work is
// 4*hd operations per live (query, key) pair against reading q, k, v and
// writing o once, so at the served shapes (S = 8192, hd = 128) it is bound
// by operations by two orders of magnitude.  The f32 pin (2e-5 against the
// plain version) rules out one TF32 pass (~9e-4 at softcap 50); split-TF32
// holds it at three tensor-core passes per product, so the least time is
// FLOPs * 3 / 495 TFLOP/s.  Route: mma.sync.m16n8k8 in FlashAttention-2
// form (wgmma would want V transposed in shared memory; later work).
//
// Head dims: 64, 80, 112, 128, 160 and 256 (every one the LM zoo's configs
// use), each a multiple of 16.
//
// One block of 4 warps owns 128 queries of one head (64 at hd > 128); each
// warp owns 32 query rows as two 16-row fragments (one at hd 256), so every
// K or V fragment it splits feeds two products, and keeps its S tile and O
// accumulator in mma fragments in registers, with m and l per row.  The
// block loops over 32-key tiles: K and V tiles arrive by cp.async into their
// own buffers, V of this tile while Q K^T runs and K of the next tile while
// P V runs.  Q is pre-scaled once into shared memory; Q, K, V and P are
// split into hi + lo in registers as their fragments are read.  Row strides
// pad Q and K to hd + 8 floats and V to hd + 4, so every fragment read is
// free of bank conflicts; at hd 128 a block takes 104 KB of shared memory
// and 255 registers a thread (about 350 bytes spilled), two blocks per SM.
// Every product sums at most 12 mma steps on the tensor cores before its
// fragment is added, in f32 on the FMA units, to S (per 32-wide slice of
// hd) or to O (per kv tile).  Tiles the causal or window mask leaves fully
// dead are never loaded; positional masks run only on tiles that cross a
// mask edge, and ragged sequence edges are masked (cp.async zero-fills), not
// padded.  Blocks walk query tiles from the last one, so the heaviest causal
// tiles start first.  q, k, v may be strided
// views (the fused q|k|v projection's slices): rows are read at the batch
// and sequence strides given, and each row's (heads, hd) block must be
// packed and 16-byte aligned.
//
// For training the kernel also writes each row's logsumexp, lse = m +
// log(max(l, 1e-30)) over the capped, scaled logits (natural log: the
// softmax runs in exp), into a (B, H, S) f32 tensor when lse is non-null --
// the residual the backward (flash_attention_bwd.cu) recomputes the
// probabilities from, as the JAX package's custom VJP keeps it.  Serving
// passes null.

#include <cuda_runtime.h>

#include "split_tf32.cuh"

namespace {

using split_tf32::cp_async16;
using split_tf32::cp_async_commit;
using split_tf32::cp_async_wait;
using split_tf32::mma;
using split_tf32::split;

constexpr int NW = 4, NT = NW * 32;  // 4 warps; each owns 16 * MT query rows
constexpr float NEG_INF = -1e30f;
constexpr int BK = 32;  // keys per kv tile

// MT 16-row fragments per warp: a K or V fragment, once split, feeds MT
// products.  Two at hd <= 128 (255 registers at hd 128, two blocks per SM);
// one above (hd 160, 256), where the O accumulator alone takes 80 or 128
// registers.
template <int HD>
struct Tile {
  static constexpr int MT = HD <= 128 ? 2 : 1, BQ = 16 * MT * NW;
};

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(Tile<HD>::BQ * (HD + 8) + BK * (HD + 8) + BK * (HD + 4));
}

// rows [k_lo, k_lo + BK) of one kv head into a tile of row stride LD
template <int HD, int LD>
__device__ __forceinline__ void load_tile(float* dst, const float* src, long long ss,
                                          int k_lo, int S, int tid) {
  constexpr int CH = HD / 4;  // 16-byte chunks per row
#pragma unroll 4
  for (int e = tid; e < BK * CH; e += NT) {
    const int r = e / CH, c = (e % CH) * 4, kp = k_lo + r;
    const bool in = kp < S;
    cp_async16(dst + r * LD + c, src + (long long)(in ? kp : 0) * ss + c, in ? 16 : 0);
  }
}

// S += Q K^T over hd columns [kc, kc + W): 3 split-TF32 mma per 8 columns
// into a fresh fragment, W / 8 * 3 <= 12 steps, then added to S in f32
template <int MT, int NKT, int QS, int W>
__device__ __forceinline__ void qk_slice(float (&sacc)[MT][NKT][4], const float* qrow,
                                         const float* krow, int kc) {
  float part[MT][NKT][4] = {};
#pragma unroll
  for (int kk = kc; kk < kc + W; kk += 8) {
    uint32_t ah[MT][4], al[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const float2 x0 = *reinterpret_cast<const float2*>(qrow + 16 * mt * QS + kk);
      const float2 x1 = *reinterpret_cast<const float2*>(qrow + (16 * mt + 8) * QS + kk);
      split(x0.x, ah[mt][0], al[mt][0]);
      split(x1.x, ah[mt][1], al[mt][1]);
      split(x0.y, ah[mt][2], al[mt][2]);
      split(x1.y, ah[mt][3], al[mt][3]);
    }
#pragma unroll
    for (int nt = 0; nt < NKT; ++nt) {
      const float2 kv = *reinterpret_cast<const float2*>(krow + nt * 8 * QS + kk);
      uint32_t bh0, bl0, bh1, bl1;
      split(kv.x, bh0, bl0);
      split(kv.y, bh1, bl1);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma(part[mt][nt], al[mt], bh0, bh1);
        mma(part[mt][nt], ah[mt], bl0, bl1);
        mma(part[mt][nt], ah[mt], bh0, bh1);
      }
    }
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NKT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[mt][nt][e] += part[mt][nt][e];
}

template <int HD>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int S,
                 int H, int G, long long q_sb, long long q_ss, long long k_sb,
                 long long k_ss, long long v_sb, long long v_ss, int causal,
                 int window, float softcap, float scale) {
  static_assert(HD % 16 == 0, "hd slices are 32 wide, the last one 16");
  constexpr int MT = Tile<HD>::MT, BQ = Tile<HD>::BQ;
  constexpr int QS = HD + 8, VS = HD + 4;
  constexpr int NKT = BK / 8, NDT = HD / 8;  // 8-key and 8-column fragments
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;          // [BQ][QS], pre-scaled
  float* Ks = Qs + BQ * QS;  // [BK][QS]
  float* Vs = Ks + BK * QS;  // [BK][VS]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.x % H, b = blockIdx.x / H, kvh = h / G;
  const int q_lo = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest causal tiles first
  const float inv_cap = 1.0f / softcap;
  const int nk = (S + BK - 1) / BK;
  const int j_end = causal ? min(nk, (q_lo + BQ - 1) / BK + 1) : nk;
  int j_begin = 0;
  if (window > 0 && q_lo - window + 1 > 0) j_begin = (q_lo - window + 1) / BK;
  const float* kbase = k + b * k_sb + (long long)kvh * HD;
  const float* vbase = v + b * v_sb + (long long)kvh * HD;

  load_tile<HD, QS>(Ks, kbase, k_ss, j_begin * BK, S, tid);
  cp_async_commit();
  for (int e = tid; e < BQ * HD / 4; e += NT) {
    const int r = e / (HD / 4), c = (e % (HD / 4)) * 4, qp = q_lo + r;
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (qp < S)
      x = *reinterpret_cast<const float4*>(q + b * q_sb + qp * q_ss + (long long)h * HD + c);
    *reinterpret_cast<float4*>(&Qs[r * QS + c]) =
        make_float4(x.x * scale, x.y * scale, x.z * scale, x.w * scale);
  }

  // fragment mt of this warp holds rows r0 + 16 mt (c0, c1) and + 8 (c2, c3)
  const int r0 = warp * 16 * MT + g;
  float m[MT][2], l[MT][2], oacc[MT][NDT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    m[mt][0] = m[mt][1] = NEG_INF;
    l[mt][0] = l[mt][1] = 0.0f;
#pragma unroll
    for (int dt = 0; dt < NDT; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) oacc[mt][dt][e] = 0.0f;
  }

  for (int j = j_begin; j < j_end; ++j) {
    const int k_lo = j * BK;
    load_tile<HD, VS>(Vs, vbase, v_ss, k_lo, S, tid);
    cp_async_commit();
    cp_async_wait<1>();  // this tile's K has landed (and, first time, Q is stored)
    __syncthreads();

    // S = Q K^T: lane (g, t) reads q and k at hd kk + 2t and kk + 2t + 1.
    // Each 32-wide slice of hd is summed on the tensor cores in a fresh
    // fragment and added to S on the FMA units (see P V below); a head dim
    // that is not a multiple of 32 (80, 112) ends in one 16-wide slice.
    float sacc[MT][NKT][4] = {};
    const float* qrow = Qs + r0 * QS + 2 * t;
    const float* krow = Ks + g * QS + 2 * t;
#pragma unroll 1
    for (int kc = 0; kc < HD - HD % 32; kc += 32)
      qk_slice<MT, NKT, QS, 32>(sacc, qrow, krow, kc);
    if constexpr (HD % 32 != 0) qk_slice<MT, NKT, QS, HD % 32>(sacc, qrow, krow, HD - HD % 32);

    // online softmax over this tile
    const bool edge = k_lo + BK > S || (causal && k_lo + BK - 1 > q_lo) ||
                      (window > 0 && q_lo + BQ - 1 - k_lo >= window);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int qp0 = q_lo + r0 + 16 * mt;
      float rmax[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int nt = 0; nt < NKT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float s = sacc[mt][nt][e];
          if (softcap > 0.0f) s = softcap * tanhf(s * inv_cap);
          if (edge) {
            const int kp = k_lo + nt * 8 + 2 * t + (e & 1), qp = qp0 + (e >> 1) * 8;
            bool ok = kp < S;
            if (causal) ok = ok && qp >= kp;
            if (window > 0) ok = ok && (qp - kp) < window;
            s = ok ? s : NEG_INF;
            rmax[e >> 1] = fmaxf(rmax[e >> 1], s);
            // a ragged key column is not a key at all (the TPU kernel never
            // sees one): it must not add exp(0) to a row that is all NEG_INF
            if (kp >= S) s = __int_as_float(0xff800000);  // -inf
          } else {
            rmax[e >> 1] = fmaxf(rmax[e >> 1], s);
          }
          sacc[mt][nt][e] = s;
        }
      float corr[2], rsum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        rmax[i] = fmaxf(rmax[i], __shfl_xor_sync(0xffffffffu, rmax[i], 1));
        rmax[i] = fmaxf(rmax[i], __shfl_xor_sync(0xffffffffu, rmax[i], 2));
        const float m_new = fmaxf(m[mt][i], rmax[i]);
        corr[i] = expf(m[mt][i] - m_new);
        m[mt][i] = m_new;
      }
#pragma unroll
      for (int nt = 0; nt < NKT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = expf(sacc[mt][nt][e] - m[mt][e >> 1]);
          sacc[mt][nt][e] = p;
          rsum[e >> 1] += p;
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        rsum[i] += __shfl_xor_sync(0xffffffffu, rsum[i], 1);
        rsum[i] += __shfl_xor_sync(0xffffffffu, rsum[i], 2);
        l[mt][i] = l[mt][i] * corr[i] + rsum[i];
      }
#pragma unroll
      for (int dt = 0; dt < NDT; ++dt)
#pragma unroll
        for (int e = 0; e < 4; ++e) oacc[mt][dt][e] *= corr[e >> 1];
    }

    __syncthreads();  // every warp is done with Ks: the next K may land there
    if (j + 1 < j_end) load_tile<HD, QS>(Ks, kbase, k_ss, k_lo + BK, S, tid);
    cp_async_commit();  // (empty on the last tile: keeps the group count)
    cp_async_wait<1>();  // this tile's V has landed
    __syncthreads();

    // O += P V.  P's C fragment is the A fragment of keys relabelled
    // (column t = key 2t, column t + 4 = key 2t + 1): a = (c0, c2, c1, c3).
    // Each tile's P V is summed on the tensor cores in a fresh fragment and
    // added to O on the FMA units: the tensor cores' own accumulation loses
    // low bits at every step, and fed O itself, 3 S / 8 steps of it, the
    // error grew with S, to ten times the split's own at S = 8192
    // (chip_smoke.py --profile prints that budget).
    uint32_t ph[MT][NKT][4], pl[MT][NKT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int kt = 0; kt < NKT; ++kt) {
        split(sacc[mt][kt][0], ph[mt][kt][0], pl[mt][kt][0]);
        split(sacc[mt][kt][2], ph[mt][kt][1], pl[mt][kt][1]);
        split(sacc[mt][kt][1], ph[mt][kt][2], pl[mt][kt][2]);
        split(sacc[mt][kt][3], ph[mt][kt][3], pl[mt][kt][3]);
      }
    const float* vrow = Vs + 2 * t * VS + g;
#pragma unroll
    for (int dt = 0; dt < NDT; ++dt) {
      float part[MT][4] = {};
#pragma unroll
      for (int kt = 0; kt < NKT; ++kt) {
        uint32_t bh0, bl0, bh1, bl1;
        split(vrow[kt * 8 * VS + dt * 8], bh0, bl0);
        split(vrow[(kt * 8 + 1) * VS + dt * 8], bh1, bl1);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma(part[mt], pl[mt][kt], bh0, bh1);
          mma(part[mt], ph[mt][kt], bl0, bl1);
          mma(part[mt], ph[mt][kt], bh0, bh1);
        }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) oacc[mt][dt][e] += part[mt][e];
    }
    __syncthreads();  // every warp is done with Vs: the next V may land there
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qp = q_lo + r0 + 16 * mt + 8 * i;
      if (qp >= S) continue;
      const float inv = 1.0f / fmaxf(l[mt][i], 1e-30f);
      if (lse != nullptr && t == 0)
        lse[((long long)b * H + h) * S + qp] = m[mt][i] + logf(fmaxf(l[mt][i], 1e-30f));
      float* orow = o + (((long long)b * S + qp) * H + h) * HD + 2 * t;
#pragma unroll
      for (int dt = 0; dt < NDT; ++dt)
        *reinterpret_cast<float2*>(&orow[dt * 8]) =
            make_float2(oacc[mt][dt][2 * i] * inv, oacc[mt][dt][2 * i + 1] * inv);
    }
}

template <int HD>
int launch(const float* q, const float* k, const float* v, float* o, float* lse, int B,
           int S, int H, int KH, long long q_sb, long long q_ss, long long k_sb,
           long long k_ss, long long v_sb, long long v_ss, int causal,
           int window, float softcap, float scale, cudaStream_t st) {
  const size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(B * H), (unsigned)((S + Tile<HD>::BQ - 1) / Tile<HD>::BQ));
  flash_fwd_kernel<HD><<<grid, NT, smem, st>>>(q, k, v, o, lse, S, H, H / KH, q_sb,
                                               q_ss, k_sb, k_ss, v_sb, v_ss,
                                               causal, window, softcap, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int seifer_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse, int B, int S, int H,
    int KH, int hd, long long q_sb, long long q_ss, long long k_sb,
    long long k_ss, long long v_sb, long long v_ss, int causal, int window,
    float softcap, float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const float *qf = (const float*)q, *kf = (const float*)k, *vf = (const float*)v;
  float *of = (float*)o, *lf = (float*)lse;
  switch (hd) {
#define SEIFER_FLASH_CASE(D)                                                     \
  case D:                                                                        \
    return launch<D>(qf, kf, vf, of, lf, B, S, H, KH, q_sb, q_ss, k_sb, k_ss, v_sb, \
                     v_ss, causal, window, softcap, scale, st);
    SEIFER_FLASH_CASE(64)
    SEIFER_FLASH_CASE(80)
    SEIFER_FLASH_CASE(112)
    SEIFER_FLASH_CASE(128)
    SEIFER_FLASH_CASE(160)
    SEIFER_FLASH_CASE(256)
#undef SEIFER_FLASH_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Flash-attention forward for Hopper (sm_90a), f32 throughout.
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
// by operations by two orders of magnitude.  It computes in f32 on the FMA
// units (the f32 pin is 2e-5 against the plain version, so no TF32 or
// bf16 tensor cores here; wgmma is later work).  The TPU grid's sequential
// kv dimension, with m/l/acc carried in VMEM scratch, becomes a loop over
// kv tiles inside one block: one block per (query tile of 64, head,
// batch); the block keeps its query tile (pre-scaled, transposed) in shared
// memory for the whole loop, streams 64-key tiles of k (transposed) and v
// through shared memory, and keeps m, l and its 4 x hd/16 slice of acc in
// registers, so neither the logits nor the probabilities reach device
// memory.  Tiles the causal or window mask leaves fully dead are skipped
// before they are loaded; positional masks apply inside a live tile, and
// ragged sequence edges are masked, not padded.  Each thread owns 4 query
// rows x 4 keys of a logit tile; a row's 64 logits live on the 16 lanes of
// one half-warp, so row max and row sum are shuffle reductions.  q, k, v
// may be strided views (the fused q|k|v projection's slices): the kernel
// reads rows at the batch and sequence strides it is given and needs only
// the (heads, hd) block of each row packed.

#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64, BK = 64, NT = 256;
// row strides of the k-major K tile and the probability tile: 4 floats of
// padding keep float4 reads aligned and cut the transposing stores' bank
// conflicts from 32-way to 4-way
constexpr int KS = BK + 4, PS = BQ + 4;
constexpr float NEG_INF = -1e30f;

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(HD * BQ + HD * KS + BK * HD);
}

template <int HD>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int S,
                 int H, int G, long long q_sb, long long q_ss, long long k_sb,
                 long long k_ss, long long v_sb, long long v_ss, int causal,
                 int window, float softcap, float scale) {
  constexpr int NC = HD / 64;  // 4-column groups per thread: cols g*64 + tx*4
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;              // [HD][BQ], pre-scaled
  float* Kt = Qt + HD * BQ;      // [HD][KS]
  float* Vs = Kt + HD * KS;      // [BK][HD]
  float* Pt = Kt;                // [BK][PS]: reuses Kt once the logits are in registers
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / G;
  const int q_lo = blockIdx.x * BQ;

  for (int e = tid; e < BQ * HD; e += NT) {
    const int r = e / HD, c = e % HD, qp = q_lo + r;
    Qt[c * BQ + r] = qp < S ? q[b * q_sb + qp * q_ss + (long long)h * HD + c] * scale : 0.0f;
  }

  float m[4], l[4], acc[4][NC * 4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC * 4; ++c) acc[i][c] = 0.0f;
  }

  const int nk = (S + BK - 1) / BK;
  for (int j = 0; j < nk; ++j) {
    const int k_lo = j * BK;
    if (causal && k_lo > q_lo + BQ - 1) break;  // every later tile is dead too
    if (window > 0 && q_lo - (k_lo + BK - 1) >= window) continue;
    __syncthreads();  // the previous tile's Pt (in Kt) and Vs are consumed
    for (int e = tid; e < BK * HD; e += NT) {
      const int r = e / HD, c = e % HD, kp = k_lo + r;
      const bool in = kp < S;
      Kt[c * KS + r] = in ? k[b * k_sb + kp * k_ss + (long long)kvh * HD + c] : 0.0f;
      Vs[r * HD + c] = in ? v[b * v_sb + kp * v_ss + (long long)kvh * HD + c] : 0.0f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) sc[i][jj] = 0.0f;
#pragma unroll 8
    for (int c = 0; c < HD; ++c) {
      const float4 a = *reinterpret_cast<const float4*>(&Qt[c * BQ + ty * 4]);
      const float4 bb = *reinterpret_cast<const float4*>(&Kt[c * KS + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {bb.x, bb.y, bb.z, bb.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) sc[i][jj] = fmaf(av[i], bv[jj], sc[i][jj]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q_lo + ty * 4 + i;
      float rmax = NEG_INF;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int kp = k_lo + tx * 4 + jj;
        float s = sc[i][jj];
        if (softcap > 0.0f) s = softcap * tanhf(s / softcap);
        bool ok = kp < S;
        if (causal) ok = ok && qp >= kp;
        if (window > 0) ok = ok && (qp - kp) < window;
        s = ok ? s : NEG_INF;
        // a ragged key column is not a key at all (the TPU kernel never
        // sees one): it must not add exp(0) to a row that is all NEG_INF
        sc[i][jj] = kp < S ? s : __int_as_float(0xff800000);  // -inf
        rmax = fmaxf(rmax, s);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_new = fmaxf(m[i], rmax);
      float rsum = 0.0f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float p = expf(sc[i][jj] - m_new);
        sc[i][jj] = p;
        rsum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + rsum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC * 4; ++c) acc[i][c] *= corr;
    }
    __syncthreads();  // every thread is done reading Kt: P may overwrite it
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
      *reinterpret_cast<float4*>(&Pt[(tx * 4 + jj) * PS + ty * 4]) =
          make_float4(sc[0][jj], sc[1][jj], sc[2][jj], sc[3][jj]);
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      const float4 p4 = *reinterpret_cast<const float4*>(&Pt[kk * PS + ty * 4]);
      const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
      for (int g = 0; g < NC; ++g) {
        const float4 v4 = *reinterpret_cast<const float4*>(&Vs[kk * HD + g * 64 + tx * 4]);
        const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[i][g * 4 + e] = fmaf(pv[i], vv[e], acc[i][g * 4 + e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q_lo + ty * 4 + i;
    if (qp >= S) continue;
    const float inv = 1.0f / fmaxf(l[i], 1e-30f);
    float* orow = o + (((long long)b * S + qp) * H + h) * HD;
#pragma unroll
    for (int g = 0; g < NC; ++g) {
      const float4 r = make_float4(acc[i][g * 4] * inv, acc[i][g * 4 + 1] * inv,
                                   acc[i][g * 4 + 2] * inv, acc[i][g * 4 + 3] * inv);
      *reinterpret_cast<float4*>(&orow[g * 64 + tx * 4]) = r;
    }
  }
}

template <int HD>
int launch(const float* q, const float* k, const float* v, float* o, int B,
           int S, int H, int KH, long long q_sb, long long q_ss, long long k_sb,
           long long k_ss, long long v_sb, long long v_ss, int causal,
           int window, float softcap, float scale, cudaStream_t st) {
  const size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((S + BQ - 1) / BQ), (unsigned)H, (unsigned)B);
  flash_fwd_kernel<HD><<<grid, NT, smem, st>>>(q, k, v, o, S, H, H / KH, q_sb,
                                               q_ss, k_sb, k_ss, v_sb, v_ss,
                                               causal, window, softcap, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int seifer_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int B, int S, int H,
    int KH, int hd, long long q_sb, long long q_ss, long long k_sb,
    long long k_ss, long long v_sb, long long v_ss, int causal, int window,
    float softcap, float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const float *qf = (const float*)q, *kf = (const float*)k, *vf = (const float*)v;
  float* of = (float*)o;
  switch (hd) {
    case 64:
      return launch<64>(qf, kf, vf, of, B, S, H, KH, q_sb, q_ss, k_sb, k_ss, v_sb,
                        v_ss, causal, window, softcap, scale, st);
    case 128:
      return launch<128>(qf, kf, vf, of, B, S, H, KH, q_sb, q_ss, k_sb, k_ss, v_sb,
                         v_ss, causal, window, softcap, scale, st);
    case 256:
      return launch<256>(qf, kf, vf, of, B, S, H, KH, q_sb, q_ss, k_sb, k_ss, v_sb,
                         v_ss, causal, window, softcap, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

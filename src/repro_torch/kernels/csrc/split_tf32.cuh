// Split-TF32 products on Hopper's tensor cores (mma.sync m16n8k8), shared by
// the flash-attention (forward and backward), SSD-scan and fused int8-receive
// kernels, with the cp.async helpers they stage tiles by.
//
// A TF32 operand keeps 10 explicit mantissa bits, so one pass of f32 data
// through the tensor cores is about 1e-3 relative: over the port's f32 pins.
// Writing x = hi + lo with hi = tf32_rna(x) and lo = tf32_rna(x - hi) keeps
// 21 bits of x; a product a.b is then taken as a_lo.b_hi + a_hi.b_lo +
// a_hi.b_hi (small terms first), each accumulated in f32, and a_lo.b_lo
// (about 2^-22 of the product) is dropped.  An operand that is exact in TF32
// (an int8 code) needs no lo, and its product costs two passes.
//
// Fragment layout of m16n8k8 (PTX ISA, lane = 4 g + t): A (16 x 8, row) a0
// (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); B (8 x 8, col)
// b0 (t, g), b1 (t + 4, g); C (16 x 8) c0 (g, 2t), c1 (g, 2t + 1), c2
// (g + 8, 2t), c3 (g + 8, 2t + 1).  The sum over k does not care about the
// order of k, so both kernels relabel k within each group of 8: A's column t
// is k = 2t and column t + 4 is k = 2t + 1 (B's rows alike).  A lane then
// reads two neighbouring k of one row, and a C fragment of probabilities
// feeds the next product as an A fragment with no shuffles.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace split_tf32 {

// x rounded to TF32 (nearest, ties away), as the f32 bits the tensor core
// reads: half of the dropped range added to the magnitude bits, then the
// low 13 bits cleared -- what cvt.rna.tf32.f32 computes for finite x, in
// two integer instructions (the cvt compiles to four: it also tests for
// inf and NaN).  lo below is then the exact remainder of what the hardware
// multiplies.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// x as hi + lo in two instructions: hi = x with its low 13 bits cleared
// (truncated to TF32), lo = x - hi, exact in f32 and given to the tensor core
// as it is, which reads its top 10 mantissa bits: x within 2^-20.
__device__ __forceinline__ void split_trunc(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// x as hi + lo on the f32 pipe alone (Veltkamp's split, four instructions,
// none of them on the integer pipe, which has half the f32 pipe's lanes):
// c = x (2^13 + 1), hi = c - (c - x) is x rounded to 11 significant bits --
// exact in TF32 -- and lo = x - hi exactly, of which the tensor core reads
// the top 11 bits: x within 2^-23.  The _rn intrinsics keep nvcc from
// contracting the steps into FMAs.  |x| must stay below 2^115 (c finite).
__device__ __forceinline__ void split_fp(float x, uint32_t& hi, uint32_t& lo) {
  const float c = __fmul_rn(x, 8193.0f);
  const float h = __fsub_rn(c, __fsub_rn(c, x));
  hi = __float_as_uint(h);
  lo = __float_as_uint(__fsub_rn(x, h));
}

// c (16 x 8, f32) += a (16 x 8, tf32) . b (8 x 8, tf32)
__device__ __forceinline__ void mma(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16-byte asynchronous copy global -> shared; the bytes past src_bytes
// (0 or 16) are zero-filled, so a ragged row is masked, not read.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s), "l"(gmem),
               "r"(src_bytes)
               : "memory");
}

// 4-byte asynchronous copy global -> shared, for rows that are not 16-byte
// aligned; zero-filled when src_bytes is 0.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, int src_bytes) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(s), "l"(gmem),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// wait until at most n of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

}  // namespace split_tf32

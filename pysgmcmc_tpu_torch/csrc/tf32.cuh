// f32 products on the tensor cores ("3xTF32"), shared by the SVGD transport
// (svgd_streaming.cu) and the fused body's products (fused_body.cuh).
//
// mma.sync m16n8k8 multiplies TF32 operands (an f32 with its low 13
// mantissa bits dropped) and accumulates in f32.  Every f32 operand a is
// split into a TF32 high part and a low part, a = a_hi + a_lo (see split),
// and a b is taken as a_lo b_hi + a_hi b_lo + a_hi b_hi (the dropped a_lo
// b_lo is 2^-22 of a b): f32 accuracy at three tensor-core passes.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo: hi the TF32 value nearest x, lo = x - hi (exact in f32),
// whose low 13 bits the tensor core drops (2^-22 of x; rounding lo to TF32
// as well costs a conversion a value and gains no accuracy that the checks
// resolve)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// x = hi + lo as split() takes it (hi the TF32 value nearest x, ties away
// from zero; lo = x - hi, exact), in integer form: cvt.rna.tf32.f32
// compiles to the same rounding behind a guard for infinities and NaN, five
// instructions a value where this takes three.  For finite x (a non-finite
// operand makes a non-finite product either way).
__device__ __forceinline__ void split_finite(float x, uint32_t& hi,
                                             uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// c += a b on the tensor cores (no side effects: the compiler may schedule
// it among the others).  Fragments of the m16n8k8 row.col layout, for lane
// l = 4 g + t: a = A(g, t), A(g + 8, t), A(g, t + 4), A(g + 8, t + 4); b =
// B(t, g), B(t + 4, g); c = C(g, 2 t), C(g, 2 t + 1), C(g + 8, 2 t),
// C(g + 8, 2 t + 1).
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

}  // namespace

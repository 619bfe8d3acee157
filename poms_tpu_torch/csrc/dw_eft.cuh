// Error-free transformations and double-word f32 arithmetic, shared by the
// double-word kernels (kron_apply_dw.cu, dw_reduce.cu, dw_update.cu).
//
// A double-word value is a pair of floats (h, l), |l| <= ulp(h)/2, whose sum
// carries ~49 bits (Joldes, Muller & Popescu, ACM TOMS 2017).  Every add and
// multiply is an intrinsic that the compiler never contracts into an FMA, so
// each function here has one answer: the one the plain PyTorch toolbox
// (ops/twofloat.py) computes elementwise.  two_prod is p = fl(a b),
// e = fma(a, b, -p): the toolbox rounds the same pair from the exact f64
// product.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace dwf {

struct dw {
  float h, l;
};

__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}

// Knuth: s + e == a + b exactly
__device__ __forceinline__ dw two_sum(float a, float b) {
  const float s = add(a, b);
  const float bb = sub(s, a);
  return {s, add(sub(a, sub(s, bb)), sub(b, bb))};
}

// Dekker (|a| >= |b|): s + e == a + b exactly
__device__ __forceinline__ dw fast_two_sum(float a, float b) {
  const float s = add(a, b);
  return {s, sub(b, sub(s, a))};
}

// p + e == a b exactly
__device__ __forceinline__ dw two_prod(float a, float b) {
  const float p = mul(a, b);
  return {p, __fmaf_rn(a, b, -p)};
}

// AccurateDWPlusDW
__device__ __forceinline__ dw dw_add(dw x, dw y) {
  const dw s = two_sum(x.h, y.h);
  const dw t = two_sum(x.l, y.l);
  const float c = add(s.l, t.h);
  const dw v = fast_two_sum(s.h, c);
  const float w = add(t.l, v.l);
  return fast_two_sum(v.h, w);
}

// DWTimesDW
__device__ __forceinline__ dw dw_mul(dw x, dw y) {
  const dw p = two_prod(x.h, y.h);
  const float t = add(mul(x.h, y.l), mul(x.l, y.h));
  return fast_two_sum(p.h, add(p.l, t));
}

__device__ __forceinline__ dw dw_neg(dw x) { return {-x.h, -x.l}; }

// f64 -> (h, l): h = f32(x) rounded to nearest, l = f32(x - h), as
// ops/twofloat.py::split_f64
__device__ __forceinline__ dw split_f64(double x) {
  const float h = __double2float_rn(x);
  return {h, __double2float_rn(__dsub_rn(x, (double)h))};
}

__device__ __forceinline__ double merge_f64(dw x) {
  return __dadd_rn((double)x.h, (double)x.l);
}

}  // namespace dwf

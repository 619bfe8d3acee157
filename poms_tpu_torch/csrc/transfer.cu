// K7: one axis of a banded tensor-product transfer (restriction or
// prolongation),
//   y[o, i, j] = sum_t w[i, t] * x[o, c0[i] + t, j]   (+ addend[o, i, j]),
// the field seen as (outer, n_in, inner) -> (outer, n_out, inner).
//
// Replaces poms_tpu/ops/transfer.py::apply_transfer_axis (no Pallas
// original: XLA fuses the W gathers, multiplies and adds of an axis into one
// loop there; eager PyTorch runs 3 W - 1 kernels an axis).
//
// What bounds it on an H100: the bytes at the fine levels (129^3 -> 65^3
// reads 8.6 MB and writes 1.1 MB: 2.9 us at 3.35 TB/s), the launch itself
// below that.  One launch an axis keeps the kernel simple; the intermediate
// fields of a d-D transfer pass through device memory (L2 holds them from
// 65^3 down).
//
// Design: one thread an output value in a grid-stride loop, neighbouring
// threads on neighbouring j (or, on the last axis, neighbouring i).  The taps
// are added in the plain version's order (t = 0 first) with multiplies and
// adds that the compiler may not contract, so the result equals
// ops/transfer.py::apply_transfer_axis bit for bit.  The optional addend is
// the prolongation's epilogue x + P x_c, added last.
//
// Types: f32, f64 and bf16.  In bf16 the weights, the field, the addend and
// the result are __nv_bfloat16; each product and the W-tap sum are f32 in the
// same order and uncontracted, the addend is added in f32, and the value is
// rounded once on the store.  The field between two axes' launches is bf16.
// The plain version does the same, so the bits agree in bf16 as well.

#include <cuda_runtime.h>
#include <stdint.h>

#include "storage.cuh"

namespace {

using io::Acc;
using io::store;
using io::up;

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double mul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ double add(double a, double b) {
  return __dadd_rn(a, b);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
transfer_axis_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     const int64_t* __restrict__ c0, const T* addend, T* y,
                     long long outer, int n_in, int n_out, long long inner,
                     int W) {
  const long long total = outer * n_out * inner;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long e = (long long)blockIdx.x * kThreads + threadIdx.x; e < total;
       e += stride) {
    const long long j = e % inner;
    const long long oi = e / inner;
    const int i = (int)(oi % n_out);
    const long long o = oi / n_out;
    const T* src = x + (o * n_in + c0[i]) * inner + j;
    const T* wi = w + (long long)i * W;
    typename Acc<T>::type acc = mul(up(wi[0]), up(src[0]));
    for (int t = 1; t < W; ++t)
      acc = add(acc, mul(up(wi[t]), up(src[t * inner])));
    store(y + e, addend != nullptr ? add(up(addend[e]), acc) : acc);
  }
}

template <typename T>
int launch(const void* x, const void* w, const int64_t* c0, const void* addend,
           void* y, long long outer, int n_in, int n_out, long long inner,
           int W, cudaStream_t st) {
  const long long total = outer * n_out * inner;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  transfer_axis_kernel<T><<<(int)blocks, kThreads, 0, st>>>(
      (const T*)x, (const T*)w, c0, (const T*)addend, (T*)y, outer, n_in,
      n_out, inner, W);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x: (outer, n_in, inner) contiguous; w: (n_out, W); c0: (n_out,) int64 with
// c0[i] + W <= n_in; addend (or null) and y: (outer, n_out, inner);
// dtype_code: 0 float, 1 double, 2 bfloat16 (x, w, addend and y alike).
int transfer_axis(const void* x, const void* w, const int64_t* c0,
                  const void* addend, void* y, long long outer, int n_in,
                  int n_out, long long inner, int W, int dtype_code,
                  void* stream) {
  if (x == nullptr || w == nullptr || c0 == nullptr || y == nullptr ||
      outer < 1 || n_in < 1 || n_out < 1 || inner < 1 || W < 1 || W > n_in)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (dtype_code) {  // ops/transfer.py::_DTYPE_CODES
    case 0:
      return launch<float>(x, w, c0, addend, y, outer, n_in, n_out, inner, W,
                           st);
    case 1:
      return launch<double>(x, w, c0, addend, y, outer, n_in, n_out, inner, W,
                            st);
    case 2:
      return launch<__nv_bfloat16>(x, w, c0, addend, y, outer, n_in, n_out,
                                   inner, W, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* transfer_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

// Storage types and arithmetic types of the kernels that take bf16.
//
// f32 and f64 fields are computed in their own type.  A bf16 field is stored
// as __nv_bfloat16 and computed in f32: Acc<T>::type is the arithmetic type of
// storage type T, up() converts a stored value (exactly), store() rounds a
// result to the storage type (to nearest even) as it is written, which is the
// one rounding a bf16 kernel makes per output value.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace io {

template <typename T> struct Acc { using type = T; };
template <> struct Acc<__nv_bfloat16> { using type = float; };

__device__ __forceinline__ float up(float v) { return v; }
__device__ __forceinline__ double up(double v) { return v; }
__device__ __forceinline__ float up(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(double* p, double v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

}  // namespace io

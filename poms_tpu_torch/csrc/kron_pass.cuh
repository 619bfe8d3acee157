// The one-axis pass skeleton of the run-time Kronecker-sum kernels K1r
// (kron_apply.cu) and K5r (kron_apply_dw.cu).
//
// A run-time kernel contracts one axis at a time, as the JAX reference's
// residual_kron_df does (poms_tpu/ops/twofloat.py::_apply_band_1d_axis_df):
//   pass A, axis 2: the field x -> the distinct axis-2 partials u (scratch);
//   pass B, axis 1: u -> the axis-1 partials (K1r: their pre-summed
//                   combinations, K5r: each v) (scratch);
//   pass C, axis 0: the pass-B partials -> the mode's outputs.
// A block stages its input tile in shared memory with cp.async (one element
// a copy: any strides, a zero-filling copy where the index rule gives a
// ghost) and the band rows it needs, computes, and writes its outputs to
// device memory.  No pass recomputes another's work and none keeps a ring:
// a pass's halo costs loads along its own axis, not arithmetic.  Zero ghosts
// and the periodic wrap are index rules on every axis (kron::resolve).
//
// Pass A tiles (axis 2 along the lanes, coalesced): TL columns of the row
// and ROWS_A rows (a row is one (i, j) of the field) a thread, the window of
// each row TL + 2P wide.  Passes B and C (axis 1 or 0, strided): 32 columns
// a warp (lanes along axis 2, so every load and store is coalesced), the
// warps stacked along the contracted axis, a thread owning R consecutive
// outputs along it; the tile is the warps' outputs plus 2P halo rows.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "kron_march.cuh"

namespace kpass {

constexpr int kLanes = 32;      // columns of a strided pass's tile
constexpr int kMaxWarps = 8;    // warps of a block

// one element of a staged tile: an asynchronous copy where the storage and
// arithmetic types are the same (a zero-filling one for a ghost), else a
// load converted on the way (bf16: cp.async copies 4, 8 or 16 bytes only)
template <typename T, typename IO>
__device__ __forceinline__ void stage(T* dst, const IO* base, int64_t off) {
  if constexpr (sizeof(IO) == sizeof(T)) {
    kron::cp_async_zfill<sizeof(T)>(dst, base + (off < 0 ? 0 : off),
                                    off >= 0);
  } else {
    *dst = off >= 0 ? io::up(base[off]) : T(0);
  }
}

// the tile of a strided pass: rows a0 - P .. a0 + rows - P - 1 of the
// contracted axis (n_a long, `per` wrapped, element stride sa) and columns
// l0 .. l0 + 31 of axis 2 (n2 long, contiguous), of the field at `base`,
// into dst[row * 32 + lane]: a warp a row at a time, a lane a column
template <typename T>
__device__ __forceinline__ void stage_strided(T* dst, const T* base,
                                              int64_t sa, int n_a, int per,
                                              int a0, int P, int rows, int l0,
                                              int n2) {
  const int lane = threadIdx.x % kLanes, l = l0 + lane;
  for (int r = threadIdx.x / kLanes; r < rows; r += blockDim.x / kLanes) {
    const int g = kron::resolve(a0 - P + r, n_a, per);
    stage<T, T>(dst + r * kLanes + lane, base,
                (g < 0 || l >= n2) ? -1 : g * sa + l);
  }
}

// a block's slice of a band table the host laid out as the block's shared
// memory holds it (n values, a multiple of 16 bytes, 16-byte aligned at
// both ends), by 16-byte asynchronous copies
template <typename T>
__device__ __forceinline__ void copy_table(T* dst, const T* src, int n) {
  constexpr int V = 16 / sizeof(T);
  for (int e = threadIdx.x * V; e < n; e += blockDim.x * V)
    kron::cp_async_zfill<16>(dst + e, src + e, true);
}

// cudaFuncSetAttribute where a launch needs more than 48 KB of shared memory
template <typename K>
__host__ inline cudaError_t allow_smem(K fn, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) cudaGetLastError();  // or the next launch reports it
  return err;
}

}  // namespace kpass

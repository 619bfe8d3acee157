// The marching skeleton shared by the Kronecker-sum kernels (kron_apply.cu,
// kron_apply_dw.cu).
//
// A block owns a T1 x T2 column of the (axis 1, axis 2) grid and walks the
// planes of axis 0.  Per incoming plane it stages the column's halo window
// ((T1 + 2P) x (T2 + 2P) values) in shared memory with cp.async, in a ring of
// kStages buffers: a plane's copy is started kStages - 1 steps before it is
// used, because one step of arithmetic is shorter than a trip to device
// memory.  The field is read unpadded: zero ghosts and the periodic wrap are
// index rules here (an out-of-range source becomes a zero-filling copy),
// worked out once per block into a table of in-plane source offsets.
//
// Threads are numbered row-major over the tile, so any T2 gives contiguous
// shared-memory rows and the host may pick tiles that divide a 2^k+1 grid
// evenly.
//
// A bf16 field cannot take this route: cp.async copies 4, 8 or 16 bytes,
// never 2, and the rows of a 2^k+1 field in bf16 are only 2-byte aligned, so
// pairs cannot be copied either.  load_window() then loads the values with
// plain loads (kLoadBatch of them asked for before any is stored, so that
// their trips to memory overlap), converts them and stores f32 into the same
// window; the ring keeps its order (a window is still written a barrier
// after its last read), only the overlap of the copy with the arithmetic is
// lost.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "storage.cuh"

namespace kron {

constexpr int kStages = 4;  // window buffers: planes in flight, plus one

struct Geometry {
  int n0, n1, n2;        // the field, lifted to 3D
  int per0, per1, per2;  // periodic wrap (else zero ghosts)
  int T1, T2;            // tile rows (axis 1) and columns (axis 2)
  int chunk;             // output planes per block
  int threads;           // block size: T1 * T2 rounded up to whole warps
  int R;                 // terms of the whole operator (for the diagonal)
  int64_t s0, s1, s2;    // element strides of x
};

// index rule of one axis: the source index of g, or -1 for a zero ghost
__device__ __forceinline__ int resolve(int g, int n, int periodic) {
  if (g >= 0 && g < n) return g;
  if (!periodic) return -1;
  g %= n;
  return g < 0 ? g + n : g;
}

template <int BYTES>
__device__ __forceinline__ void cp_async_zfill(void* smem_dst,
                                               const void* gmem_src,
                                               bool valid) {
  // a copy of src-size 0 reads nothing and fills the destination with zeros
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem_dst);
  const int src_size = valid ? BYTES : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst),
               "l"(gmem_src), "n"(BYTES), "r"(src_size)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// soff[e], e = rr * WC + cc: element offset within a plane of x of window
// element (rr, cc) of the tile at (j0, l0), or -1 where the index rule gives
// a zero (Off: the table's type, int64_t or, where a plane's offsets fit,
// int)
template <typename Off>
__device__ __forceinline__ void build_window_offsets(Off* soff,
                                                     const Geometry& g, int P,
                                                     int j0, int l0) {
  const int WR = g.T1 + 2 * P, WC = g.T2 + 2 * P;
  for (int e = threadIdx.x; e < WR * WC; e += blockDim.x) {
    const int rr = e / WC, cc = e - rr * WC;
    const int gj = resolve(j0 + rr - P, g.n1, g.per1);
    const int gl = resolve(l0 + cc - P, g.n2, g.per2);
    soff[e] = (gj < 0 || gl < 0) ? -1 : gj * g.s1 + gl * g.s2;
  }
}

// plain loads of a bf16 window asked for at once, per thread
constexpr int kLoadBatch = 4;

// start the copy of plane gq (>= 0) of x into win, from window element
// `first` on; a thread copies the elements whose offsets it wrote in
// build_window_offsets (the same stride over the block)
template <typename T, typename IO, typename Off>
__device__ __forceinline__ void load_window(T* win, const IO* __restrict__ x,
                                            const Off* soff, int count,
                                            int64_t plane_base,
                                            int first = 0) {
  if constexpr (sizeof(IO) == sizeof(T)) {
    for (int e = first + threadIdx.x; e < count; e += blockDim.x) {
      const int64_t o = soff[e];
      cp_async_zfill<sizeof(T)>(win + e, x + (o < 0 ? 0 : plane_base + o),
                                o >= 0);
    }
  } else {
    for (int e0 = first + threadIdx.x; e0 < count;
         e0 += kLoadBatch * blockDim.x) {
      T v[kLoadBatch];
#pragma unroll
      for (int k = 0; k < kLoadBatch; ++k) {
        const int e = e0 + k * blockDim.x;
        const int64_t o = e < count ? (int64_t)soff[e] : -1;
        v[k] = o >= 0 ? io::up(x[plane_base + o]) : T(0);
      }
#pragma unroll
      for (int k = 0; k < kLoadBatch; ++k) {
        const int e = e0 + k * blockDim.x;
        if (e < count) win[e] = v[k];
      }
    }
  }
}

// what a launch of kernel `fn` with `threads` and `bytes` of shared memory
// gets, for the hosts' resource queries: registers and local memory
// (spills) a thread, shared memory a block, blocks an SM holds
template <typename K>
int resources_of(K fn, int threads, size_t bytes, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err == cudaSuccess && bytes > 48 * 1024)
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads,
                                                        bytes);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, or the next launch reports it
    return (int)err;
  }
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = (int)bytes;
  out[3] = blocks;
  return 0;
}

}  // namespace kron

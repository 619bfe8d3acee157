// K7: a banded tensor-product transfer (restriction or prolongation) in one
// launch, every axis in it,
//   y = (P_0 (x) P_1 (x) P_2) x   (+ addend),
// each 1D factor banded: row i of axis a adds w_a[i, t] * x[(c0_a[i] + t)
// mod n_a] for its W_a taps.  A 1D or 2D field is lifted to 3D with leading
// axes of one point and no band.
//
// Replaces poms_tpu/ops/transfer.py::apply_transfer (apply_transfer_axis per
// axis; no Pallas original: XLA fuses the W gathers, multiplies and adds of
// an axis into one loop there).
//
// What bounds it on an H100: the bytes, the input and output fields each
// moved once (129^3 -> 65^3 in f32 reads 8.6 MB and writes 1.1 MB: 2.9 us at
// 3.35 TB/s; the prolongation with its addend 5.5 us); below about 65^3 the
// launch itself.  The design keeps the two intermediate fields of a 3D
// transfer out of device memory and does only the taps the bands hold.
//
// Design: a block owns a T1 x T2 tile of a run of output planes (grid:
// axis-2 tiles, axis-1 tiles, runs of axis-0 planes).  The rows of axis 1
// and the columns of axis 2 that the tile reads form a cyclic run from the
// tile's first c0 (S1 x S2 of them, at most the host's L1 x L2).  Per
// plane, three passes, a barrier between:
//   A: the axis-0 sums of the plane over those S1 x S2 points, read straight
//      from device memory (neighbouring threads on neighbouring columns;
//      the W0 input planes a plane reads are shared with the next planes'
//      blocks through L2), into shared memory;
//   B: the axis-1 sums of the tile's rows over the S2 columns, from A's;
//   C: the axis-2 sums of the tile, plus the addend, stored.
// The kernel is bound by the latency of its loads more than by their bytes:
// a thread of pass A issues the loads of all its point's taps (up to
// kUnroll) before it sums them.
// Each band comes with its taps in the order they are added (cols, tap_w:
// ops/transfer.py::_taps): a periodic transfer's band is the narrowest
// cyclic one, whose wrapped rows add their taps in ascending column order
// (those past the end of the axis first), the order of the W = n_in band
// without its zero taps.  A block copies the taps of its rows into shared
// memory once, as plane offsets (axis 0) and staged slots (axes 1, 2).
//
#include <cuda_runtime.h>
#include <stdint.h>

#include "storage.cuh"

namespace {

using io::Acc;
using io::store;
using io::up;

constexpr int kThreads = 256;
constexpr int kUnroll = 8;  // taps whose loads are issued together

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

// an axis' sum as the next axis reads it: rounded to the storage type
__device__ __forceinline__ float rounded(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}
template <typename T, typename IO>
__device__ __forceinline__ T rounded(T v, const IO*) {
  return v;
}

// one 1D factor, its taps in the order they are added; w == nullptr on a
// lifted axis (one point, weight 1)
template <typename IO>
struct Axis {
  const IO* w;          // (n_out, W) weights
  const int64_t* col;   // (n_out, W) input index of each tap
  const int64_t* c0;    // (n_out,) first column of each row's band
  int n_in, n_out, W;
};

template <typename IO>
struct Args {
  const IO* x;       // (n0, n1, n2) of the inputs
  const IO* addend;  // (m0, m1, m2) or null
  IO* y;             // (m0, m1, m2)
  Axis<IO> ax[3];
  int T1, T2;        // tile of an output plane
  int L1, L2;        // staged rows and columns a block may need, at most
  int chunk;         // output planes a block
};


// sum over k < n of w[k] * at(k), k = 0 first, uncontracted; up to kUnroll
// values are loaded before the sum starts
template <typename T, typename F>
__device__ __forceinline__ T dot(const T* w, int n, F at) {
  if (n <= kUnroll) {
    T v[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k)
      if (k < n) v[k] = at(k);
    T acc = mul(w[0], v[0]);
#pragma unroll
    for (int k = 1; k < kUnroll; ++k)
      if (k < n) acc = add(acc, mul(w[k], v[k]));
    return acc;
  }
  T acc = mul(w[0], at(0));
  for (int k = 1; k < n; ++k) acc = add(acc, mul(w[k], at(k)));
  return acc;
}

template <typename IO>
__device__ __forceinline__ int first_col(const Axis<IO>& ax, int r) {
  return ax.c0 != nullptr ? (int)ax.c0[r] : 0;
}

// shared memory of a block, in this order (8-byte arrays first):
//   q0[chunk][W0]  int64  input-plane offset of each axis-0 tap
//   roff[L1]       int64  input-row offset of each staged row
//   s0[L1][L2]     T      axis-0 sums
//   s1[T1][L2]     T      axis-1 sums
//   w0[chunk][W0], w1[T1][W1], w2[T2][W2]  T  weights in summation order
//   col[L2]        int    input column of each staged column
//   k1[T1][W1], k2[T2][W2]  int  staged slot of each axis-1 / axis-2 tap
template <typename IO>
__host__ __device__ inline size_t smem_bytes(const Args<IO>& a) {
  using T = typename Acc<IO>::type;
  const size_t W0 = a.ax[0].W, W1 = a.ax[1].W, W2 = a.ax[2].W;
  return (a.chunk * W0 + a.L1) * sizeof(int64_t) +
         (a.L1 * a.L2 + a.T1 * a.L2 + a.chunk * W0 + a.T1 * W1 + a.T2 * W2) *
             sizeof(T) +
         (a.L2 + a.T1 * W1 + a.T2 * W2) * sizeof(int);
}

// taps of rows first.. of ax into shared memory: the weights, and index
// (col - lo) mod n of each (lo < 0: the input index itself, times `scale`)
template <typename IO, typename K>
__device__ __forceinline__ void copy_taps(const Axis<IO>& ax, int first,
                                          int rows, int lo, int64_t scale,
                                          typename Acc<IO>::type* w, K* idx) {
  using T = typename Acc<IO>::type;
  for (int e = threadIdx.x; e < rows * ax.W; e += blockDim.x) {
    if (ax.w == nullptr) {
      w[e] = T(1);
      idx[e] = 0;
      continue;
    }
    const int64_t src = (int64_t)first * ax.W + e;
    w[e] = up(ax.w[src]);
    int v = (int)ax.col[src];
    if (lo >= 0) {
      v -= lo;
      v = v < 0 ? v + ax.n_in : v;
    }
    idx[e] = (K)(v * scale);
  }
}

template <typename IO>
__global__ void __launch_bounds__(kThreads)
transfer_kernel(const Args<IO> a) {
  using T = typename Acc<IO>::type;
  const Axis<IO>& A0 = a.ax[0];
  const Axis<IO>& A1 = a.ax[1];
  const Axis<IO>& A2 = a.ax[2];
  const int L1 = a.L1, L2 = a.L2, W0 = A0.W, W1 = A1.W, W2 = A2.W;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  int64_t* q0 = reinterpret_cast<int64_t*>(smem_raw);
  int64_t* roff = q0 + a.chunk * W0;
  T* s0 = reinterpret_cast<T*>(roff + L1);
  T* s1 = s0 + L1 * L2;
  T* w0 = s1 + a.T1 * L2;
  T* w1 = w0 + a.chunk * W0;
  T* w2 = w1 + a.T1 * W1;
  int* col = reinterpret_cast<int*>(w2 + a.T2 * W2);
  int* k1 = col + L2;
  int* k2 = k1 + a.T1 * W1;
  __shared__ int span[2];

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int i0 = blockIdx.z * a.chunk, ni = min(a.chunk, A0.n_out - i0);
  const int j0 = blockIdx.y * a.T1, l0 = blockIdx.x * a.T2;
  const int nj = min(a.T1, A1.n_out - j0), nk = min(a.T2, A2.n_out - l0);
  const int lo1 = first_col(A1, j0), lo2 = first_col(A2, l0);
  const int64_t plane = (int64_t)A1.n_in * A2.n_in;

  // the tables; a staged run may pass the end of a short axis more than once
  copy_taps(A0, i0, ni, -1, plane, w0, q0);
  copy_taps(A1, j0, nj, lo1, 1, w1, k1);
  copy_taps(A2, l0, nk, lo2, 1, w2, k2);
  for (int e = tid; e < L1; e += nthreads)
    roff[e] = (int64_t)((lo1 + e) % A1.n_in) * A2.n_in;
  for (int e = tid; e < L2; e += nthreads) col[e] = (lo2 + e) % A2.n_in;
  // the rows and columns the tile reads: from lo, as far as the furthest
  // row's last tap (warp 0: axis 1, warp 1: axis 2)
  const int warp = tid >> 5, lane = tid & 31;
  if (warp < 2) {
    const Axis<IO>& ax = warp == 0 ? A1 : A2;
    const int first = warp == 0 ? j0 : l0, n = warp == 0 ? nj : nk;
    const int lo = warp == 0 ? lo1 : lo2;
    int reach = 0;
    for (int r = lane; r < n; r += 32) {
      const int b = first_col(ax, first + r) - lo;
      reach = max(reach, b < 0 ? b + ax.n_in : b);
    }
    for (int o = 16; o > 0; o >>= 1)
      reach = max(reach, __shfl_xor_sync(0xffffffffu, reach, o));
    if (lane == 0) span[warp] = reach + ax.W;
  }
  __syncthreads();
  const int S1 = span[0], S2 = span[1];

  for (int ii = 0; ii < ni; ++ii) {
    const int64_t ybase = (int64_t)(i0 + ii) * A1.n_out * A2.n_out;
    // A: axis-0 sums of the plane over the S1 x S2 staged points; (b, c)
    // advance by the block size without a division
    {
      const T* wa = w0 + ii * W0;
      const int64_t* qa = q0 + ii * W0;
      const int db = nthreads / S2, dc = nthreads - db * S2;
      int b = tid / S2, c = tid - b * S2;
      for (int e = tid; e < S1 * S2; e += nthreads) {
        const IO* src = a.x + roff[b] + col[c];
        s0[b * L2 + c] =
            rounded(dot(wa, W0, [&](int k) { return up(src[qa[k]]); }), a.x);
        b += db, c += dc;
        if (c >= S2) c -= S2, ++b;
      }
    }
    __syncthreads();
    // B: axis-1 sums of the tile's rows over the S2 staged columns
    {
      const int dj = nthreads / S2, dc = nthreads - dj * S2;
      int j = tid / S2, c = tid - j * S2;
      for (int e = tid; e < nj * S2; e += nthreads) {
        const int* kj = k1 + j * W1;
        s1[j * L2 + c] = rounded(
            dot(w1 + j * W1, W1, [&](int k) { return s0[kj[k] * L2 + c]; }),
            a.x);
        j += dj, c += dc;
        if (c >= S2) c -= S2, ++j;
      }
    }
    __syncthreads();
    // C: axis-2 sums of the tile, the addend, the store
    {
      const int dj = nthreads / nk, dl = nthreads - dj * nk;
      int j = tid / nk, l = tid - j * nk;
      for (int e = tid; e < nj * nk; e += nthreads) {
        const T* row = s1 + j * L2;
        const int* kl = k2 + l * W2;
        const T v = dot(w2 + l * W2, W2, [&](int k) { return row[kl[k]]; });
        const int64_t idx = ybase + (int64_t)(j0 + j) * A2.n_out + l0 + l;
        store(a.y + idx, a.addend != nullptr ? add(up(a.addend[idx]), v) : v);
        j += dj, l += dl;
        if (l >= nk) l -= nk, ++j;
      }
    }
    // the next plane's pass A writes s0 after this pass B's reads (the
    // barrier above), its pass B writes s1 after this pass C's (the barrier
    // after its pass A)
  }
}

template <typename IO>
int launch(const Args<IO>& a, cudaStream_t st) {
  const size_t bytes = smem_bytes(a);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        transfer_kernel<IO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear it, or the next launch reports it
      return (int)err;
    }
  }
  const dim3 grid((a.ax[2].n_out + a.T2 - 1) / a.T2,
                  (a.ax[1].n_out + a.T1 - 1) / a.T1,
                  (a.ax[0].n_out + a.chunk - 1) / a.chunk);
  transfer_kernel<IO><<<grid, kThreads, bytes, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename IO>
int launch_typed(const void* x, const void* addend, void* y,
                 const void* const* w, const int64_t* const* col,
                 const int64_t* const* c0, const int* geo, cudaStream_t st) {
  Args<IO> a;
  a.x = (const IO*)x;
  a.addend = (const IO*)addend;
  a.y = (IO*)y;
  for (int d = 0; d < 3; ++d) {
    Axis<IO>& ax = a.ax[d];
    ax.w = (const IO*)w[d];
    ax.col = col[d];
    ax.c0 = c0[d];
    ax.n_in = geo[3 * d], ax.n_out = geo[3 * d + 1], ax.W = geo[3 * d + 2];
    const bool lifted = ax.w == nullptr;
    if (lifted != (ax.col == nullptr) || lifted != (ax.c0 == nullptr) ||
        ax.n_in < 1 || ax.n_out < 1 || ax.W < 1 || ax.W > ax.n_in ||
        (lifted && (ax.n_in != 1 || ax.n_out != 1 || ax.W != 1)))
      return (int)cudaErrorInvalidValue;
  }
  a.T1 = geo[9], a.T2 = geo[10], a.L1 = geo[11], a.L2 = geo[12];
  a.chunk = geo[13];
  if (a.T1 < 1 || a.T2 < 1 || a.L1 < 1 || a.L2 < 1 || a.chunk < 1 ||
      a.L1 > a.ax[1].n_in + a.ax[1].W - 1 ||
      a.L2 > a.ax[2].n_in + a.ax[2].W - 1 ||
      (a.ax[0].n_out + a.chunk - 1) / a.chunk > 65535)
    return (int)cudaErrorInvalidValue;
  return launch<IO>(a, st);
}

}  // namespace

extern "C" {

// x: (n0, n1, n2) contiguous, addend (or null) and y: (m0, m1, m2); per axis
// a: its taps in the order they are added, weights w_a and input indices
// col_a (m_a, W_a), and c0_a (m_a,) the first column of each row's band, all
// int64 but w_a, all null on a lifted axis (n = m = W = 1); geo: per axis
// n_in n_out W, then T1 T2 L1 L2 chunk (ops/transfer.py::transfer_tiling);
// dtype_code: 0 float, 1 double, 2 bfloat16 (x, the weights, addend and y
// alike).
int transfer_apply(const void* x, const void* addend, void* y,
                   const void* w0, const int64_t* col0, const int64_t* c00,
                   const void* w1, const int64_t* col1, const int64_t* c01,
                   const void* w2, const int64_t* col2, const int64_t* c02,
                   const int* geo, int dtype_code, void* stream) {
  if (x == nullptr || y == nullptr || geo == nullptr)
    return (int)cudaErrorInvalidValue;
  const void* w[3] = {w0, w1, w2};
  const int64_t* col[3] = {col0, col1, col2};
  const int64_t* c0[3] = {c00, c01, c02};
  const cudaStream_t st = (cudaStream_t)stream;
  switch (dtype_code) {  // ops/transfer.py::_DTYPE_CODES
    case 0: return launch_typed<float>(x, addend, y, w, col, c0, geo, st);
    case 1: return launch_typed<double>(x, addend, y, w, col, c0, geo, st);
    case 2:
      return launch_typed<__nv_bfloat16>(x, addend, y, w, col, c0, geo, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* transfer_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

// Fused Kronecker-sum apply for 3D fields:
//   y = sum_r (B_r0 (x) B_r1 (x) B_r2) x.
//
// Replaces the TPU kernel poms_tpu/ops/pallas/kron.py::kron_apply_pallas
// (body _make_kernel, launch _call).  Each B_ra is a 1D band of shape
// (n_a, 2p_a+1): row i multiplies x_pad[i + t] for t in [0, 2p_a].  The
// input is the ghost-padded field x_pad of shape (n0+2p0, n1+2p1, n2+2p2);
// the wrapper pads it by the boundary rule (zeros or periodic wrap).
//
// What bounds it on an H100: the algorithm needs one read of x and one write
// of y per apply (8 bytes per point in f32), so it is bandwidth-bound at
// ~3.35 TB/s; the contraction chain (~55 multiply-adds per point per term at
// p = 3) stays on chip.  Design: one block per (T0, T1, T2) output tile.  The
// block stages the tile's halo window of x and the tile's band rows in shared
// memory once, then for each term contracts axis 2, axis 1 and axis 0
// through shared-memory scratch and sums the terms in registers; y is
// written once.  Band rows past the grid edge are staged as zeros, so the
// ragged edge needs masks only on the window load and the final store.
// Later work: shared partials across terms, TMA window loads, fused
// Chebyshev/residual epilogues.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int T0 = 4;   // output planes per tile (axis 0)
constexpr int T1 = 8;   // output rows per tile (axis 1)
constexpr int T2 = 32;  // output columns per tile (axis 2) = one warp
constexpr int kThreads = T1 * T2;

struct Geometry {
  int R, n0, n1, n2, p0, p1, p2;
  __host__ __device__ int w0() const { return 2 * p0 + 1; }
  __host__ __device__ int w1() const { return 2 * p1 + 1; }
  __host__ __device__ int w2() const { return 2 * p2 + 1; }
  __host__ __device__ int W0() const { return T0 + 2 * p0; }
  __host__ __device__ int W1() const { return T1 + 2 * p1; }
  __host__ __device__ int W2() const { return T2 + 2 * p2; }
  // shared-memory elements: x window, axis-2 partial u, axis-1 partial v,
  // then the tile's rows of every term's three bands
  __host__ __device__ int window() const { return W0() * W1() * W2(); }
  __host__ __device__ int u_size() const { return W0() * W1() * T2; }
  __host__ __device__ int v_size() const { return W0() * T1 * T2; }
  __host__ __device__ int band_size() const {
    return R * (T0 * w0() + T1 * w1() + T2 * w2());
  }
  __host__ __device__ int smem_elems() const {
    return window() + u_size() + v_size() + band_size();
  }
};

template <typename T>
__device__ void stage_band_rows(T* dst, const T* __restrict__ band, int n,
                                int w, int row0, int rows) {
  // dst[i * w + t] = band[row0 + i, t], zero past the grid edge
  for (int e = threadIdx.x; e < rows * w; e += blockDim.x) {
    const int i = e / w;
    const int g = row0 + i;
    dst[e] = g < n ? band[(int64_t)g * w + (e - i * w)] : T(0);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
kron_apply_kernel(const T* __restrict__ xp, const T* __restrict__ b0,
                  const T* __restrict__ b1, const T* __restrict__ b2,
                  T* __restrict__ y, Geometry g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xw = reinterpret_cast<T*>(smem_raw);
  T* u = xw + g.window();
  T* v = u + g.u_size();
  T* bs = v + g.v_size();

  const int w0 = g.w0(), w1 = g.w1(), w2 = g.w2();
  const int W0 = g.W0(), W1 = g.W1(), W2 = g.W2();
  const int i0 = blockIdx.z * T0, j0 = blockIdx.y * T1, l0 = blockIdx.x * T2;
  const int P0 = g.n0 + 2 * g.p0;
  const int64_t P1 = g.n1 + 2 * g.p1, P2 = g.n2 + 2 * g.p2;

  // halo window of x_pad: planes i0.., rows j0.., columns l0.. (zeros past
  // the padded field's end on a ragged tile)
  for (int e = threadIdx.x; e < g.window(); e += blockDim.x) {
    const int q = e / (W1 * W2);
    const int rem = e - q * W1 * W2;
    const int jj = rem / W2;
    const int ll = rem - jj * W2;
    const int gq = i0 + q, gj = j0 + jj, gl = l0 + ll;
    xw[e] = (gq < P0 && gj < P1 && gl < P2)
                ? xp[((int64_t)gq * P1 + gj) * P2 + gl]
                : T(0);
  }
  const int per_term = T0 * w0 + T1 * w1 + T2 * w2;
  for (int r = 0; r < g.R; ++r) {
    T* dst = bs + r * per_term;
    stage_band_rows(dst, b0 + (int64_t)r * g.n0 * w0, g.n0, w0, i0, T0);
    stage_band_rows(dst + T0 * w0, b1 + (int64_t)r * g.n1 * w1, g.n1, w1,
                    j0, T1);
    stage_band_rows(dst + T0 * w0 + T1 * w1, b2 + (int64_t)r * g.n2 * w2,
                    g.n2, w2, l0, T2);
  }
  __syncthreads();

  const int tl = threadIdx.x % T2;
  const int tj = threadIdx.x / T2;
  T acc[T0];
#pragma unroll
  for (int i = 0; i < T0; ++i) acc[i] = T(0);

  for (int r = 0; r < g.R; ++r) {
    const T* B0 = bs + r * per_term;
    const T* B1 = B0 + T0 * w0;
    const T* B2 = B1 + T1 * w1;
    // axis 2: u[q, jj, l] = sum_t B2[l, t] * xw[q, jj, l + t]
    for (int e = threadIdx.x; e < g.u_size(); e += blockDim.x) {
      const int l = e % T2;
      const int qj = e / T2;
      const T* brow = B2 + l * w2;
      const T* xrow = xw + qj * W2 + l;
      T s = T(0);
      for (int t = 0; t < w2; ++t) s += brow[t] * xrow[t];
      u[e] = s;
    }
    __syncthreads();
    // axis 1: v[q, j, l] = sum_t B1[j, t] * u[q, j + t, l]
    for (int e = threadIdx.x; e < g.v_size(); e += blockDim.x) {
      const int l = e % T2;
      const int qj = e / T2;
      const int j = qj % T1;
      const int q = qj / T1;
      const T* brow = B1 + j * w1;
      const T* ucol = u + (q * W1 + j) * T2 + l;
      T s = T(0);
      for (int t = 0; t < w1; ++t) s += brow[t] * ucol[t * T2];
      v[e] = s;
    }
    __syncthreads();
    // axis 0: y[i, tj, tl] += sum_t B0[i, t] * v[i + t, tj, tl]
#pragma unroll
    for (int i = 0; i < T0; ++i) {
      const T* brow = B0 + i * w0;
      const T* vcol = v + (i * T1 + tj) * T2 + tl;
      T s = T(0);
      for (int t = 0; t < w0; ++t) s += brow[t] * vcol[t * T1 * T2];
      acc[i] += s;
    }
    __syncthreads();  // u and v are rewritten by the next term
  }

  const int gj = j0 + tj, gl = l0 + tl;
  if (gj < g.n1 && gl < g.n2) {
#pragma unroll
    for (int i = 0; i < T0; ++i) {
      const int gi = i0 + i;
      if (gi < g.n0) y[((int64_t)gi * g.n1 + gj) * g.n2 + gl] = acc[i];
    }
  }
}

template <typename T>
int launch(const T* xp, const T* b0, const T* b1, const T* b2, T* y, int R,
           int n0, int n1, int n2, int p0, int p1, int p2, void* stream) {
  const Geometry g{R, n0, n1, n2, p0, p1, p2};
  const size_t bytes = (size_t)g.smem_elems() * sizeof(T);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kron_apply_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((n2 + T2 - 1) / T2, (n1 + T1 - 1) / T1, (n0 + T0 - 1) / T0);
  kron_apply_kernel<T><<<grid, kThreads, bytes, (cudaStream_t)stream>>>(
      xp, b0, b1, b2, y, g);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int kron_apply_f32(const float* xp, const float* b0, const float* b1,
                   const float* b2, float* y, int R, int n0, int n1, int n2,
                   int p0, int p1, int p2, void* stream) {
  return launch<float>(xp, b0, b1, b2, y, R, n0, n1, n2, p0, p1, p2, stream);
}

int kron_apply_f64(const double* xp, const double* b0, const double* b1,
                   const double* b2, double* y, int R, int n0, int n1, int n2,
                   int p0, int p1, int p2, void* stream) {
  return launch<double>(xp, b0, b1, b2, y, R, n0, n1, n2, p0, p1, p2, stream);
}

const char* kron_apply_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

// Plane-reuse SpMV probe (K4v): a banded SpMV, f32, 3D,
//
//   out[i] = sum_k band_t[k, i] * x_pad[i + k]
//
// computed so that every x value a thread reads from shared memory serves
// all the output planes it reaches.  Replaces the TPU kernel
// poms_tpu/bench/kernel_probe.py::probe_v15 (the plane-shift-cached
// prototype: each cached shifted plane reused by up to 2p0 + 1 output
// planes).
//
// What it measures on an H100: K2 reads x from its shared-memory window
// once per (term, point), T0 (2p+1)^3 reads a thread; here a thread that
// owns T0 points along axis 0 reads, for each (k1, k2), the T0 + 2p0 values
// of its x column once into a register and applies each to the up to
// 2p0 + 1 output planes it reaches: (T0 + 2p0)(2p1 + 1)(2p2 + 1) reads.
// The band stream is K2's (every coefficient read once, coalesced along
// the last axis), so the difference between the two times is what K2's
// shared-memory x reads cost.  Each point sums its terms in (k1, k2, k0)
// order, not the plain version's (k0, k1, k2).
//
// Block: T1 rows x 32 lanes of threads over a (T0, T1, 32) output tile,
// the x halo window staged once; 64-bit plane strides.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int T0, int T1>
__global__ void __launch_bounds__(T1 * 32)
probe_v15_kernel(const float* __restrict__ band, const float* __restrict__ xp,
                 float* __restrict__ out, int n0, int n1, int n2, int p0,
                 int p1, int p2) {
  constexpr int T2 = 32;
  extern __shared__ __align__(16) float xw[];
  const int w0 = 2 * p0 + 1, w1 = 2 * p1 + 1, w2 = 2 * p2 + 1;
  const int W1 = T1 + 2 * p1, W2 = T2 + 2 * p2;
  const int window = (T0 + 2 * p0) * W1 * W2;
  const int i0 = blockIdx.z * T0, j0 = blockIdx.y * T1, l0 = blockIdx.x * T2;
  const int P0 = n0 + 2 * p0;
  const int64_t P1 = n1 + 2 * p1, P2 = n2 + 2 * p2;
  for (int e = threadIdx.x; e < window; e += blockDim.x) {
    const int q = e / (W1 * W2);
    const int rem = e - q * W1 * W2;
    const int jj = rem / W2;
    const int ll = rem - jj * W2;
    const int gq = i0 + q, gj = j0 + jj, gl = l0 + ll;
    xw[e] = (gq < P0 && gj < P1 && gl < P2)
                ? xp[((int64_t)gq * P1 + gj) * P2 + gl]
                : 0.f;
  }
  __syncthreads();

  const int tl = threadIdx.x % T2, tj = threadIdx.x / T2;
  const int gj = j0 + tj, gl = l0 + tl;
  if (gj >= n1 || gl >= n2) return;  // no barrier follows
  const int rows = min(T0, n0 - i0);
  const int64_t N = (int64_t)n0 * n1 * n2;       // one band plane
  const int64_t plane_i = (int64_t)n1 * n2;      // one step along axis 0
  const int64_t pt0 = ((int64_t)i0 * n1 + gj) * n2 + gl;
  const int64_t k0_stride = (int64_t)w1 * w2 * N;
  const int xstep = W1 * W2;
  const int nq = rows + 2 * p0;                  // x planes the points reach

  float acc[T0];
#pragma unroll
  for (int i = 0; i < T0; ++i) acc[i] = 0.f;

  for (int k1 = 0; k1 < w1; ++k1) {
    for (int k2 = 0; k2 < w2; ++k2) {
      const float* xcol = xw + (tj + k1) * W2 + tl + k2;
      const float* bk = band + ((int64_t)k1 * w2 + k2) * N + pt0;  // k0 = 0
      for (int q = 0; q < nq; ++q) {
        const float xv = xcol[q * xstep];
#pragma unroll
        for (int i = 0; i < T0; ++i) {
          const int k0 = q - i;  // the output plane i reads x plane q here
          if (i < rows && k0 >= 0 && k0 < w0)
            acc[i] += bk[k0 * k0_stride + i * plane_i] * xv;
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < T0; ++i) {
    if (i >= rows) break;
    out[pt0 + i * plane_i] = acc[i];
  }
}

template <int T0, int T1>
int launch_tiles(const float* band, const float* xp, float* out, int n0,
                 int n1, int n2, int p0, int p1, int p2, void* stream) {
  const size_t bytes =
      (size_t)(T0 + 2 * p0) * (T1 + 2 * p1) * (32 + 2 * p2) * sizeof(float);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        probe_v15_kernel<T0, T1>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear it, or the next launch reports it
      return (int)err;
    }
  }
  const dim3 grid((n2 + 31) / 32, (n1 + T1 - 1) / T1, (n0 + T0 - 1) / T0);
  if (grid.y > 65535 || grid.z > 65535)
    return (int)cudaErrorInvalidConfiguration;
  probe_v15_kernel<T0, T1><<<grid, T1 * 32, bytes, (cudaStream_t)stream>>>(
      band, xp, out, n0, n1, n2, p0, p1, p2);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// t0 in {2, 4, 8} planes a thread, t2 in {4, 8} rows a block
int probe_v15_f32(const float* band, const float* xp, float* out, int n0,
                  int n1, int n2, int p0, int p1, int p2, int t0, int t2,
                  void* stream) {
  if (n0 < 1 || n1 < 1 || n2 < 1 || p0 < 0 || p1 < 0 || p2 < 0)
    return (int)cudaErrorInvalidValue;
#define POMS_V15_TILE(A, B)                                                 \
  if (t0 == A && t2 == B)                                                   \
    return launch_tiles<A, B>(band, xp, out, n0, n1, n2, p0, p1, p2, stream);
  POMS_V15_TILE(8, 8)
  POMS_V15_TILE(4, 8)
  POMS_V15_TILE(2, 8)
  POMS_V15_TILE(8, 4)
  POMS_V15_TILE(4, 4)
  POMS_V15_TILE(2, 4)
#undef POMS_V15_TILE
  return (int)cudaErrorInvalidValue;
}

const char* probe_v15_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

// Banded stencil apply (K2) in four modes, for 3D fields (1D and 2D fields
// are lifted to 3D by the wrapper as (1, 1, n) and (1, n1, n2) with zero
// pads on the lifted axes):
//
//   spmv      out[i] = sum_k band_t[k, i] * x_pad[i + k]
//   residual  out[i] = b[i] - (A x)[i]
//   jacobi    out[i] = x[i] + omega * (b[i] - (A x)[i]) / diag[i]
//   rbgs      one red-black Gauss-Seidel colour phase, out of place:
//             on points whose global index sum (pbase + i0 + i1 + i2) has
//             parity `color`,
//               out[i] = (1 - omega) x[i] + omega (b[i] - offdiag[i]) / diag[i]
//             with offdiag = A x - diag * x from the pre-phase x (same-colour
//             neighbours contribute their old values); the other points are
//             copied from x unchanged.
//
// Replaces the TPU kernel poms_tpu/ops/pallas/spmv.py::_stencil_call (body
// _make_kernel; entry points spmv_banded_pallas, residual_fused_pallas,
// jacobi_fused_pallas, rbgs_color_pallas).  band_t is offset-major,
// (w0, w1, w2, n0, n1, n2) with w = 2p + 1: each coefficient plane is a
// contiguous grid-shaped array.  x_pad is the ghost-padded field
// (n0 + 2p0, n1 + 2p1, n2 + 2p2) with ghosts already filled (zeros or the
// periodic wrap), so the kernel needs no boundary logic; b may be strided.
// diag is the centre plane band_t[p0, p1, p2].
//
// What bounds it on an H100: every apply streams the whole band once,
// (2p+1)^3 coefficients per point (343 at p = 3), against one read of x and
// one write of the output, so it is bound by device-memory bandwidth
// (3.35 TB/s) at about 2 flops per band byte read in f32.  Design: one
// block per (T0, T1, T2) output tile; the block stages the tile's x halo
// window in shared memory once; each thread owns T0 output points along
// axis 0 (kept in registers) and walks the offsets in the order of the
// plain version (itertools.product), reading band_t[k] at its own points
// from device memory: adjacent threads are adjacent along the last grid
// axis, so each warp reads 32 consecutive coefficients of one plane.  The
// mode's epilogue runs once per point.  Indices and plane strides are
// 64-bit: the 129^3 p = 3 band has 736 M elements (5.9 GB in f64).
// Later work: compile-time p for full unrolling, TMA/cp.async staging of
// the band planes, fusion of the ghost refresh.
//
// The same template, with one part of the inner loop changed at compile
// time, is the kernel-limit probes K4c and K4a (stencil_probe_f32, spmv
// mode, f32, 3D):
//   compute  (K4c, replaces poms_tpu/bench/kernel_probe.py::probe_compute)
//            every block reads the band of tile (0, 0, 0), so the band
//            comes from L1/L2 and the time is K2's arithmetic, shared-memory
//            reads and x window without the band stream;
//   noshift, nolane, nomul  (K4a, replaces probe_ablate): the axis-1 x
//            offset held at 0, the axis-2 x offset held at 0, or no band
//            read (acc += x).  Their results are deliberately not the SpMV.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Mode { kSpmv = 0, kResidual = 1, kJacobi = 2, kRbgs = 3 };
// K2 itself, and the probes' changes to its inner loop
enum Variant { kFull = 0, kPinBand = 1, kNoShift = 2, kNoLane = 3,
               kNoMul = 4 };

struct Geometry {
  int n0, n1, n2, p0, p1, p2;
  int64_t bs0, bs1, bs2;  // strides of b, in elements
  int mode, color;
  int64_t pbase;          // global index sum of the field's first point
};

template <typename T, int T0, int T1, int T2, int V>
__global__ void __launch_bounds__(T1 * T2)
stencil_apply_kernel(const T* __restrict__ band, const T* __restrict__ xp,
                     const T* __restrict__ b, T* __restrict__ out, T omega,
                     Geometry g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xw = reinterpret_cast<T*>(smem_raw);

  const int w0 = 2 * g.p0 + 1, w1 = 2 * g.p1 + 1, w2 = 2 * g.p2 + 1;
  const int W1 = T1 + 2 * g.p1, W2 = T2 + 2 * g.p2;
  const int window = (T0 + 2 * g.p0) * W1 * W2;
  const int i0 = blockIdx.z * T0, j0 = blockIdx.y * T1, l0 = blockIdx.x * T2;
  const int P0 = g.n0 + 2 * g.p0;
  const int64_t P1 = g.n1 + 2 * g.p1, P2 = g.n2 + 2 * g.p2;

  // halo window of x_pad (zeros past the padded field on a ragged tile)
  for (int e = threadIdx.x; e < window; e += blockDim.x) {
    const int q = e / (W1 * W2);
    const int rem = e - q * W1 * W2;
    const int jj = rem / W2;
    const int ll = rem - jj * W2;
    const int gq = i0 + q, gj = j0 + jj, gl = l0 + ll;
    xw[e] = (gq < P0 && gj < P1 && gl < P2)
                ? xp[((int64_t)gq * P1 + gj) * P2 + gl]
                : T(0);
  }
  __syncthreads();

  const int tl = threadIdx.x % T2, tj = threadIdx.x / T2;
  const int gj = j0 + tj, gl = l0 + tl;
  if (gj >= g.n1 || gl >= g.n2) return;  // no barrier follows
  const int rows = min(T0, g.n0 - i0);
  const int64_t N = (int64_t)g.n0 * g.n1 * g.n2;  // one band plane
  const int64_t plane_i = (int64_t)g.n1 * g.n2;   // one step along axis 0
  const int64_t pt0 = ((int64_t)i0 * g.n1 + gj) * g.n2 + gl;
  const int xstep = W1 * W2;

  T acc[T0];
#pragma unroll
  for (int i = 0; i < T0; ++i) acc[i] = T(0);

  // the compute probe reads the band at the same point of tile (0, 0, 0)
  const T* bk = band + (V == kPinBand ? (int64_t)tj * g.n2 + tl : pt0);
  for (int k0 = 0; k0 < w0; ++k0) {
    for (int k1 = 0; k1 < w1; ++k1) {
      const int s1 = V == kNoShift ? 0 : k1;
      const T* xrow = xw + (k0 * W1 + tj + s1) * W2 + tl;
      for (int k2 = 0; k2 < w2; ++k2) {
        const int s2 = V == kNoLane ? 0 : k2;
#pragma unroll
        for (int i = 0; i < T0; ++i) {
          if (i < rows) {
            if (V == kNoMul)
              acc[i] += xrow[i * xstep + s2];
            else
              acc[i] += bk[i * plane_i] * xrow[i * xstep + s2];
          }
        }
        bk += N;
      }
    }
  }

  const int64_t centre = ((int64_t)g.p0 * w1 + g.p1) * w2 + g.p2;
#pragma unroll
  for (int i = 0; i < T0; ++i) {
    if (i >= rows) break;
    const int64_t pt = pt0 + i * plane_i;
    T y = acc[i];
    if (g.mode != kSpmv) {
      const int gi = i0 + i;
      const T bv = b[gi * g.bs0 + gj * g.bs1 + gl * g.bs2];
      if (g.mode == kResidual) {
        y = bv - y;
      } else {
        const T xc = xw[((i + g.p0) * W1 + tj + g.p1) * W2 + tl + g.p2];
        const T d = band[centre * N + pt];
        if (g.mode == kJacobi) {
          y = xc + omega * (bv - y) / d;
        } else {
          const bool on = ((g.pbase + gi + gj + gl) & 1) == g.color;
          y = on ? (T(1) - omega) * xc + omega * ((bv - (y - d * xc)) / d)
                 : xc;
        }
      }
    }
    out[pt] = y;
  }
}

template <typename T, int T0, int T1, int T2, int V = kFull>
int launch_tiles(const T* band, const T* xp, const T* b, T* out, T omega,
                 const Geometry& g, void* stream) {
  const size_t bytes = (size_t)(T0 + 2 * g.p0) * (T1 + 2 * g.p1) *
                       (T2 + 2 * g.p2) * sizeof(T);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        stencil_apply_kernel<T, T0, T1, T2, V>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear it, or the next launch reports it
      return (int)err;
    }
  }
  const dim3 grid((g.n2 + T2 - 1) / T2, (g.n1 + T1 - 1) / T1,
                  (g.n0 + T0 - 1) / T0);
  if (grid.y > 65535 || grid.z > 65535)
    return (int)cudaErrorInvalidConfiguration;
  stencil_apply_kernel<T, T0, T1, T2, V>
      <<<grid, T1 * T2, bytes, (cudaStream_t)stream>>>(band, xp, b, out,
                                                       omega, g);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const T* band, const T* xp, const T* b, T* out, T omega, int n0,
           int n1, int n2, int p0, int p1, int p2, int64_t bs0, int64_t bs1,
           int64_t bs2, int mode, int color, int64_t pbase, void* stream) {
  if (mode < kSpmv || mode > kRbgs || n0 < 1 || n1 < 1 || n2 < 1 ||
      p0 < 0 || p1 < 0 || p2 < 0)
    return (int)cudaErrorInvalidValue;
  const Geometry g{n0, n1, n2, p0, p1, p2, bs0, bs1, bs2, mode, color, pbase};
  // tile shape by the field's real rank: a lifted axis of extent 1 gets a
  // tile of extent 1, so no thread works on points that do not exist
  if (n0 == 1 && n1 == 1)
    return launch_tiles<T, 1, 1, 256>(band, xp, b, out, omega, g, stream);
  if (n0 == 1)
    return launch_tiles<T, 1, 8, 32>(band, xp, b, out, omega, g, stream);
  return launch_tiles<T, 4, 8, 32>(band, xp, b, out, omega, g, stream);
}

}  // namespace

extern "C" {

int stencil_apply_f32(const float* band, const float* xp, const float* b,
                      float* out, float omega, int n0, int n1, int n2, int p0,
                      int p1, int p2, int64_t bs0, int64_t bs1, int64_t bs2,
                      int mode, int color, int64_t pbase, void* stream) {
  return launch<float>(band, xp, b, out, omega, n0, n1, n2, p0, p1, p2, bs0,
                       bs1, bs2, mode, color, pbase, stream);
}

int stencil_apply_f64(const double* band, const double* xp, const double* b,
                      double* out, double omega, int n0, int n1, int n2,
                      int p0, int p1, int p2, int64_t bs0, int64_t bs1,
                      int64_t bs2, int mode, int color, int64_t pbase,
                      void* stream) {
  return launch<double>(band, xp, b, out, omega, n0, n1, n2, p0, p1, p2, bs0,
                        bs1, bs2, mode, color, pbase, stream);
}

// the probes: spmv mode, f32, 3D, K2's 3D tile; variant is a Variant
int stencil_probe_f32(int variant, const float* band, const float* xp,
                      float* out, int n0, int n1, int n2, int p0, int p1,
                      int p2, void* stream) {
  if (n0 < 4 || n1 < 8 || n2 < 32 || p0 < 0 || p1 < 0 || p2 < 0)
    return (int)cudaErrorInvalidValue;  // tile (0, 0, 0) must be whole
  const Geometry g{n0, n1, n2, p0, p1, p2, 0, 0, 0, kSpmv, 0, 0};
  switch (variant) {
    case kFull:
      return launch_tiles<float, 4, 8, 32, kFull>(band, xp, nullptr, out,
                                                  0.f, g, stream);
    case kPinBand:
      return launch_tiles<float, 4, 8, 32, kPinBand>(band, xp, nullptr, out,
                                                     0.f, g, stream);
    case kNoShift:
      return launch_tiles<float, 4, 8, 32, kNoShift>(band, xp, nullptr, out,
                                                     0.f, g, stream);
    case kNoLane:
      return launch_tiles<float, 4, 8, 32, kNoLane>(band, xp, nullptr, out,
                                                    0.f, g, stream);
    case kNoMul:
      return launch_tiles<float, 4, 8, 32, kNoMul>(band, xp, nullptr, out,
                                                   0.f, g, stream);
  }
  return (int)cudaErrorInvalidValue;
}

const char* stencil_apply_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

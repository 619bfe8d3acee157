// Banded stencil apply over a packed band (K3, the v2 engine), in K2's
// four modes, for 3D fields (1D and 2D fields are lifted to 3D by the
// wrapper as (1, 1, n) and (1, n1, n2) with zero pads on the lifted axes):
//
//   spmv      out[i] = sum_k band_t[k, i] * x_pad[i + k]
//   residual  out[i] = b[i] - (A x)[i]
//   jacobi    out[i] = x[i] + omega * (b[i] - (A x)[i]) / diag[i]
//   rbgs      one red-black Gauss-Seidel colour phase, out of place, on
//             the points whose global index sum (pbase + i0 + i1 + i2) has
//             parity `color`; the other points are copied from x.
//
// Replaces the TPU kernel poms_tpu/ops/pallas/spmv.py::_stencil_call_v2
// (body _make_kernel_v2; pallas_call sites for spmv, residual, jacobi and
// rbgs), selected by POMS_TPU_SPMV=v2.  The band arrives packed
// (ops/stencil_v2.py::pack_band_v2): tile after tile in grid order, and in
// each tile one contiguous slab per leading offset pair (k0, k1), laid out
// [k2][i0][i1][i2] over the tile's real extent (e0, e1, e2) with the lane
// axis at a pitch r2 rounded up to 16 bytes.  The points before tile
// (a, b, c) are i0 n1 n2p + e0 (j0 n2p + e1 l0), n2p being n2 rounded up
// to 16 bytes, so a block finds its slabs without a table.  diag is the
// centre plane as its own contiguous array.
//
// What bounds it on an H100: like K2, the band stream ((2p+1)^3
// coefficients per point against one read of x and one write) at about 2
// flops per band byte in f32, so device-memory bandwidth (3.35 TB/s).
// Design, and what makes it K3 rather than K2: the band never passes
// through registers on its way in.  One thread issues each (k0, k1) slab
// as a single bulk asynchronous copy (cp.async.bulk, TMA's 1D form, which
// needs no tensor map since the slab is contiguous) into a ring of
// kDepth = 3 shared-memory stages, completing on an mbarrier; the slab of
// step s + 3 is issued as soon as every thread has read step s, so three
// slabs are in flight while the block computes.  The arithmetic reads
// coefficients from shared memory.  The x halo window is staged once per
// block as in K2, each thread owns T0 points along axis 0, and each point
// sums its terms in the plain version's offset order.  Indices and plane
// strides are 64-bit.
//
// Types: f32, f64, and bf16 (the TPU engine's second type).  In bf16 the
// pack, diag, x_pad, b and the output are __nv_bfloat16; the ring holds the
// slabs as they are (a bulk copy moves bytes, so a stage is half an f32
// one's size), each coefficient is converted as it is read, the x window
// holds f32 (converted once at the fill) and the sum and the epilogue are
// f32, rounded once on the store.  Every bulk copy still has a size and two
// addresses that are multiples of 16 bytes: the lane pitch r2 and n2p are
// multiples of 16 / sizeof(T) = 8 values, the tile offset is a sum of
// multiples of n2p and of l0 (a multiple of 32), and a ring stage is
// w2 T0 T1 T2 values (a multiple of 512 bytes).  The TPU kernel sums in its
// operand type; this f32 sum is at least as exact and not bitwise with it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "storage.cuh"

namespace {

using io::Acc;
using io::store;
using io::up;

enum Mode { kSpmv = 0, kResidual = 1, kJacobi = 2, kRbgs = 3 };
constexpr int kDepth = 3;

struct Geometry {
  int n0, n1, n2, p0, p1, p2;
  int64_t n2p;            // lane extent of the packed grid
  int64_t bs0, bs1, bs2;  // strides of b, in elements
  int mode, color;
  int64_t pbase;          // global index sum of the field's first point
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// one bulk copy of `bytes` (a multiple of 16, both addresses 16-aligned)
// from global to shared memory, completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

template <typename T, int T0, int T1, int T2>
__global__ void __launch_bounds__(T1 * T2)
stencil_apply_v2_kernel(const T* __restrict__ blk, const T* __restrict__ diag,
                        const T* __restrict__ xp, const T* __restrict__ b,
                        T* __restrict__ out, typename Acc<T>::type omega,
                        Geometry g) {
  using A = typename Acc<T>::type;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kDepth];

  const int w0 = 2 * g.p0 + 1, w1 = 2 * g.p1 + 1, w2 = 2 * g.p2 + 1;
  const int i0 = blockIdx.z * T0, j0 = blockIdx.y * T1, l0 = blockIdx.x * T2;
  const int e0 = min(T0, g.n0 - i0), e1 = min(T1, g.n1 - j0);
  const int e2 = min(T2, g.n2 - l0);
  const int64_t lanes = g.n2p - l0;             // packed lanes from l0 on
  const int r2 = lanes < T2 ? (int)lanes : T2;  // lane pitch of the slabs
  const int slab = w2 * e0 * e1 * r2;          // elements of one step
  const uint32_t slab_bytes = (uint32_t)(slab * sizeof(T));
  const int steps = w0 * w1;
  const int64_t terms = (int64_t)w0 * w1 * w2;
  const T* tile_band =
      blk + terms * ((int64_t)i0 * g.n1 * g.n2p +
                     (int64_t)e0 * ((int64_t)j0 * g.n2p + (int64_t)e1 * l0));
  const int pitch = w2 * T0 * T1 * T2;         // ring stage, in elements
  T* ring = reinterpret_cast<T*>(smem_raw);
  A* xw = reinterpret_cast<A*>(ring + kDepth * pitch);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kDepth; ++s) mbar_init(&full[s]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int s = 0; s < kDepth && s < steps; ++s)
      bulk_load(ring + s * pitch, tile_band + (int64_t)s * slab, slab_bytes,
                &full[s]);
  }

  // halo window of x_pad (zeros past the padded field on a ragged tile),
  // staged while the first slabs are in flight
  const int W1 = T1 + 2 * g.p1, W2 = T2 + 2 * g.p2;
  const int window = (T0 + 2 * g.p0) * W1 * W2;
  const int P0 = g.n0 + 2 * g.p0;
  const int64_t P1 = g.n1 + 2 * g.p1, P2 = g.n2 + 2 * g.p2;
  for (int e = threadIdx.x; e < window; e += blockDim.x) {
    const int q = e / (W1 * W2);
    const int rem = e - q * W1 * W2;
    const int jj = rem / W2;
    const int ll = rem - jj * W2;
    const int gq = i0 + q, gj = j0 + jj, gl = l0 + ll;
    xw[e] = (gq < P0 && gj < P1 && gl < P2)
                ? up(xp[((int64_t)gq * P1 + gj) * P2 + gl])
                : A(0);
  }
  __syncthreads();

  const int tl = threadIdx.x % T2, tj = threadIdx.x / T2;
  const bool live = tj < e1 && tl < e2;  // every thread keeps the barriers
  const int xstep = W1 * W2;
  const int kstep = e0 * e1 * r2;          // one k2 in a slab
  const int istep = e1 * r2;               // one plane in a slab

  A acc[T0];
#pragma unroll
  for (int i = 0; i < T0; ++i) acc[i] = A(0);

  for (int s = 0; s < steps; ++s) {
    const int stage = s % kDepth;
    mbar_wait(&full[stage], (uint32_t)((s / kDepth) & 1));
    if (live) {
      const int k0 = s / w1, k1 = s - k0 * w1;
      const T* sl = ring + stage * pitch + tj * r2 + tl;
      const A* xrow = xw + (k0 * W1 + tj + k1) * W2 + tl;
      for (int k2 = 0; k2 < w2; ++k2) {
#pragma unroll
        for (int i = 0; i < T0; ++i) {
          if (i < e0)
            acc[i] += up(sl[k2 * kstep + i * istep]) * xrow[i * xstep + k2];
        }
      }
    }
    __syncthreads();  // stage s % kDepth has been read by every thread
    if (threadIdx.x == 0 && s + kDepth < steps) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      bulk_load(ring + stage * pitch, tile_band + (int64_t)(s + kDepth) * slab,
                slab_bytes, &full[stage]);
    }
  }
  if (!live) return;

  const int gj = j0 + tj, gl = l0 + tl;
  const int64_t plane_i = (int64_t)g.n1 * g.n2;
  const int64_t pt0 = ((int64_t)i0 * g.n1 + gj) * g.n2 + gl;
#pragma unroll
  for (int i = 0; i < T0; ++i) {
    if (i >= e0) break;
    const int64_t pt = pt0 + i * plane_i;
    A y = acc[i];
    if (g.mode != kSpmv) {
      const int gi = i0 + i;
      const A bv = up(b[gi * g.bs0 + gj * g.bs1 + gl * g.bs2]);
      if (g.mode == kResidual) {
        y = bv - y;
      } else {
        const A xc = xw[((i + g.p0) * W1 + tj + g.p1) * W2 + tl + g.p2];
        const A d = up(diag[pt]);
        if (g.mode == kJacobi) {
          y = xc + omega * (bv - y) / d;
        } else {
          const bool on = ((g.pbase + gi + gj + gl) & 1) == g.color;
          y = on ? (A(1) - omega) * xc + omega * ((bv - (y - d * xc)) / d)
                 : xc;
        }
      }
    }
    store(out + pt, y);
  }
}

template <typename T, int T0, int T1, int T2>
int launch_tiles(const T* blk, const T* diag, const T* xp, const T* b, T* out,
                 typename Acc<T>::type omega, const Geometry& g,
                 void* stream) {
  const size_t ring = (size_t)kDepth * (2 * g.p2 + 1) * T0 * T1 * T2;
  const size_t window =
      (size_t)(T0 + 2 * g.p0) * (T1 + 2 * g.p1) * (T2 + 2 * g.p2);
  const size_t bytes =
      ring * sizeof(T) + window * sizeof(typename Acc<T>::type);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        stencil_apply_v2_kernel<T, T0, T1, T2>,
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
  stencil_apply_v2_kernel<T, T0, T1, T2>
      <<<grid, T1 * T2, bytes, (cudaStream_t)stream>>>(blk, diag, xp, b, out,
                                                       omega, g);
  const cudaError_t err = cudaGetLastError();  // also clears a refusal
  return (int)err;
}

template <typename T>
int launch(const T* blk, const T* diag, const T* xp, const T* b, T* out,
           typename Acc<T>::type omega, int n0, int n1, int n2, int p0,
           int p1, int p2, int t0,
           int t1, int t2, int64_t bs0, int64_t bs1, int64_t bs2, int mode,
           int color, int64_t pbase, void* stream) {
  if (mode < kSpmv || mode > kRbgs || n0 < 1 || n1 < 1 || n2 < 1 ||
      p0 < 0 || p1 < 0 || p2 < 0)
    return (int)cudaErrorInvalidValue;
  const int64_t align = 16 / sizeof(T);
  const int64_t n2p = (n2 + align - 1) / align * align;
  const Geometry g{n0,  n1,  n2,   p0,    p1,    p2,   n2p,
                   bs0, bs1, bs2, mode, color, pbase};
  // the tiles of ops/stencil_v2.py::tile_v2, which packed the band
  if (t0 == 1 && t1 == 1 && t2 == 256)
    return launch_tiles<T, 1, 1, 256>(blk, diag, xp, b, out, omega, g, stream);
  if (t0 == 1 && t1 == 8 && t2 == 32)
    return launch_tiles<T, 1, 8, 32>(blk, diag, xp, b, out, omega, g, stream);
  if (t0 == 2 && t1 == 8 && t2 == 32)
    return launch_tiles<T, 2, 8, 32>(blk, diag, xp, b, out, omega, g, stream);
  if (t0 == 4 && t1 == 8 && t2 == 32)
    return launch_tiles<T, 4, 8, 32>(blk, diag, xp, b, out, omega, g, stream);
  if (t0 == 1 && t1 == 4 && t2 == 32)  // wide bands (f64 at p = 8)
    return launch_tiles<T, 1, 4, 32>(blk, diag, xp, b, out, omega, g, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

int stencil_apply_v2_f32(const float* blk, const float* diag, const float* xp,
                         const float* b, float* out, float omega, int n0,
                         int n1, int n2, int p0, int p1, int p2, int t0,
                         int t1, int t2, int64_t bs0, int64_t bs1,
                         int64_t bs2, int mode, int color, int64_t pbase,
                         void* stream) {
  return launch<float>(blk, diag, xp, b, out, omega, n0, n1, n2, p0, p1, p2,
                       t0, t1, t2, bs0, bs1, bs2, mode, color, pbase, stream);
}

int stencil_apply_v2_f64(const double* blk, const double* diag,
                         const double* xp, const double* b, double* out,
                         double omega, int n0, int n1, int n2, int p0, int p1,
                         int p2, int t0, int t1, int t2, int64_t bs0,
                         int64_t bs1, int64_t bs2, int mode, int color,
                         int64_t pbase, void* stream) {
  return launch<double>(blk, diag, xp, b, out, omega, n0, n1, n2, p0, p1, p2,
                        t0, t1, t2, bs0, bs1, bs2, mode, color, pbase,
                        stream);
}

// blk, diag, xp, b and out are bfloat16 arrays; the arithmetic is f32
int stencil_apply_v2_bf16(const void* blk, const void* diag, const void* xp,
                          const void* b, void* out, float omega, int n0,
                          int n1, int n2, int p0, int p1, int p2, int t0,
                          int t1, int t2, int64_t bs0, int64_t bs1,
                          int64_t bs2, int mode, int color, int64_t pbase,
                          void* stream) {
  using B = __nv_bfloat16;
  return launch<B>((const B*)blk, (const B*)diag, (const B*)xp, (const B*)b,
                   (B*)out, omega, n0, n1, n2, p0, p1, p2, t0, t1, t2, bs0,
                   bs1, bs2, mode, color, pbase, stream);
}

const char* stencil_apply_v2_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

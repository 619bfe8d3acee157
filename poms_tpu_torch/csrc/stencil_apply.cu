// Banded stencil apply (K2) in four modes, for 3D fields (1D and 2D fields
// are lifted to 3D by the wrapper, ops/stencil.py::k2_lift, with zero pads
// on the lifted axes):
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
// contiguous grid-shaped array of N = n0 n1 n2 values, read in place (no
// pack, unlike K3).  x_pad is the ghost-padded field (n0 + 2p0, n1 + 2p1,
// n2 + 2p2) with ghosts already filled (zeros or the periodic wrap), so the
// kernel needs no boundary logic; b may be strided.  diag is the centre
// plane band_t[p0, p1, p2].
//
// What bounds it on an H100: every apply streams the whole band once,
// (2p+1)^3 coefficients per point (343 at p = 3), against one read of x and
// one write of the output, so device-memory bandwidth (3.35 TB/s) at about
// 2 flops per band byte in f32.
//
// Design.  The work split has no idle lanes on 2^k+1 grids: a block owns T0
// axis-0 planes and, in each, one contiguous run of the raveled (i1, i2)
// index of at most kThreads points.  When a row is shorter than a block
// (n2 < kThreads) the runs cross rows: the M = n1 n2 points of a plane are
// cut into ceil(M / kThreads) runs whose lengths differ by at most one (252
// and 253 at 129^3); longer rows are cut the same way, row by row.  A block
// has G groups of threads (two at T0 = 4), each the whole warps of the
// longest run, one point a thread and T0 / G planes (accumulators in
// registers), so idle lanes sit in a group's last warp only; and one more
// warp that copies the band.  In every coefficient plane a block reads T0
// contiguous runs, each as its 16-byte-aligned superset (4 f32, 2 f64 or 8
// bf16 values per 16 bytes): one bulk asynchronous copy a run
// (cp.async.bulk, TMA's 1D form), a lane of the copying warp a copy, into a
// ring of `depth` shared-memory stages of one (k0, k1) offset pair each.  A
// stage's copies complete on its `full` mbarrier; each computing warp
// arrives on its `empty` mbarrier when done with it, and the copying warp
// refills it then, so no thread spends issue slots on band loads and the
// computing warps never wait at a block-wide barrier.  Every sector fetched
// is used except at a run's two ends.  N is odd on a 2^k+1 grid, so each
// plane's run starts at its own offset inside its aligned superset; the
// arithmetic reads the coefficients from shared memory at that offset,
// advanced by N mod (16 / sizeof(T)) from plane to plane.  The x window
// (the rows of x_pad that the run and its offsets reach, T0 + 2p0 planes
// of them) is staged once per block in the arithmetic type while the first
// stages are in flight.  At p = 3 the axis-2 loop is unrolled at compile
// time.  Each point sums its terms in the plain version's offset order
// (itertools.product); the mode's epilogue runs once per point.  The
// geometry (lift, runs, window, ring depth, planes a block: four where the
// grid gives two blocks an SM at least, else one) is computed by the
// wrapper (ops/stencil.py::k2_plan) and passed in; indices and plane
// strides are 64-bit: the 129^3 p = 3 band has 736 M elements.  At 129^3
// p = 3 a block of the f32 build takes 107 KB of shared memory (two 29 KB
// stages and a 49 KB window): two blocks, 34 warps an SM.
//
// What the measurements taught (bench/k2_compare.py, NVIDIA H100 80GB HBM3,
// 700 W, 129^3 p3 spmv): with 256-thread blocks and block-wide barriers a
// step, the kernel took 1.23 ms in f32 and in bf16 alike, whether the band
// came by bulk copies or by 16-byte cp.async from every thread; with the
// copies compiled out it still took 0.76 ms, so the arithmetic loop, not
// the copies, held it.  The unrolled axis-2 loop with a fixed slot pitch
// gave 1.12 / 1.10 ms, two thread groups (twice the warps) 1.03 / 0.89, the
// copying warp with full/empty barriers 1.07 / 0.83 in a call where the
// version before gave 1.08 / 0.90.
//
// Types: f32 and f64 compute in their own type.  In bf16 (the TPU engine's
// second type) the band, x_pad, b and the output are __nv_bfloat16 and the
// (2p+1)^d sum and the epilogue are f32, rounded once on the store: the
// storage type T and the arithmetic type Acc<T> are separate.  The ring
// holds the band as it is stored (a bulk copy moves bytes, so one copy
// moves 8 bf16 values per 16 bytes); the x window holds the arithmetic
// type (a value is converted once at the fill and read up to (2p+1)^3
// times).  The TPU kernel sums in its operand type (its accumulator has the
// band's dtype), so in bf16 it rounds after every multiply-add; this
// kernel's f32 sum is at least as exact and is not bitwise with it.
//
// The same template, with one part of the inner loop changed at compile
// time, is the kernel-limit probes K4c and K4a (stencil_probe_f32, spmv
// mode, f32, 3D):
//   compute  (K4c, replaces poms_tpu/bench/kernel_probe.py::probe_compute)
//            every block copies the band runs of block (0, 0) (planes
//            0..T0-1, raveled points 0..len-1), so the band comes from L2
//            and the time is K2's copies, arithmetic, shared-memory reads
//            and x window without the band stream from device memory;
//   noshift, nolane, nomul  (K4a, replaces probe_ablate): the axis-1 x
//            offset held at 0, the axis-2 x offset held at 0, or no band
//            copied or read (acc += x).  Their results are deliberately not
//            the SpMV.

#include <cuda_runtime.h>
#include <stdint.h>

#include "storage.cuh"

namespace {

using io::Acc;
using io::store;
using io::up;

enum Mode { kSpmv = 0, kResidual = 1, kJacobi = 2, kRbgs = 3 };
// K2 itself, and the probes' changes to its inner loop
enum Variant { kFull = 0, kPinBand = 1, kNoShift = 2, kNoLane = 3,
               kNoMul = 4 };
constexpr int kThreads = 256;  // points of a run: one a thread
constexpr int kMaxDepth = 4;   // ring stages

struct Geometry {
  int n0, n1, n2, p0, p1, p2;
  int64_t bs0, bs1, bs2;  // strides of b, in elements
  int mode, color;
  int64_t pbase;          // global index sum of the field's first point
  // the launch plan (ops/stencil.py::k2_plan)
  int rl;     // longest run (points a block owns in each of its planes)
  int m2;     // runs per row, or 0: runs cross rows
  int wj, wc; // x window rows per plane and row width
  int rp;     // ring slot pitch, elements: pitch<T>()
  int depth;  // ring stages
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
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

// one bulk copy of `bytes` (a multiple of 16, both addresses 16-aligned)
// from global to shared memory, completing on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// a ring slot: the aligned superset of a run of up to kThreads values at any
// offset in its first 16 bytes
template <typename T>
__host__ __device__ constexpr int pitch() {
  return (16 / (int)sizeof(T) - 1 + kThreads + 16 / (int)sizeof(T) - 1) /
         (16 / (int)sizeof(T)) * (16 / (int)sizeof(T));
}

// T0 planes a block, G groups of threads with T0 / G planes each; W2: the
// offsets along axis 2 (2 p2 + 1) at compile time, or 0 (any)
template <typename T, int T0, int G, int V, int W2>
__global__ void __launch_bounds__(G * kThreads + 32)
stencil_apply_kernel(const T* __restrict__ band, const T* __restrict__ xp,
                     const T* __restrict__ b, T* __restrict__ out,
                     typename Acc<T>::type omega, Geometry g) {
  using A = typename Acc<T>::type;
  constexpr int kVec = 16 / sizeof(T);  // values per 16 bytes
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kMaxDepth], empty[kMaxDepth];

  constexpr int kPitch = pitch<T>();
  const int w0 = 2 * g.p0 + 1, w1 = 2 * g.p1 + 1;
  const int w2 = W2 > 0 ? W2 : 2 * g.p2 + 1;
  const int64_t M = (int64_t)g.n1 * g.n2;  // points of one axis-0 plane
  const int64_t N = M * g.n0;              // one band plane
  const int i0 = blockIdx.y * T0;
  const int rows = min(T0, g.n0 - i0);
  // this block's run of the raveled (i1, i2) index: the plane (or each
  // row) cut into runs whose lengths differ by at most one
  int64_t q0;
  int len;
  if (g.m2 == 0) {
    const int64_t base = M / gridDim.x, rem = M - base * gridDim.x;
    const int64_t r = blockIdx.x;
    q0 = r * base + min(r, rem);
    len = (int)(base + (r < rem));
  } else {
    const int j = blockIdx.x / g.m2, c = blockIdx.x - j * g.m2;
    const int base = g.n2 / g.m2, rem = g.n2 - base * g.m2;
    q0 = (int64_t)j * g.n2 + (int64_t)c * base + min(c, rem);
    len = base + (c < rem);
  }
  const int j_first = (int)(q0 / g.n2);
  const int c_lo = g.m2 == 0 ? 0 : (int)(q0 - (int64_t)j_first * g.n2);
  // the compute probe copies the runs of block (0, 0) instead of its own
  const int64_t band_i0 = V == kPinBand ? 0 : i0;
  const int64_t band_q0 = V == kPinBand ? 0 : q0;
  // band's own place in its 16-byte granule (0 for a tensor of its own):
  // element e of the band lies at offset (e + lead) mod kVec of a granule
  const int lead = (int)(((uintptr_t)band / sizeof(T)) & (kVec - 1));
  const T* granules = band - lead;

  const int stage_elems = w2 * T0 * kPitch;
  T* ring = reinterpret_cast<T*>(smem_raw);
  A* xw = reinterpret_cast<A*>(smem_raw + (size_t)g.depth * stage_elems *
                                              sizeof(T));
  const int steps = w0 * w1;
  const int copies = w2 * rows;  // runs of one (k0, k1) step
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // the last warp copies the band, the others compute
  const int consumers = blockDim.x - 32;
  const bool producer = (int)threadIdx.x >= consumers;

  // the producer warp: step s into its stage, one bulk copy a run of the
  // step (the aligned superset of run (k2, plane i) into slot k2 T0 + i), a
  // lane a copy, completing on the stage's full barrier
  auto issue = [&](int s) {
    const int stage = s % g.depth;
    T* dst0 = ring + stage * stage_elems;
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    uint32_t total = 0;
    for (int c = lane; c < copies; c += 32) {
      const int k2 = c / rows, i = c - k2 * rows;
      const int64_t e = (int64_t)(s * w2 + k2) * N + (band_i0 + i) * M +
                        band_q0 + lead;
      total += (uint32_t)(((e & (kVec - 1)) + len + kVec - 1) / kVec) * 16u;
    }
    total = __reduce_add_sync(0xffffffffu, total);
    if (lane == 0) mbar_expect(&full[stage], total);
    __syncwarp();
    for (int c = lane; c < copies; c += 32) {
      const int k2 = c / rows, i = c - k2 * rows;
      const int64_t e = (int64_t)(s * w2 + k2) * N + (band_i0 + i) * M +
                        band_q0 + lead;
      const int64_t a = e & ~(int64_t)(kVec - 1);
      const uint32_t bytes =
          (uint32_t)(((e - a) + len + kVec - 1) / kVec) * 16u;
      bulk_copy(dst0 + (k2 * T0 + i) * kPitch, granules + a, bytes,
                &full[stage]);
    }
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < g.depth; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], consumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (V != kNoMul && producer) {
    for (int s = 0; s < g.depth && s < steps; ++s) issue(s);
  }

  // the x window, while the first stages are in flight: rows of x_pad,
  // planes i0 .. i0 + T0 + 2p0 - 1, rows j_first .. j_first + wj - 1,
  // columns c_lo .. c_lo + wc - 1 (zeros past the padded field); a warp a
  // row, its lanes along the row
  const int P0 = g.n0 + 2 * g.p0;
  const int P1 = g.n1 + 2 * g.p1, P2 = g.n2 + 2 * g.p2;
  const int xrows = (T0 + 2 * g.p0) * g.wj;
  for (int r = warp; r < xrows; r += blockDim.x / 32) {
    const int q = r / g.wj, gq = i0 + q, gj = j_first + (r - q * g.wj);
    const bool in = gq < P0 && gj < P1;
    const T* src = xp + ((int64_t)gq * P1 + gj) * P2 + c_lo;
    A* dst = xw + r * g.wc;
    for (int cc = lane; cc < g.wc; cc += 32)
      dst[cc] = (in && c_lo + cc < P2) ? up(src[cc]) : A(0);
  }
  __syncthreads();  // the last block-wide barrier

  if (producer) {   // refill each stage once every consumer warp is done
    if (V != kNoMul) {
      for (int s = g.depth; s < steps; ++s) {
        mbar_wait(&empty[s % g.depth], (uint32_t)((s / g.depth - 1) & 1));
        issue(s);
      }
    }
    return;
  }

  // this thread: point t of the run in planes i = grp IPT .. grp IPT + IPT - 1
  constexpr int IPT = T0 / G;
  const int tpg = consumers / G, grp = threadIdx.x / tpg;
  const int t = threadIdx.x - grp * tpg, ib = grp * IPT;
  const bool live = t < len && ib < rows;
  const int64_t qt = q0 + t;
  const int gj = (int)(qt / g.n2), gl = (int)(qt - (int64_t)gj * g.n2);
  const int xplane = g.wj * g.wc;
  const int xbase = (gj - j_first) * g.wc + (gl - c_lo);
  // a run's byte offset in its aligned superset, kept from plane to plane:
  // (k N + (i0 + i) M + q0 + lead) mod kVec values, advanced by N mod kVec
  const int n_bytes = (int)(N & (kVec - 1)) * (int)sizeof(T);
  int off[IPT];
#pragma unroll
  for (int il = 0; il < IPT; ++il)
    off[il] = (int)(((band_i0 + ib + il) * M + band_q0 + lead) &
                    (kVec - 1)) * (int)sizeof(T);

  A acc[IPT];
#pragma unroll
  for (int il = 0; il < IPT; ++il) acc[il] = A(0);

  // the step's offsets (k0, k1), its stage and the stage's phase, counted
  // rather than divided out
  int k0 = 0, k1 = 0, stage = 0;
  uint32_t phase = 0;
  const unsigned char* ring_t =
      reinterpret_cast<const unsigned char*>(ring + t);
  for (int s = 0; s < steps; ++s) {
    if (V != kNoMul) mbar_wait(&full[stage], phase);
    if (live) {
      const int s1 = V == kNoShift ? 0 : k1;
      const unsigned char* st = ring_t + stage * stage_elems * sizeof(T);
      const A* xr = xw + k0 * xplane + s1 * g.wc + xbase + ib * xplane;
#pragma unroll
      for (int k2 = 0; k2 < w2; ++k2) {
        const int s2 = V == kNoLane ? 0 : k2;
#pragma unroll
        for (int il = 0; il < IPT; ++il) {
          if (ib + il < rows) {
            const A xv = xr[il * xplane + s2];
            if (V == kNoMul) {
              acc[il] += xv;
            } else {
              const T c = *reinterpret_cast<const T*>(
                  st + ((k2 * T0 + ib + il) * kPitch) * sizeof(T) + off[il]);
              acc[il] += up(c) * xv;
            }
          }
          off[il] = (off[il] + n_bytes) & 15;
        }
      }
    }
    __syncwarp();  // this warp has read the stage
    if (V != kNoMul && lane == 0) mbar_arrive(&empty[stage]);
    if (++k1 == w1) k1 = 0, ++k0;
    if (++stage == g.depth) stage = 0, phase ^= 1u;
  }
  if (!live) return;

  const int64_t centre = ((int64_t)g.p0 * w1 + g.p1) * w2 + g.p2;
#pragma unroll
  for (int il = 0; il < IPT; ++il) {
    const int i = ib + il;
    if (i >= rows) break;
    const int gi = i0 + i;
    const int64_t pt = (int64_t)gi * M + qt;
    A y = acc[il];
    if (g.mode != kSpmv) {
      const A bv = up(b[gi * g.bs0 + gj * g.bs1 + gl * g.bs2]);
      if (g.mode == kResidual) {
        y = bv - y;
      } else {
        const A xc = xw[(i + g.p0) * xplane + g.p1 * g.wc + g.p2 + xbase];
        const A d = up(band[centre * N + pt]);
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

// thread groups of a T0-plane block: two of two planes at T0 = 4
template <int T0>
constexpr int kGroups = T0 >= 4 ? 2 : 1;

template <typename T, int T0, int V = kFull, int W2 = 0>
int launch_plan(const T* band, const T* xp, const T* b, T* out,
                typename Acc<T>::type omega, const Geometry& g,
                void* stream) {
  const int w2 = 2 * g.p2 + 1;
  const size_t ring = (size_t)g.depth * w2 * T0 * pitch<T>() * sizeof(T);
  const size_t bytes = ring + (size_t)(T0 + 2 * g.p0) * g.wj * g.wc *
                                  sizeof(typename Acc<T>::type);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        stencil_apply_kernel<T, T0, kGroups<T0>, V, W2>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear it, or the next launch reports it
      return (int)err;
    }
  }
  const int64_t M = (int64_t)g.n1 * g.n2;
  const int64_t runs = g.m2 == 0 ? (M + g.rl - 1) / g.rl
                                 : (int64_t)g.n1 * g.m2;
  const dim3 grid((unsigned)runs, (g.n0 + T0 - 1) / T0);
  if (runs > 0x7fffffff || grid.y > 65535)
    return (int)cudaErrorInvalidConfiguration;
  // each group the whole warps of the longest run (idle lanes in a group's
  // last warp only), and the copying warp
  const int threads = kGroups<T0> * ((g.rl + 31) / 32 * 32) + 32;
  stencil_apply_kernel<T, T0, kGroups<T0>, V, W2>
      <<<grid, threads, bytes, (cudaStream_t)stream>>>(band, xp, b, out,
                                                       omega, g);
  return (int)cudaGetLastError();
}

// the axis-2 width at compile time where it is the cubic splines' 7
template <typename T, int T0, int V = kFull>
int launch_w2(const T* band, const T* xp, const T* b, T* out,
              typename Acc<T>::type omega, const Geometry& g, void* stream) {
  if (2 * g.p2 + 1 == 7)
    return launch_plan<T, T0, V, 7>(band, xp, b, out, omega, g, stream);
  return launch_plan<T, T0, V, 0>(band, xp, b, out, omega, g, stream);
}

// the plan's sanity: what the kernel's indexing assumes
template <typename T>
bool plan_ok(const Geometry& g) {
  if (g.n0 < 1 || g.n1 < 1 || g.n2 < 1 || g.p0 < 0 || g.p1 < 0 || g.p2 < 0)
    return false;
  return g.rl >= 1 && g.rl <= kThreads && g.m2 >= 0 && g.depth >= 1 &&
         g.depth <= kMaxDepth && g.wj >= 1 && g.wc >= 1 &&
         g.rp == pitch<T>();
}

template <typename T>
int launch(const T* band, const T* xp, const T* b, T* out,
           typename Acc<T>::type omega, const int* dims, const int* plan,
           const int64_t* bstr, int mode, int color, int64_t pbase,
           void* stream) {
  const Geometry g{dims[0], dims[1], dims[2], dims[3], dims[4], dims[5],
                   bstr[0], bstr[1], bstr[2], mode, color, pbase,
                   plan[1], plan[2], plan[3], plan[4], plan[5], plan[6]};
  if (mode < kSpmv || mode > kRbgs || !plan_ok<T>(g))
    return (int)cudaErrorInvalidValue;
  const int t0 = plan[0];
  if (t0 == 1) return launch_w2<T, 1>(band, xp, b, out, omega, g, stream);
  if (t0 == 4) return launch_w2<T, 4>(band, xp, b, out, omega, g, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dims: n0, n1, n2, p0, p1, p2 (lifted).  plan: t0, rl, m2, wj, wc, rp,
// depth (ops/stencil.py::k2_plan).  bstr: strides of b.
int stencil_apply_f32(const float* band, const float* xp, const float* b,
                      float* out, float omega, const int* dims,
                      const int* plan, const int64_t* bstr, int mode,
                      int color, int64_t pbase, void* stream) {
  return launch<float>(band, xp, b, out, omega, dims, plan, bstr, mode,
                       color, pbase, stream);
}

int stencil_apply_f64(const double* band, const double* xp, const double* b,
                      double* out, double omega, const int* dims,
                      const int* plan, const int64_t* bstr, int mode,
                      int color, int64_t pbase, void* stream) {
  return launch<double>(band, xp, b, out, omega, dims, plan, bstr, mode,
                        color, pbase, stream);
}

// band, xp, b and out are bfloat16 arrays; the arithmetic is f32
int stencil_apply_bf16(const void* band, const void* xp, const void* b,
                       void* out, float omega, const int* dims,
                       const int* plan, const int64_t* bstr, int mode,
                       int color, int64_t pbase, void* stream) {
  using B = __nv_bfloat16;
  return launch<B>((const B*)band, (const B*)xp, (const B*)b, (B*)out, omega,
                   dims, plan, bstr, mode, color, pbase, stream);
}

// the probes: spmv mode, f32, 3D, K2's plan for the shape (its t0 must be
// 4 and n0 >= 4, so block (0, 0) is whole); variant is a Variant
int stencil_probe_f32(int variant, const float* band, const float* xp,
                      float* out, const int* dims, const int* plan,
                      void* stream) {
  const Geometry g{dims[0], dims[1], dims[2], dims[3], dims[4], dims[5],
                   0, 0, 0, kSpmv, 0, 0,
                   plan[1], plan[2], plan[3], plan[4], plan[5], plan[6]};
  if (plan[0] != 4 || g.n0 < 4 || !plan_ok<float>(g))
    return (int)cudaErrorInvalidValue;
  switch (variant) {
    case kFull:
      return launch_w2<float, 4, kFull>(band, xp, nullptr, out, 0.f, g,
                                        stream);
    case kPinBand:
      return launch_w2<float, 4, kPinBand>(band, xp, nullptr, out, 0.f, g,
                                           stream);
    case kNoShift:
      return launch_w2<float, 4, kNoShift>(band, xp, nullptr, out, 0.f, g,
                                           stream);
    case kNoLane:
      return launch_w2<float, 4, kNoLane>(band, xp, nullptr, out, 0.f, g,
                                          stream);
    case kNoMul:
      return launch_w2<float, 4, kNoMul>(band, xp, nullptr, out, 0.f, g,
                                         stream);
  }
  return (int)cudaErrorInvalidValue;
}

const char* stencil_apply_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

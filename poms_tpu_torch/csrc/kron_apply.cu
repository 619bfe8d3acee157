// K1: the fused Kronecker-sum apply on unpadded 3D fields,
//   A x = sum_r (B_r0 (x) B_r1 (x) B_r2) x,
// with four epilogues chosen at launch:
//   apply     y = A x (+ acc)
//   residual  r = b - A x
//   dinv      y = (A x) / diag(A)
//   cheb      z = (b - A x) / diag(A);  d <- c1 d + c2 z;  x_new = x + d
//
// Replaces the TPU kernel poms_tpu/ops/pallas/kron.py::kron_apply_pallas
// (body _make_kernel, launch _call) and the elementwise passes its callers
// ran around it.  Each B_ra is a 1D band of shape (n_a, 2P+1): row i
// multiplies x[i + t - P], t in [0, 2P], zero or wrapped outside the grid.
//
// What bounds it on an H100: the bytes.  apply reads x and writes y once
// (8 bytes per point in f32: 5.1 us at 129^3 at 3.35 TB/s), cheb moves five
// fields (12.8 us; 0.81 ms at 513^3); the ~55 multiply-adds per point stay
// on chip, and below about 65^3 the launch itself is the bound.  What the
// kernel is held back by in practice is instruction issue and latency
// between block barriers, so everything below is about fewer barriers and
// instructions per point and more independent work per thread.
//
// Design.  A block owns a T1 x T2 column of the (axis 1, axis 2) grid and
// marches over a run of axis-0 planes: cp.async window loads (T1 + 2P rows
// by T2 + 2P columns) into a ring of buffers, index rules instead of a
// padded copy (a table of the window's in-plane source offsets, int32).
// A thread owns a register micro-tile of R rows by C columns (R, 2 or 1, a
// template parameter the host's tile model picks per grid; columns<T>():
// two by two in f32 on the fine grids), and a row group's threads are
// consecutive, so a tile 64 columns wide puts one row group in a warp.
// Step q of the march, one block barrier:
//   axis 2: the axis-2 pass of plane q + 1: each thread contracts its own
//           columns of the window for the distinct axis-2 bands, over the
//           window rows of its row group's turn (u partials, into the
//           shared buffer the last step did not read); its band rows sit in
//           registers for the whole march;
//   axis 1: plane q: each thread contracts the R + 2P u rows of its group
//           for the distinct (u, axis-1 band) pairs (v partials, in
//           registers): every u pair it reads serves R rows, and the band
//           rows come from a table in shared memory laid out so that one
//           vector read holds a tap's coefficients for the R rows;
//   sum:    the v's that meet the same axis-0 band are added first, so
//           Poisson needs 2 + 3 + 2 contractions instead of 9;
//   axis 0: plane q of those sums is added, tap by tap, to the 2P+1 output
//           planes it reaches, which are accumulated in registers (a ring,
//           shifted each step: unrolling the march by 2P+1 to index it
//           statically measured slower in cheb, whose unrolled loop is
//           several times the size); the band rows of this run of planes
//           come from shared memory.  Plane q - P is then complete;
//   epilogue: its operands b and d are asked for at the top of the step,
//           so they arrive under the arithmetic; x is read from the
//           window of its plane, which the ring keeps P + 1 planes longer
//           than the axis-2 pass needs it (cheb then reads four fields
//           from device memory, not five); the diagonal's centre
//           columns come from small tables in shared memory.
// The arithmetic has no branches on the plan: an absent partial has zero band
// rows, and a zero ghost plane is a window of zeros, so the chains of
// multiply-adds of all partials interleave.  The mode is a template
// parameter (no epilogue code of another mode in the loop).  No plane is
// recomputed along axis 0 except the 2P planes where two runs meet.  The
// host splits axis 0 into runs and picks the tile and R from a cost model
// fitted to a sweep on the card (ops/kron.py::k1_tiling).
//
// The sharing plan (which band each partial uses, which v's are summed) is
// built once per operator on the host and arrives as a few integers.  One
// launch holds up to kCU u's, kCV v's and kCG sums; an operator that needs
// more is applied in several launches chained through `acc`.  The diagonal
// is formed in the kernel from the bands' centre columns,
// sum_r (c0[r,i] * c1[r,j]) * c2[r,l], with no fused multiply-add, so it has
// the bits of the operator's diagonal() and no diagonal array is read.
//
// Types: f32 and f64 compute in their own type.  bf16 is an instantiation of
// this carrier, not a port: the TPU kernel is f32 only and the JAX package's
// bf16 cycle runs its Kronecker apply through XLA.  There the fields (x, b,
// d, the outputs) and the bands are __nv_bfloat16 (IO) and everything on chip
// is f32 (T): the window takes converted values by plain loads
// (kron_march.cuh::load_window: no cp.async for 2-byte elements), the bands
// are converted as they are read into registers and shared memory, the
// arithmetic is the f32 kernel's, and the epilogue rounds once on the store
// (cheb: x + d is formed from the unrounded d).  Where an operator takes
// several launches the sum between them (acc, out_hi) stays f32.
//
// One route per half-width (ops/kron.py::COMPILED_P): every dtype is
// compiled at half-widths 1, 2 and 3, and bands up to 3 wide are padded to
// the widest of them; every wider band runs on K1r at its own half-width,
// which stepped the headline solve faster than this kernel from spline
// degree 4 on (NVIDIA H100 80GB HBM3).
//
// K1r (k1r_pass_a/b/c, entries kron_apply_rt_*): bands wider than the
// compiled half-widths, the half-width a launch argument, as three one-axis
// passes through the plan's scratch in device memory (kron_pass.cuh), the
// structure of the JAX reference's residual_kron_df:
//   A (axis 2): x -> the u partials (kCU fields of T);
//   B (axis 1): u -> the pre-summed partials wsum (kCG fields), the v's
//               summed with g_mult in order as K1 sums them;
//   C (axis 0): wsum -> A x, then the mode's epilogue, K1's own.
// What bounds it on an H100: its bytes (x once, 4 + 4 fields of scratch
// written and read, the epilogue's fields), as long as each pass keeps the
// shared-memory pipe under its multiply-adds.  So a thread owns several
// outputs (register micro-tiles): in pass A two columns of kRowsA rows (a
// band pair serves kRowsA rows, a window pair two taps of two columns: half
// a shared-memory word a multiply-add in f32), in B and C kOutR outputs
// along the axis, whose inputs each serve kOutR outputs and whose band rows
// arrive as one broadcast vector per tap.  No ring, no recomputed halo: a
// pass's halo costs loads along its own axis.  The operations of each
// output and their order are the compiled kernel's: taps in order, the
// first two as one expression in pass A, the rest multiply-added; the v's
// summed in order; on axis 0 per tap each pre-summed partial in turn (a
// zero-padded tap or a ghost plane adds an exact zero); the diagonal from
// the centre columns without FMA; an f32 written to the scratch and read
// back is exact, so the scratch changes no output.  Its smallest block (one
// warp a pass) fits the card's shared memory up to the half-width
// ops/kron.py::widest_half_width finds for k1r_smem; wider bands are
// refused by the host (ops/kron.py::refuse_half_width).

#include "kron_march.cuh"
#include "kron_pass.cuh"

namespace {

using io::store;
using io::up;
using kron::Geometry;

constexpr int kCU = 2;  // u partials per launch (distinct axis-2 bands)
constexpr int kCV = 3;  // v partials per launch
constexpr int kCG = 2;  // pre-summed partials per launch (axis-0 bands)
constexpr int kRD = 3;  // terms whose diagonal columns a block tabulates
constexpr int kMaxThreads = 256;

enum Mode { kApply = 0, kResidual = 1, kDinv = 2, kCheb = 3 };

struct Plan {
  int nu, nv, ng;
  int u_lab[kCU];
  int v_src[kCV], v_lab[kCV];
  int g_lab[kCG];
  int g_mult[kCG][kCV];
};

// T: the arithmetic type; IO: the fields' and bands' storage type (T itself,
// or __nv_bfloat16 with T = float)
template <typename T, typename IO>
struct Args {
  const IO* x;
  const IO* band[3];  // per axis (labels, n_a, 2P+1)
  const IO* col[3];   // per axis (R, n_a): centre columns of every term
  const T* acc;       // A x of the terms of earlier launches, or null
  const IO* b;
  const IO* d_in;     // null on the first Chebyshev step
  IO* d_out;
  IO* out;
  T* out_hi;          // apply only: the result unrounded, instead of out
  T c1, c2;
  T gm[kCG][kCV];  // the plan's g_mult in T (zero for absent entries)
  int mode;
  Geometry g;
  Plan p;
};

// columns of the tile one thread owns: two where the registers allow it
// (f32), so that every shared-memory load of the axis-1 pass and every band
// coefficient of the axis-0 pass serves two points
template <typename T>
__host__ __device__ constexpr int columns() {
  return sizeof(T) == 4 ? 2 : 1;
}

// blocks that must fit an SM together: two where 128 registers a thread are
// enough (while one block waits at its barrier the other computes)
template <typename T>
__host__ __device__ constexpr int min_blocks() {
  return sizeof(T) == 4 ? 2 : 1;
}

__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}

// N neighbouring values of shared memory, two a load where T is float and
// N even (p then 8-byte aligned)
template <typename T, int N>
__device__ __forceinline__ void ld_run(const T* p, T (&v)[N]) {
  if constexpr (sizeof(T) == 4 && N % 2 == 0) {
#pragma unroll
    for (int k = 0; k < N; k += 2) {
      const float2 q = *reinterpret_cast<const float2*>(p + k);
      v[k] = q.x, v[k + 1] = q.y;
    }
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] = p[k];
  }
}

// N neighbouring values of shared memory, one load where they fill 16 bytes
// (p then 16-byte aligned)
template <typename T, int N>
__device__ __forceinline__ void ld_vec(const T* p, T (&v)[N]) {
  if constexpr (sizeof(T) == 4 && N == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else if constexpr (sizeof(T) == 8 && N == 2) {
    const double2 q = *reinterpret_cast<const double2*>(p);
    v[0] = q.x, v[1] = q.y;
  } else {
    ld_run<T, N>(p, v);
  }
}

// N neighbouring values into shared memory, as ld_run reads them
template <typename T, int N>
__device__ __forceinline__ void st_run(T* p, const T (&v)[N]) {
  if constexpr (sizeof(T) == 4 && N % 2 == 0) {
#pragma unroll
    for (int k = 0; k < N; k += 2)
      *reinterpret_cast<float2*>(p + k) = make_float2(v[k], v[k + 1]);
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) p[k] = v[k];
  }
}

__host__ __device__ constexpr size_t align16(size_t bytes) {
  return (bytes + 15) / 16 * 16;
}

// window buffers of the ring: the planes whose copies are in flight
// (kron::kStages ahead), and the P + 1 planes of the outputs still open,
// whose x the epilogue reads from them
template <int P>
__host__ __device__ constexpr int window_buffers() {
  return kron::kStages + P + 1;
}

// shared memory of the compiled kernel, by byte offset, each section
// 16-byte aligned (ops/kron.py::k1_smem_bytes mirrors it): the ring of
// windows, the u partials of two planes, the axis-1 band rows of the tile's
// rows, the axis-0 band rows of this run of planes, the diagonal's centre
// columns (axis 0 over the run, axis 1 over the tile's rows, axis 2 over its
// columns), the window's in-plane source offsets
template <typename T, int P, int R>
struct K1Smem {
  size_t win, u, c1, c0, dg, off, bytes;
  __host__ __device__ explicit K1Smem(const Geometry& g) {
    const size_t WR = g.T1 + 2 * P, WC = g.T2 + 2 * P, W = 2 * P + 1;
    const size_t e = sizeof(T);
    win = 0;
    u = align16(win + window_buffers<P>() * WR * WC * e);
    c1 = align16(u + 2 * kCU * WR * g.T2 * e);
    c0 = align16(c1 + kCV * g.T1 * (R + 2 * P) * e);
    dg = align16(c0 + kCG * (g.chunk + 4 * P) * W * e);
    off = align16(dg + kRD * (g.chunk + g.T1 + g.T2) * e);
    bytes = align16(off + WR * WC * sizeof(int));
  }
};

// values asked for at once by a thread filling a table of shared memory
constexpr int kFill = 4;

// dst[e] = value(e) for e < n, each thread taking e = tid, tid + nthreads,
// ...: kFill values are asked for before any is stored, so that their
// trips to memory overlap
template <typename T, typename F>
__device__ __forceinline__ void fill_table(T* dst, int n, F value) {
  for (int e0 = threadIdx.x; e0 < n; e0 += kFill * blockDim.x) {
    T v[kFill];
#pragma unroll
    for (int k = 0; k < kFill; ++k) {
      const int e = e0 + k * blockDim.x;
      v[k] = e < n ? value(e) : T(0);
    }
#pragma unroll
    for (int k = 0; k < kFill; ++k) {
      const int e = e0 + k * blockDim.x;
      if (e < n) dst[e] = v[k];
    }
  }
}

template <typename T, int P, int R, int MODE, typename IO>
__global__ void __launch_bounds__(kMaxThreads, min_blocks<T>())
kron_march_kernel(const Args<T, IO> a) {
  static_assert(R == 1 || R == 2);
  constexpr int W = 2 * P + 1;
  constexpr int C = columns<T>();
  constexpr int RH = R + 2 * P;  // u rows a row group's outputs reach
  constexpr int D = kron::kStages;    // planes a copy is started ahead
  constexpr int S = window_buffers<P>();
  constexpr bool need_b = MODE == kResidual || MODE == kCheb;
  constexpr bool need_dg = MODE == kDinv || MODE == kCheb;
  const Geometry& g = a.g;
  const Plan& pl = a.p;
  const int T1 = g.T1, T2 = g.T2;      // multiples of R and of C
  const int NC = T2 / C, NG = T1 / R;  // column groups, row groups
  const int WR = T1 + 2 * P, WC = T2 + 2 * P, NW = WR * WC;
  const int UB = kCU * WR * T2;  // one plane's u partials
  const int nthreads = blockDim.x;
  const int crows = g.chunk + 4 * P;  // rows of the axis-0 coefficient table
  const int nd = g.chunk + T1 + T2;   // entries of a term's diagonal table

  const K1Smem<T, P, R> L(g);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* win = reinterpret_cast<T*>(smem_raw + L.win);
  T* u = reinterpret_cast<T*>(smem_raw + L.u);
  T* c1t = reinterpret_cast<T*>(smem_raw + L.c1);
  T* c0s = reinterpret_cast<T*>(smem_raw + L.c0);
  T* dgt = reinterpret_cast<T*>(smem_raw + L.dg);
  int* soff = reinterpret_cast<int*>(smem_raw + L.off);

  const int tid = threadIdx.x;
  const int tg = tid / NC, tl = (tid - tg * NC) * C;  // row group, column
  const bool in_tile = tid < NG * NC;
  const int j0 = blockIdx.y * T1, l0 = blockIdx.x * T2;
  const int gj = j0 + tg * R, gl = l0 + tl;  // first row and column owned
  // rows and columns owned inside the grid
  const int nrow = in_tile ? min(R, g.n1 - gj) : 0;
  const int ncol = min(C, g.n2 - gl);
  const int i_begin = blockIdx.z * g.chunk;
  const int i_end = min(i_begin + g.chunk, g.n0);
  const int nu = pl.nu, nv = pl.nv, ng = pl.ng;
  const bool has_acc = a.acc != nullptr, has_d = a.d_in != nullptr;

  // input planes q in [i_begin - P, i_end + P): plane q lands in window
  // buffer (q - q_begin) % S, its copy started D steps before its axis-2
  // pass and kept until the epilogue of output plane q has read x; a zero
  // ghost plane is filled with zeros (one commit per plane, empty or not,
  // keeps the group count in step).  A thread copies the window elements
  // whose offsets it wrote, so the first copies start before any barrier.
  const int q_begin = i_begin - P, q_end = i_end + P;
  auto issue = [&](int q, int sb) {
    const int gq = q < q_end ? kron::resolve(q, g.n0, g.per0) : -2;
    T* dst = win + sb * NW;
    if (gq >= 0) {
      kron::load_window(dst, a.x + gq * g.s0, soff, NW, 0);
    } else if (gq == -1) {
      for (int e = tid; e < NW; e += nthreads) dst[e] = T(0);
    }
    kron::cp_async_commit();
  };
  kron::build_window_offsets(soff, g, P, j0, l0);
  for (int k = 0; k < D; ++k) issue(q_begin + k, k);

  // the tables, while the first planes arrive.  This thread's axis-2 band
  // rows at its columns (in registers for the march); an absent partial
  // has zero rows, so the arithmetic below needs no branches
  T c2r[kCU][C][W];
#pragma unroll
  for (int k = 0; k < kCU; ++k)
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int t = 0; t < W; ++t)
        c2r[k][c][t] =
            (k < nu && in_tile && gl + c < g.n2)
                ? up(a.band[2][((int64_t)pl.u_lab[k] * g.n2 + gl + c) * W + t])
                : T(0);
  // axis-0 band rows of output planes [i_begin - 2P, i_begin + chunk + 2P),
  // per pre-summed partial: zero outside the grid and for absent partials
  fill_table(c0s, kCG * crows * W, [&](int e) {
    const int gi = e / (crows * W);
    const int rem = e - gi * crows * W;
    const int i = i_begin - 2 * P + rem / W;
    const int64_t row = (int64_t)pl.g_lab[gi] * g.n0 + i;
    return (gi < ng && i >= 0 && i < g.n0) ? up(a.band[0][row * W + rem % W])
                                           : T(0);
  });
  // axis-1 band rows as the row groups read them:
  // c1t[((k * NG + grp) * RH + p) * R + r] multiplies u row p of group grp
  // for its output row r, tap p - r of band row j0 + grp * R + r; zero off
  // the band, past the grid and for absent partials
  fill_table(c1t, kCV * T1 * RH, [&](int e) {
    const int r = e % R, p = e / R % RH, kg = e / (R * RH);
    const int k = kg / NG, j = j0 + (kg - k * NG) * R + r, t = p - r;
    return (k < nv && j < g.n1 && t >= 0 && t < W)
               ? up(a.band[1][((int64_t)pl.v_lab[k] * g.n1 + j) * W + t])
               : T(0);
  });
  // the diagonal's centre columns of the first kRD terms: axis 0 at the
  // run's planes, axis 1 at the tile's rows, axis 2 at its columns
  if (need_dg) {
    fill_table(dgt, kRD * nd, [&](int e) {
      const int r = e / nd, m = e - r * nd;
      T c = T(0);
      if (r < g.R) {
        if (m < g.chunk) {
          if (i_begin + m < g.n0) c = up(a.col[0][r * g.n0 + i_begin + m]);
        } else if (m < g.chunk + T1) {
          const int j = j0 + m - g.chunk;
          if (j < g.n1) c = up(a.col[1][r * g.n1 + j]);
        } else {
          const int l = l0 + m - g.chunk - T1;
          if (l < g.n2) c = up(a.col[2][r * g.n2 + l]);
        }
      }
      return c;
    });
  }
  int uoff[kCV];  // where each v reads its u rows
#pragma unroll
  for (int k = 0; k < kCV; ++k)
    uoff[k] = ((k < nv ? pl.v_src[k] : 0) * WR + tg * R) * T2 + tl;

  // outs[s][r][c]: the sum so far of output plane q - P + s; plane q of
  // the pre-summed partials adds its tap to each of the W planes it reaches
  T outs[W][R][C];
#pragma unroll
  for (int s = 0; s < W; ++s)
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < C; ++c) outs[s][r][c] = T(0);

  // axis 2 of the plane in window wq into the u partials uq:
  // u[k][rr][l] = sum_t c2r[k][.][t] * window[rr][l + t] for the thread's C
  // columns l, over the window rows of its row group's turn
  auto axis2 = [&](const T* wq, T* uq) {
    if (!in_tile) return;
    for (int rr = tg; rr < WR; rr += NG) {
      T xv[W + C - 1];
      ld_run<T, W + C - 1>(wq + rr * WC + tl, xv);
      T s[kCU][C];
#pragma unroll
      for (int k = 0; k < kCU; ++k)
#pragma unroll
        for (int c = 0; c < C; ++c) s[k][c] = c2r[k][c][0] * xv[c];
#pragma unroll
      for (int t = 1; t < W; ++t)
#pragma unroll
        for (int k = 0; k < kCU; ++k)
#pragma unroll
          for (int c = 0; c < C; ++c) s[k][c] += c2r[k][c][t] * xv[t + c];
#pragma unroll
      for (int k = 0; k < kCU; ++k)
        st_run<T, C>(uq + (k * WR + rr) * T2 + tl, s[k]);
    }
  };

  kron::cp_async_wait<D - 1>();  // plane q_begin is in
  __syncthreads();                // and the tables are complete
  axis2(win, u);

  const int64_t plane = (int64_t)g.n1 * g.n2;
  const int64_t base = (int64_t)gj * g.n2 + gl;
  int sb = 0;  // the window buffer of plane q
  // The march.  One barrier a step: step q runs the axis-2 pass of plane
  // q + 1 (into the other u buffer) beside the axis-1 and axis-0 passes of
  // plane q.
  for (int q = q_begin; q < q_end; ++q) {
    const int step = q - q_begin;
    const int sn = sb + 1 == S ? 0 : sb + 1;

    // the epilogue's operands of the plane this step completes, asked for
    // now so that they arrive under the step's arithmetic (the sum of
    // earlier launches, rarely there, is read where it is added; x from
    // the window)
    const int i = q - P;
    const bool emits = i >= i_begin;
    const int64_t idx = base + i * plane;
    T b_v[R][C], d_v[R][C];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < C; ++c) {
        b_v[r][c] = d_v[r][c] = T(0);
        if (emits && r < nrow && c < ncol) {
          const int64_t o = idx + r * g.n2 + c;
          if (need_b) b_v[r][c] = up(a.b[o]);
          if (MODE == kCheb && has_d) d_v[r][c] = up(a.d_in[o]);
        }
      }

    kron::cp_async_wait<D - 2>();  // plane q + 1 is in
    __syncthreads();
    // this barrier orders the last step's reads of the window buffer of
    // plane q + D - S and of u buffer (step + 1) & 1 before the writes below
    issue(q + D, sb + D < S ? sb + D : sb + D - S);
    axis2(win + sn * NW, u + ((step + 1) & 1) * UB);

    if (in_tile) {
      // axis 1: v[k][r] = sum_t B1[v_lab[k]][gj + r][t] * u[v_src[k]] at
      // row gj + r + t - P (u rows r + t of the group's window), then the
      // sums that share an axis-0 band
      const T* uq = u + (step & 1) * UB;
      const T* cg = c1t + tg * RH * R;
      T v[kCV][R][C];
#pragma unroll
      for (int k = 0; k < kCV; ++k)
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int c = 0; c < C; ++c) v[k][r][c] = T(0);
#pragma unroll
      for (int p = 0; p < RH; ++p)
#pragma unroll
        for (int k = 0; k < kCV; ++k) {
          T uv[C], cv[R];
          ld_run<T, C>(uq + uoff[k] + p * T2, uv);
          ld_vec<T, R>(cg + (k * NG * RH + p) * R, cv);
#pragma unroll
          for (int r = 0; r < R; ++r)
#pragma unroll
            for (int c = 0; c < C; ++c) v[k][r][c] += cv[r] * uv[c];
        }
      T wsum[kCG][R][C];
#pragma unroll
      for (int gi = 0; gi < kCG; ++gi)
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int c = 0; c < C; ++c) {
            wsum[gi][r][c] = a.gm[gi][0] * v[0][r][c];
#pragma unroll
            for (int k = 1; k < kCV; ++k)
              wsum[gi][r][c] += a.gm[gi][k] * v[k][r][c];
          }
      // axis 0: output plane q - P + s takes tap 2P - s of plane q
      const T* cq = c0s + (q - i_begin + P) * W + 2 * P;
#pragma unroll
      for (int gi = 0; gi < kCG; ++gi)
#pragma unroll
        for (int s = 0; s < W; ++s) {
          const T coef = cq[gi * crows * W + s * (W - 1)];
#pragma unroll
          for (int r = 0; r < R; ++r)
#pragma unroll
            for (int c = 0; c < C; ++c)
              outs[s][r][c] += coef * wsum[gi][r][c];
        }
    }

    if (emits && nrow > 0) {  // output plane i: its last input has arrived
      // x of plane i, in the window that plane q - P was copied into
      const T* xi = win + (sb + D + 1 < S ? sb + D + 1 : sb + D + 1 - S) * NW;
      T dg[R][C];
      if (need_dg) {
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int c = 0; c < C; ++c) dg[r][c] = T(0);
#pragma unroll
        for (int rd = 0; rd < kRD; ++rd) {
          if (rd >= g.R) break;
          const T* dr = dgt + rd * nd;
          const T d0 = dr[i - i_begin];
#pragma unroll
          for (int r = 0; r < R; ++r)
#pragma unroll
            for (int c = 0; c < C; ++c)
              dg[r][c] = add_rn(
                  dg[r][c], mul_rn(mul_rn(d0, dr[g.chunk + tg * R + r]),
                                   dr[g.chunk + T1 + tl + c]));
        }
        for (int rd = kRD; rd < g.R; ++rd)
#pragma unroll
          for (int r = 0; r < R; ++r)
#pragma unroll
            for (int c = 0; c < C; ++c)
              if (r < nrow && c < ncol)
                dg[r][c] = add_rn(
                    dg[r][c],
                    mul_rn(mul_rn(up(a.col[0][rd * g.n0 + i]),
                                  up(a.col[1][rd * g.n1 + gj + r])),
                           up(a.col[2][rd * g.n2 + gl + c])));
      }
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < C; ++c) {
          if (r >= nrow || c >= ncol) continue;
          const int64_t o = idx + r * g.n2 + c;
          const T ax = (has_acc ? a.acc[o] : T(0)) + outs[0][r][c];
          T res = ax;
          if (need_b) res = b_v[r][c] - ax;
          if (need_dg) res = res / dg[r][c];
          if (MODE == kCheb) {
            T d = a.c2 * res;
            if (has_d) d += a.c1 * d_v[r][c];
            store(a.d_out + o, d);
            store(a.out + o, xi[(tg * R + r + P) * WC + tl + c + P] + d);
          } else if (MODE == kApply && a.out_hi != nullptr) {
            a.out_hi[o] = res;
          } else {
            store(a.out + o, res);
          }
        }
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < C; ++c) {
#pragma unroll
        for (int s = 0; s + 1 < W; ++s) outs[s][r][c] = outs[s + 1][r][c];
        outs[W - 1][r][c] = T(0);
      }
    sb = sn;
  }
  kron::cp_async_wait<0>();
}

// -- K1r: three one-axis passes (see the note at the top) --------------------

constexpr int kRowsA = 4;  // pass A: rows of the field a thread
constexpr int kOutR = 4;   // passes B and C: outputs along the axis a thread

// geometry of the run-time passes: the field, the half-width, the terms
// (for the diagonal), pass A's tile (TL columns, even, of G * kRowsA rows)
// and the warps of a pass-B and a pass-C block
struct RtGeo {
  int n0, n1, n2;
  int per0, per1, per2;
  int P, R;
  int TL, G;
  int NWB, NWC;
  int64_t s0, s1, s2;  // element strides of x
};

template <typename T, typename IO>
struct RtArgs {
  const IO* x;
  const IO* band[3];
  const IO* col[3];
  const T* acc;
  const IO* b;
  const IO* d_in;
  IO* d_out;
  IO* out;
  T* out_hi;
  T c1, c2;
  // the plan's scratch: kCU u partials, then kCG pre-summed partials, each
  // a contiguous (n0, n1, n2) field of T
  T* scratch;
  // this pass's band table for this run of terms, laid out by the host
  // (ops/kron.py::k1r_tables) as each block's shared memory holds it: per
  // block of outputs one slice (A: (k, t, column) of a tile of columns;
  // B, C: the layout above pass A)
  const T* table;
  RtGeo g;
  Plan p;
};

template <typename T> struct Pair;
template <> struct Pair<float> { using type = float2; };
template <> struct Pair<double> { using type = double2; };

// two neighbouring values of shared memory (p aligned to two values)
template <typename T>
__device__ __forceinline__ typename Pair<T>::type ld2(const T* p) {
  return *reinterpret_cast<const typename Pair<T>::type*>(p);
}

// kOutR neighbouring values of shared memory (p aligned to 16 bytes)
template <typename T>
__device__ __forceinline__ void ld_row(const T* p, T (&v)[kOutR]) {
#pragma unroll
  for (int q = 0; q < kOutR; q += 2) {
    const typename Pair<T>::type w = ld2(p + q);
    v[q] = w.x, v[q + 1] = w.y;
  }
}

// shared memory of each pass, in bytes (ops/kron.py::k1r_smem mirrors it)
__host__ __device__ inline size_t smem_a(const RtGeo& g, size_t elem) {
  const size_t W = 2 * g.P + 1;
  return ((size_t)g.G * kRowsA * (g.TL + 2 * g.P) + kCU * W * g.TL) * elem;
}
__host__ __device__ inline size_t smem_bc(int NW, int P, int sources,
                                          int bands, size_t elem) {
  const size_t rows = (size_t)NW * kOutR + 2 * P, NPB = kOutR + 2 * P;
  return (sources * rows * kpass::kLanes + (size_t)bands * NW * NPB * kOutR) *
         elem;
}

// The band rows of a strided pass as each thread walks its inputs:
// bd[((k * NW + grp) * NPB + p) * kOutR + r] is the coefficient of input
// row p (of the thread's window) for its output r, tap p - r of band row
// a0 + grp * kOutR + r; zero off the band, past the grid and for absent
// partials.  The host lays one such slice out per block along the axis
// (ops/kron.py::k1r_tables), so a block copies it whole.

// Pass A, axis 2: u[k] = sum_t B2[u_lab[k]][l][t] x[.., l + t - P] for the
// kCU distinct axis-2 bands.  A thread owns two neighbouring columns of
// kRowsA rows: every band pair it reads serves kRowsA rows, every window
// pair two taps of two columns.  Taps 0 and 1 are one expression, as in
// K1 (the compiler fuses the first product into the add: fma(c0, x0,
// c1 x1)); the others are multiply-added in order.
template <typename T, typename IO>
__global__ void __launch_bounds__(kMaxThreads) k1r_pass_a(
    const RtArgs<T, IO> a) {
  const RtGeo& g = a.g;
  const Plan& pl = a.p;
  const int P = g.P, W = 2 * P + 1, TL = g.TL, WC = TL + 2 * P;
  const int NP = TL / 2, rows = g.G * kRowsA;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* win = reinterpret_cast<T*>(smem_raw);  // rows x WC
  T* cb = win + rows * WC;                  // (k, t, column)
  const int l0 = blockIdx.x * TL;
  const int64_t row0 = (int64_t)blockIdx.y * rows;
  const int64_t nrows = (int64_t)g.n0 * g.n1;

  // the window: a warp a row at a time, a lane a column
  const int lane = threadIdx.x % kpass::kLanes;
  const int nwarps = blockDim.x / kpass::kLanes;
  for (int r = threadIdx.x / kpass::kLanes; r < rows; r += nwarps) {
    const int64_t row = row0 + r;
    int64_t rbase = -1;
    if (row < nrows) {
      const int i = (int)row / g.n1, j = (int)row - i * g.n1;
      rbase = i * g.s0 + j * g.s1;
    }
    for (int c = lane; c < WC; c += kpass::kLanes) {
      const int gl = kron::resolve(l0 - P + c, g.n2, g.per2);
      kpass::stage<T, IO>(win + r * WC + c, a.x,
                          (rbase < 0 || gl < 0) ? -1 : rbase + gl * g.s2);
    }
  }
  // the band rows of the tile's columns, (k, t, column)
  kpass::copy_table(cb, a.table + (int64_t)blockIdx.x * kCU * W * TL,
                    kCU * W * TL);
  kron::cp_async_commit();
  kron::cp_async_wait<0>();
  __syncthreads();

  const int pair = threadIdx.x % NP, grp = threadIdx.x / NP;
  if (grp >= g.G) return;
  const int c0 = 2 * pair;
  using V = typename Pair<T>::type;
  T s[kCU][kRowsA][2];
  V xr[kRowsA];  // window values (t, t + 1) of the next taps, per row
  {
    V b0[kCU], b1[kCU];
#pragma unroll
    for (int k = 0; k < kCU; ++k) {
      b0[k] = ld2(cb + k * W * TL + c0);
      b1[k] = ld2(cb + (k * W + 1) * TL + c0);
    }
#pragma unroll
    for (int r = 0; r < kRowsA; ++r) {
      const T* xw = win + (grp * kRowsA + r) * WC + c0;
      const V cur = ld2(xw), nxt = ld2(xw + 2);
#pragma unroll
      for (int k = 0; k < kCU; ++k) {
        T s0 = b0[k].x * cur.x;
        s0 += b1[k].x * cur.y;
        T s1 = b0[k].y * cur.y;
        s1 += b1[k].y * nxt.x;
        s[k][r][0] = s0;
        s[k][r][1] = s1;
      }
      xr[r] = nxt;
    }
  }
  for (int t = 2; t + 1 < W; t += 2) {
    V bt[kCU], bu[kCU];
#pragma unroll
    for (int k = 0; k < kCU; ++k) {
      bt[k] = ld2(cb + (k * W + t) * TL + c0);
      bu[k] = ld2(cb + (k * W + t + 1) * TL + c0);
    }
#pragma unroll
    for (int r = 0; r < kRowsA; ++r) {
      const V cur = xr[r];
      const V nxt = ld2(win + (grp * kRowsA + r) * WC + c0 + t + 2);
#pragma unroll
      for (int k = 0; k < kCU; ++k) {
        s[k][r][0] += bt[k].x * cur.x;
        s[k][r][1] += bt[k].y * cur.y;
        s[k][r][0] += bu[k].x * cur.y;
        s[k][r][1] += bu[k].y * nxt.x;
      }
      xr[r] = nxt;
    }
  }
  {  // the last tap, 2P
    V bt[kCU];
#pragma unroll
    for (int k = 0; k < kCU; ++k) bt[k] = ld2(cb + (k * W + 2 * P) * TL + c0);
#pragma unroll
    for (int r = 0; r < kRowsA; ++r)
#pragma unroll
      for (int k = 0; k < kCU; ++k) {
        s[k][r][0] += bt[k].x * xr[r].x;
        s[k][r][1] += bt[k].y * xr[r].y;
      }
  }
  const int64_t npts = nrows * g.n2;
  const int l = l0 + c0;
#pragma unroll
  for (int r = 0; r < kRowsA; ++r) {
    const int64_t row = row0 + grp * kRowsA + r;
    if (row >= nrows) break;
#pragma unroll
    for (int k = 0; k < kCU; ++k) {
      if (k >= pl.nu) break;
      T* uk = a.scratch + k * npts + row * g.n2 + l;
      if (l < g.n2) uk[0] = s[k][r][0];
      if (l + 1 < g.n2) uk[1] = s[k][r][1];
    }
  }
}

// Pass B, axis 1: v[k] = sum_t B1[v_lab[k]][j][t] u[v_src[k]][.., j + t - P,
// ..] and the pre-summed partials wsum[gi] = sum_k g_mult[gi][k] v[k], in
// order.  A thread owns kOutR neighbouring outputs along axis 1: each u
// value it reads serves kOutR outputs of each v, each band read (a
// broadcast) kOutR outputs; an output takes its taps in order, from zero.
template <typename T, typename IO>
__global__ void __launch_bounds__(kMaxThreads) k1r_pass_b(
    const RtArgs<T, IO> a) {
  const RtGeo& g = a.g;
  const Plan& pl = a.p;
  const int P = g.P, NW = g.NWB, NPB = kOutR + 2 * P;
  const int TAH = NW * kOutR + 2 * P;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tile = reinterpret_cast<T*>(smem_raw);  // (source, row, lane)
  T* bd = tile + kCU * TAH * kpass::kLanes;
  const int l0 = blockIdx.x * kpass::kLanes, j0 = blockIdx.y * NW * kOutR;
  const int i = blockIdx.z;
  const int64_t plane = (int64_t)g.n1 * g.n2, npts = plane * g.n0;
  for (int s = 0; s < pl.nu; ++s)
    kpass::stage_strided(tile + s * TAH * kpass::kLanes,
                         a.scratch + s * npts + i * plane, g.n2, g.n1,
                         g.per1, j0, P, TAH, l0, g.n2);
  const int nbd = kCV * NW * NPB * kOutR;
  kpass::copy_table(bd, a.table + (int64_t)blockIdx.y * nbd, nbd);
  kron::cp_async_commit();
  kron::cp_async_wait<0>();
  __syncthreads();

  const int lane = threadIdx.x % kpass::kLanes;
  const int grp = threadIdx.x / kpass::kLanes;
  T gm[kCG][kCV];
#pragma unroll
  for (int gi = 0; gi < kCG; ++gi)
#pragma unroll
    for (int k = 0; k < kCV; ++k)
      gm[gi][k] = (gi < pl.ng && k < pl.nv) ? T(pl.g_mult[gi][k]) : T(0);
  int src[kCV];
#pragma unroll
  for (int k = 0; k < kCV; ++k) src[k] = k < pl.nv ? pl.v_src[k] : 0;
  const bool two = pl.nu > 1;
  const T* in0 = tile + grp * kOutR * kpass::kLanes + lane;
  const T* in1 = in0 + TAH * kpass::kLanes;
  T v[kCV][kOutR];
#pragma unroll
  for (int k = 0; k < kCV; ++k)
#pragma unroll
    for (int r = 0; r < kOutR; ++r) v[k][r] = T(0);
  for (int p = 0; p < NPB; ++p) {
    const T x0 = in0[p * kpass::kLanes];
    const T x1 = two ? in1[p * kpass::kLanes] : T(0);
#pragma unroll
    for (int k = 0; k < kCV; ++k) {
      const T xk = src[k] == 0 ? x0 : x1;
      T c[kOutR];
      ld_row(bd + ((k * NW + grp) * NPB + p) * kOutR, c);
#pragma unroll
      for (int r = 0; r < kOutR; ++r) v[k][r] += c[r] * xk;
    }
  }
  const int l = l0 + lane;
  if (l >= g.n2) return;
#pragma unroll
  for (int r = 0; r < kOutR; ++r) {
    const int j = j0 + grp * kOutR + r;
    if (j >= g.n1) break;
#pragma unroll
    for (int gi = 0; gi < kCG; ++gi) {
      if (gi >= pl.ng) break;
      T wsum = gm[gi][0] * v[0][r];
#pragma unroll
      for (int k = 1; k < kCV; ++k) wsum += gm[gi][k] * v[k][r];
      a.scratch[(kCU + gi) * npts + i * plane + (int64_t)j * g.n2 + l] = wsum;
    }
  }
}

// Pass C, axis 0: A x = sum_gi sum_t B0[g_lab[gi]][i][t] wsum[gi][i + t - P]
// (per tap, the pre-summed partials in order, each multiply-added onto the
// output's running sum), then the mode's epilogue, K1's own.  A thread owns
// kOutR neighbouring outputs along axis 0.
template <typename T, int MODE, typename IO>
__global__ void __launch_bounds__(kMaxThreads) k1r_pass_c(
    const RtArgs<T, IO> a) {
  constexpr bool need_b = MODE == kResidual || MODE == kCheb;
  constexpr bool need_dg = MODE == kDinv || MODE == kCheb;
  const RtGeo& g = a.g;
  const Plan& pl = a.p;
  const int P = g.P, NW = g.NWC, NPB = kOutR + 2 * P;
  const int TAH = NW * kOutR + 2 * P;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tile = reinterpret_cast<T*>(smem_raw);  // (partial, row, lane)
  T* bd = tile + kCG * TAH * kpass::kLanes;
  const int l0 = blockIdx.x * kpass::kLanes, j = blockIdx.y;
  const int i0 = blockIdx.z * NW * kOutR;
  const int64_t plane = (int64_t)g.n1 * g.n2, npts = plane * g.n0;
  for (int s = 0; s < pl.ng; ++s)
    kpass::stage_strided(tile + s * TAH * kpass::kLanes,
                         a.scratch + (kCU + s) * npts + (int64_t)j * g.n2,
                         plane, g.n0, g.per0, i0, P, TAH, l0, g.n2);
  const int nbd = kCG * NW * NPB * kOutR;
  kpass::copy_table(bd, a.table + (int64_t)blockIdx.z * nbd, nbd);
  kron::cp_async_commit();

  // the epilogue's operands, asked for now so that they arrive under the
  // tile's copy and the arithmetic
  const int lane = threadIdx.x % kpass::kLanes;
  const int grp = threadIdx.x / kpass::kLanes;
  const int l = l0 + lane;
  const bool has_acc = a.acc != nullptr, has_d = a.d_in != nullptr;
  T acc_v[kOutR], b_v[kOutR], d_v[kOutR], x_v[kOutR], dg[kOutR];
#pragma unroll
  for (int r = 0; r < kOutR; ++r) {
    acc_v[r] = b_v[r] = d_v[r] = x_v[r] = dg[r] = T(0);
    const int i = i0 + grp * kOutR + r;
    if (l >= g.n2 || i >= g.n0) continue;
    const int64_t idx = i * plane + (int64_t)j * g.n2 + l;
    if (has_acc) acc_v[r] = a.acc[idx];
    if (need_b) b_v[r] = up(a.b[idx]);
    if (MODE == kCheb) {
      if (has_d) d_v[r] = up(a.d_in[idx]);
      x_v[r] = up(a.x[i * g.s0 + j * g.s1 + l * g.s2]);
    }
    if (need_dg)
      for (int q = 0; q < g.R; ++q)
        dg[r] = add_rn(dg[r], mul_rn(mul_rn(up(a.col[0][q * g.n0 + i]),
                                            up(a.col[1][q * g.n1 + j])),
                                     up(a.col[2][q * g.n2 + l])));
  }
  kron::cp_async_wait<0>();
  __syncthreads();

  const bool two = pl.ng > 1;
  const T* in0 = tile + grp * kOutR * kpass::kLanes + lane;
  const T* in1 = in0 + TAH * kpass::kLanes;
  const T* bd0 = bd + grp * NPB * kOutR;
  const T* bd1 = bd0 + NW * NPB * kOutR;
  T o[kOutR];
#pragma unroll
  for (int r = 0; r < kOutR; ++r) o[r] = T(0);
  for (int p = 0; p < NPB; ++p) {
    T c[kOutR];
    const T w0 = in0[p * kpass::kLanes];
    ld_row(bd0 + p * kOutR, c);
#pragma unroll
    for (int r = 0; r < kOutR; ++r) o[r] += c[r] * w0;
    if (two) {
      const T w1 = in1[p * kpass::kLanes];
      ld_row(bd1 + p * kOutR, c);
#pragma unroll
      for (int r = 0; r < kOutR; ++r) o[r] += c[r] * w1;
    }
  }

  if (l >= g.n2) return;
#pragma unroll
  for (int r = 0; r < kOutR; ++r) {
    const int i = i0 + grp * kOutR + r;
    if (i >= g.n0) break;
    const int64_t idx = i * plane + (int64_t)j * g.n2 + l;
    const T ax = acc_v[r] + o[r];
    T res = ax;
    if (need_b) res = b_v[r] - ax;
    if (need_dg) res = res / dg[r];
    if (MODE == kCheb) {
      T d = a.c2 * res;
      if (has_d) d += a.c1 * d_v[r];
      store(a.d_out + idx, d);
      store(a.out + idx, x_v[r] + d);
    } else if (MODE == kApply && a.out_hi != nullptr) {
      a.out_hi[idx] = res;
    } else {
      store(a.out + idx, res);
    }
  }
}

template <typename T, int P, int R, int MODE, typename IO>
int launch_pm(const Args<T, IO>& a, cudaStream_t stream) {
  const Geometry& g = a.g;
  constexpr int C = columns<T>();
  if (g.threads > kMaxThreads || g.T2 % C != 0 || g.T1 % R != 0 ||
      g.threads < (g.T1 / R) * (g.T2 / C) || g.threads % 32 != 0)
    return (int)cudaErrorInvalidConfiguration;
  // the window's source offsets are 32-bit: the last in-plane offset
  if ((g.n1 - 1) * g.s1 + (g.n2 - 1) * g.s2 > (int64_t)INT32_MAX)
    return (int)cudaErrorInvalidValue;
  const size_t bytes = K1Smem<T, P, R>(g).bytes;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kron_march_kernel<T, P, R, MODE, IO>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear it, or the next launch reports it
      return (int)err;
    }
  }
  const dim3 grid((g.n2 + g.T2 - 1) / g.T2, (g.n1 + g.T1 - 1) / g.T1,
                  (g.n0 + g.chunk - 1) / g.chunk);
  kron_march_kernel<T, P, R, MODE, IO><<<grid, g.threads, bytes, stream>>>(
      a);
  return (int)cudaGetLastError();
}

template <typename T, int P, int R, typename IO>
int launch_pr(const Args<T, IO>& a, cudaStream_t stream) {
  switch (a.mode) {
    case kApply: return launch_pm<T, P, R, kApply, IO>(a, stream);
    case kResidual: return launch_pm<T, P, R, kResidual, IO>(a, stream);
    case kDinv: return launch_pm<T, P, R, kDinv, IO>(a, stream);
    default: return launch_pm<T, P, R, kCheb, IO>(a, stream);
  }
}

// The launch at `rows` rows a thread (the micro-tile is rows x columns),
// 2 or 1: at 2 every u value and every band vector the axis-1 pass reads
// serves two rows, which pays where blocks fill the SMs; on coarse grids,
// whose few blocks leave the SMs half idle, a thread's chain of work sets
// the pace and 1 row is faster.
template <typename T, int P, typename IO>
int launch_p(const Args<T, IO>& a, int rows, cudaStream_t stream) {
  switch (rows) {
    case 1: return launch_pr<T, P, 1, IO>(a, stream);
    case 2: return launch_pr<T, P, 2, IO>(a, stream);
    default: return (int)cudaErrorInvalidConfiguration;
  }
}

// K1r: one pass (0 A, 1 B, 2 C) of the run-time design
template <typename T, typename IO>
int launch_rt(int pass, int mode, const RtArgs<T, IO>& a,
              cudaStream_t stream) {
  const RtGeo& g = a.g;
  const size_t elem = sizeof(T);
  const int threads_a = 32 * ((g.TL / 2 * g.G + 31) / 32);
  if (g.P < 1 || g.TL < 2 || g.TL % 2 != 0 || g.G < 1 ||
      threads_a > kMaxThreads || g.NWB < 1 || g.NWB > kpass::kMaxWarps ||
      g.NWC < 1 || g.NWC > kpass::kMaxWarps ||
      (int64_t)g.n0 * g.n1 > INT32_MAX || a.scratch == nullptr ||
      a.table == nullptr)
    return (int)cudaErrorInvalidConfiguration;
  const int tiles2 = (g.n2 + kpass::kLanes - 1) / kpass::kLanes;
  cudaError_t err;
  if (pass == 0) {
    const size_t bytes = smem_a(g, elem);
    if ((err = kpass::allow_smem(k1r_pass_a<T, IO>, bytes)) != cudaSuccess)
      return (int)err;
    const int per = g.G * kRowsA;
    const dim3 grid((g.n2 + g.TL - 1) / g.TL, (g.n0 * g.n1 + per - 1) / per);
    k1r_pass_a<T, IO><<<grid, threads_a, bytes, stream>>>(a);
  } else if (pass == 1) {
    const size_t bytes = smem_bc(g.NWB, g.P, kCU, kCV, elem);
    if ((err = kpass::allow_smem(k1r_pass_b<T, IO>, bytes)) != cudaSuccess)
      return (int)err;
    const int per = g.NWB * kOutR;
    const dim3 grid(tiles2, (g.n1 + per - 1) / per, g.n0);
    k1r_pass_b<T, IO><<<grid, g.NWB * kpass::kLanes, bytes, stream>>>(a);
  } else {
    const size_t bytes = smem_bc(g.NWC, g.P, kCG, kCG, elem);
    const int per = g.NWC * kOutR;
    const dim3 grid(tiles2, g.n1, (g.n0 + per - 1) / per);
    const int threads = g.NWC * kpass::kLanes;
    auto go = [&](auto kernel) {
      const cudaError_t e = kpass::allow_smem(kernel, bytes);
      if (e != cudaSuccess) return (int)e;
      kernel<<<grid, threads, bytes, stream>>>(a);
      return 0;
    };
    int e;
    switch (mode) {
      case kApply: e = go(k1r_pass_c<T, kApply, IO>); break;
      case kResidual: e = go(k1r_pass_c<T, kResidual, IO>); break;
      case kDinv: e = go(k1r_pass_c<T, kDinv, IO>); break;
      default: e = go(k1r_pass_c<T, kCheb, IO>); break;
    }
    if (e != 0) return e;
  }
  return (int)cudaGetLastError();
}

// plan: nu nv ng u_lab[kCU] v_src[kCV] v_lab[kCV] g_lab[kCG] g_mult[kCG][kCV]
bool parse_plan(const int* plan, Plan& p) {
  const int* q = plan;
  p.nu = *q++, p.nv = *q++, p.ng = *q++;
  for (int k = 0; k < kCU; ++k) p.u_lab[k] = *q++;
  for (int k = 0; k < kCV; ++k) p.v_src[k] = *q++;
  for (int k = 0; k < kCV; ++k) p.v_lab[k] = *q++;
  for (int k = 0; k < kCG; ++k) p.g_lab[k] = *q++;
  for (int gi = 0; gi < kCG; ++gi)
    for (int k = 0; k < kCV; ++k) p.g_mult[gi][k] = *q++;
  return !(p.nu < 1 || p.nu > kCU || p.nv < 1 || p.nv > kCV || p.ng < 1 ||
           p.ng > kCG);
}

// the operands every mode checks: b where the mode reads it, one output
bool operands_ok(int mode, const void* b, const void* out,
                 const void* out_hi) {
  if (mode < 0 || mode > kCheb) return false;
  if ((mode == kResidual || mode == kCheb) && b == nullptr) return false;
  return out_hi != nullptr ? mode == kApply : out != nullptr;
}

// geo: n0 n1 n2 per0 per1 per2 P T1 T2 chunk threads R rows
template <typename T, typename IO>
int launch(const void* x, const void* b0, const void* b1, const void* b2,
           const void* c0, const void* c1, const void* c2, const void* acc,
           const void* b, const void* d_in, void* d_out, void* out,
           void* out_hi, double s1, double s2, int mode,
           const int64_t* xstrides, const int* geo, const int* plan,
           void* stream) {
  Args<T, IO> a;
  a.x = (const IO*)x;
  a.band[0] = (const IO*)b0;
  a.band[1] = (const IO*)b1;
  a.band[2] = (const IO*)b2;
  a.col[0] = (const IO*)c0;
  a.col[1] = (const IO*)c1;
  a.col[2] = (const IO*)c2;
  a.acc = (const T*)acc;
  a.b = (const IO*)b;
  a.d_in = (const IO*)d_in;
  a.d_out = (IO*)d_out;
  a.out = (IO*)out;
  a.out_hi = (T*)out_hi;
  a.c1 = (T)s1;
  a.c2 = (T)s2;
  a.mode = mode;
  Geometry& g = a.g;
  g.n0 = geo[0], g.n1 = geo[1], g.n2 = geo[2];
  g.per0 = geo[3], g.per1 = geo[4], g.per2 = geo[5];
  const int P = geo[6];
  g.T1 = geo[7], g.T2 = geo[8], g.chunk = geo[9], g.threads = geo[10];
  g.R = geo[11];
  const int rows = geo[12];
  g.s0 = xstrides[0], g.s1 = xstrides[1], g.s2 = xstrides[2];
  if (!parse_plan(plan, a.p) || g.T1 < 1 || g.T2 < 1 || g.chunk < 1 ||
      !operands_ok(mode, b, out, out_hi))
    return (int)cudaErrorInvalidValue;
  for (int gi = 0; gi < kCG; ++gi)
    for (int k = 0; k < kCV; ++k)
      a.gm[gi][k] = (gi < a.p.ng && k < a.p.nv) ? (T)a.p.g_mult[gi][k] : T(0);
  const cudaStream_t st = (cudaStream_t)stream;
  switch (P) {  // the compiled half-widths; ops/kron.py pads bands to one
    case 1: return launch_p<T, 1, IO>(a, rows, st);
    case 2: return launch_p<T, 2, IO>(a, rows, st);
    case 3: return launch_p<T, 3, IO>(a, rows, st);
    default: return (int)cudaErrorInvalidValue;  // no such kernel: K1r's
  }
}

// K1r's geo: n0 n1 n2 per0 per1 per2 P R TL G NWB NWC
void parse_rt_geo(const int* geo, RtGeo& g) {
  g.n0 = geo[0], g.n1 = geo[1], g.n2 = geo[2];
  g.per0 = geo[3], g.per1 = geo[4], g.per2 = geo[5];
  g.P = geo[6], g.R = geo[7];
  g.TL = geo[8], g.G = geo[9], g.NWB = geo[10], g.NWC = geo[11];
}

template <typename T, typename IO>
int launch_rt_pass(int pass, const void* x, const void* b0, const void* b1,
                   const void* b2, const void* c0, const void* c1,
                   const void* c2, const void* acc, const void* b,
                   const void* d_in, void* d_out, void* out, void* out_hi,
                   double s1, double s2, int mode, const int64_t* xstrides,
                   const int* geo, const int* plan, void* scratch,
                   const void* table, void* stream) {
  RtArgs<T, IO> a;
  a.x = (const IO*)x;
  a.band[0] = (const IO*)b0;
  a.band[1] = (const IO*)b1;
  a.band[2] = (const IO*)b2;
  a.col[0] = (const IO*)c0;
  a.col[1] = (const IO*)c1;
  a.col[2] = (const IO*)c2;
  a.acc = (const T*)acc;
  a.b = (const IO*)b;
  a.d_in = (const IO*)d_in;
  a.d_out = (IO*)d_out;
  a.out = (IO*)out;
  a.out_hi = (T*)out_hi;
  a.c1 = (T)s1;
  a.c2 = (T)s2;
  a.scratch = (T*)scratch;
  a.table = (const T*)table;
  parse_rt_geo(geo, a.g);
  a.g.s0 = xstrides[0], a.g.s1 = xstrides[1], a.g.s2 = xstrides[2];
  if (!parse_plan(plan, a.p) || pass < 0 || pass > 2 ||
      (pass == 2 && !operands_ok(mode, b, out, out_hi)))
    return (int)cudaErrorInvalidValue;
  return launch_rt<T, IO>(pass, mode, a, (cudaStream_t)stream);
}

template <typename T, int P, int R, int MODE, typename IO>
int resources_prm(const Geometry& g, int* out) {
  return kron::resources_of(kron_march_kernel<T, P, R, MODE, IO>, g.threads,
                            K1Smem<T, P, R>(g).bytes, out);
}

template <typename T, int P, int MODE, typename IO>
int resources_pm(const Geometry& g, int rows, int* out) {
  switch (rows) {
    case 1: return resources_prm<T, P, 1, MODE, IO>(g, out);
    case 2: return resources_prm<T, P, 2, MODE, IO>(g, out);
    default: return (int)cudaErrorInvalidConfiguration;
  }
}

template <typename T, int MODE, typename IO>
int resources_m(const Geometry& g, int P, int rows, int* out) {
  switch (P) {
    case 1: return resources_pm<T, 1, MODE, IO>(g, rows, out);
    case 2: return resources_pm<T, 2, MODE, IO>(g, rows, out);
    case 3: return resources_pm<T, 3, MODE, IO>(g, rows, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T, typename IO>
int resources_t(int mode, const Geometry& g, int P, int rows, int* out) {
  switch (mode) {
    case kApply: return resources_m<T, kApply, IO>(g, P, rows, out);
    case kResidual: return resources_m<T, kResidual, IO>(g, P, rows, out);
    case kDinv: return resources_m<T, kDinv, IO>(g, P, rows, out);
    case kCheb: return resources_m<T, kCheb, IO>(g, P, rows, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T, typename IO>
int resources_rt(int pass, int mode, const RtGeo& g, int* out) {
  const size_t elem = sizeof(T);
  switch (pass) {
    case 0:
      return kron::resources_of(k1r_pass_a<T, IO>,
                                32 * ((g.TL / 2 * g.G + 31) / 32),
                                smem_a(g, elem), out);
    case 1:
      return kron::resources_of(k1r_pass_b<T, IO>, g.NWB * kpass::kLanes,
                                smem_bc(g.NWB, g.P, kCU, kCV, elem), out);
    case 2: {
      const int threads = g.NWC * kpass::kLanes;
      const size_t bytes = smem_bc(g.NWC, g.P, kCG, kCG, elem);
      switch (mode) {
        case kApply:
          return kron::resources_of(k1r_pass_c<T, kApply, IO>, threads,
                                    bytes, out);
        case kResidual:
          return kron::resources_of(k1r_pass_c<T, kResidual, IO>, threads,
                                    bytes, out);
        case kDinv:
          return kron::resources_of(k1r_pass_c<T, kDinv, IO>, threads,
                                    bytes, out);
        default:
          return kron::resources_of(k1r_pass_c<T, kCheb, IO>, threads,
                                    bytes, out);
      }
    }
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

#define KRON_APPLY_ENTRY(NAME, T, IO)                                       \
  int NAME(const void* x, const void* b0, const void* b1, const void* b2,  \
           const void* c0, const void* c1, const void* c2, const void* acc, \
           const void* b, const void* d_in, void* d_out, void* out,         \
           void* out_hi, double s1, double s2, int mode,                    \
           const int64_t* xstrides, const int* geo, const int* plan,        \
           void* stream) {                                                  \
    return launch<T, IO>(x, b0, b1, b2, c0, c1, c2, acc, b, d_in, d_out,    \
                         out, out_hi, s1, s2, mode, xstrides, geo, plan,    \
                         stream);                                           \
  }

// K1r, one pass (0: A, 1: B, 2: C) of the run-time design: the compiled
// entries' arguments, K1r's geo, the plan's scratch (kCU + kCG fields of
// the arithmetic type) and the pass's band table of the run
#define KRON_APPLY_RT_ENTRY(NAME, T, IO)                                    \
  int NAME(int pass, const void* x, const void* b0, const void* b1,         \
           const void* b2, const void* c0, const void* c1, const void* c2,  \
           const void* acc, const void* b, const void* d_in, void* d_out,   \
           void* out, void* out_hi, double s1, double s2, int mode,         \
           const int64_t* xstrides, const int* geo, const int* plan,        \
           void* scratch, const void* table, void* stream) {                \
    return launch_rt_pass<T, IO>(pass, x, b0, b1, b2, c0, c1, c2, acc, b,   \
                                 d_in, d_out, out, out_hi, s1, s2, mode,    \
                                 xstrides, geo, plan, scratch, table,       \
                                 stream);                                   \
  }

// fields and bands bfloat16; acc and out_hi (the sum between the launches of
// one operator) float
KRON_APPLY_ENTRY(kron_apply_f32, float, float)
KRON_APPLY_ENTRY(kron_apply_bf16, float, __nv_bfloat16)
KRON_APPLY_ENTRY(kron_apply_f64, double, double)
KRON_APPLY_RT_ENTRY(kron_apply_rt_f32, float, float)
KRON_APPLY_RT_ENTRY(kron_apply_rt_bf16, float, __nv_bfloat16)
KRON_APPLY_RT_ENTRY(kron_apply_rt_f64, double, double)

// out: registers a thread, local memory a thread in bytes (spills), shared
// memory a block in bytes, blocks an SM holds, for a launch of geo in `mode`
// (dtype 0 f32, 1 f64, 2 bf16); pass -1: the compiled kernel's, 0-2: K1r's
// pass (geo then K1r's)
int kron_apply_resources(int dtype, int mode, int pass, const int* geo,
                         int* out) {
  if (pass >= 0) {
    RtGeo g;
    parse_rt_geo(geo, g);
    switch (dtype) {
      case 0: return resources_rt<float, float>(pass, mode, g, out);
      case 1: return resources_rt<double, double>(pass, mode, g, out);
      case 2: return resources_rt<float, __nv_bfloat16>(pass, mode, g, out);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  Geometry g;
  g.n0 = geo[0], g.n1 = geo[1], g.n2 = geo[2];
  g.per0 = geo[3], g.per1 = geo[4], g.per2 = geo[5];
  const int P = geo[6];
  g.T1 = geo[7], g.T2 = geo[8], g.chunk = geo[9], g.threads = geo[10];
  g.R = geo[11];
  const int rows = geo[12];
  g.s0 = (int64_t)g.n1 * g.n2, g.s1 = g.n2, g.s2 = 1;
  switch (dtype) {
    case 0: return resources_t<float, float>(mode, g, P, rows, out);
    case 1: return resources_t<double, double>(mode, g, P, rows, out);
    case 2: return resources_t<float, __nv_bfloat16>(mode, g, P, rows, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* kron_apply_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

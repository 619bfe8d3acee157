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
// fields (12.8 us); the ~55 multiply-adds per point stay on chip, and below
// about 65^3 the launch itself is the bound.  What the kernel is held back by
// in practice is instruction issue and latency: a step of the march is a
// chain of short phases between two barriers, so everything below is about
// fewer instructions per point and more independent work per thread.
//
// Design.  A block owns a T1 x T2 column of the (axis 1, axis 2) grid and
// marches over a run of axis-0 planes (kron_march.cuh: cp.async window loads
// into a ring of buffers, index rules instead of a padded copy; a thread's
// copy offsets are the same for every plane and stay in registers).  A thread
// owns C neighbouring columns (columns<T, P>()).  Per plane:
//   axis 2: each thread contracts its own columns of the window for the
//           distinct axis-2 bands (u partials, into shared memory); its band
//           rows sit in registers for the whole march;
//   axis 1: each thread contracts the u rows below it for the distinct
//           (u, axis-1 band) pairs (v partials, in registers);
//   sum:    the v's that meet the same axis-0 band are added first, so
//           Poisson needs 2 + 3 + 2 contractions instead of 9;
//   axis 0: plane q of those sums is added, tap by tap, to the 2P+1 output
//           planes it reaches, which are accumulated in registers; the band
//           rows of this run of planes come from shared memory (one broadcast
//           read per coefficient).  Plane q - P is then complete;
//   epilogue: its operands (b, d, x, the diagonal's column of axis 0) are
//           asked for at the top of the step, so they arrive under the
//           arithmetic.
// The arithmetic has no branches on the plan: an absent partial has zero band
// rows, so the chains of multiply-adds of all partials interleave.  The mode
// is a template parameter (no epilogue code of another mode in the loop).
// No plane is recomputed along axis 0 except the 2P planes where two runs
// meet.  The host splits axis 0 into runs and picks the tile from a cost
// model fitted to a sweep on the card (ops/kron.py::kron_tiling).
//
// The sharing plan (which band each partial uses, which v's are summed) is
// built once per operator on the host and arrives as a few integers.  One
// launch holds up to kCU u's, kCV v's and kCG sums; an operator that needs
// more is applied in several launches chained through `acc`.  The diagonal
// is formed in the kernel from the bands' centre columns,
// sum_r (c0[r,i] * c1[r,j]) * c2[r,l], with no fused multiply-add, so it has
// the bits of the operator's diagonal() and no diagonal array is read.

#include "kron_march.cuh"

namespace {

using kron::Geometry;

constexpr int kCU = 2;  // u partials per launch (distinct axis-2 bands)
constexpr int kCV = 3;  // v partials per launch
constexpr int kCG = 2;  // pre-summed partials per launch (axis-0 bands)
constexpr int kRD = 3;  // terms whose diagonal columns a thread keeps
constexpr int kNL = 4;  // window elements a thread copies by its own offsets
constexpr int kMaxThreads = 256;

enum Mode { kApply = 0, kResidual = 1, kDinv = 2, kCheb = 3 };

struct Plan {
  int nu, nv, ng;
  int u_lab[kCU];
  int v_src[kCV], v_lab[kCV];
  int g_lab[kCG];
  int g_mult[kCG][kCV];
};

template <typename T>
struct Args {
  const T* x;
  const T* band[3];  // per axis (labels, n_a, 2P+1)
  const T* col[3];   // per axis (R, n_a): centre columns of every term
  const T* acc;      // A x of the terms of earlier launches, or null
  const T* b;
  const T* d_in;     // null on the first Chebyshev step
  T* d_out;
  T* out;
  T c1, c2;
  int mode;
  Geometry g;
  Plan p;
};

// columns of the tile one thread owns: two where the registers allow it
// (f32, P <= 3), so that every shared-memory load of the axis-1 pass and
// every band coefficient of the axis-0 pass serves two points
template <typename T, int P>
__host__ __device__ constexpr int columns() {
  return (sizeof(T) == 4 && P <= 3) ? 2 : 1;
}

// blocks that must fit an SM together: two where 128 registers a thread are
// enough (while one block waits at a barrier the other computes)
template <typename T, int P>
__host__ __device__ constexpr int min_blocks() {
  return (sizeof(T) == 4 && P <= 3) ? 2 : 1;
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

// C neighbouring values from shared memory (p aligned to C values): one
// vector load for C = 2
template <typename T, int C>
__device__ __forceinline__ void load_cols(const T* p, T (&v)[C]) {
#pragma unroll
  for (int c = 0; c < C; ++c) v[c] = p[c];
}
template <>
__device__ __forceinline__ void load_cols<float, 2>(const float* p,
                                                    float (&v)[2]) {
  const float2 q = *reinterpret_cast<const float2*>(p);
  v[0] = q.x, v[1] = q.y;
}

// shared memory, in T units after the offset table: the ring of windows,
// the u partials, the axis-0 band rows of this run of planes
template <int P>
__host__ __device__ inline size_t smem_bytes(const Geometry& g, size_t elem) {
  const size_t WR = g.T1 + 2 * P, WC = g.T2 + 2 * P, W = 2 * P + 1;
  return WR * WC * sizeof(int64_t) +
         (kron::kStages * WR * WC + kCU * WR * g.T2 +
          kCG * (g.chunk + 4 * P) * W) *
             elem;
}

template <typename T, int P, int MODE>
__global__ void __launch_bounds__(kMaxThreads, min_blocks<T, P>())
kron_march_kernel(const Args<T> a) {
  constexpr int W = 2 * P + 1;
  constexpr int C = columns<T, P>();
  constexpr int S = kron::kStages;
  constexpr bool need_b = MODE == kResidual || MODE == kCheb;
  constexpr bool need_dg = MODE == kDinv || MODE == kCheb;
  const Geometry& g = a.g;
  const Plan& pl = a.p;
  const int T1 = g.T1, T2 = g.T2;  // T2 is a multiple of C
  const int TC = T2 / C;           // threads per tile row
  const int WR = T1 + 2 * P, WC = T2 + 2 * P, NW = WR * WC;
  const int nthreads = blockDim.x;
  const int crows = g.chunk + 4 * P;  // rows of the axis-0 coefficient table

  extern __shared__ __align__(16) unsigned char smem_raw[];
  int64_t* soff = reinterpret_cast<int64_t*>(smem_raw);
  T* win = reinterpret_cast<T*>(soff + NW);
  T* u = win + S * NW;
  T* c0s = u + kCU * WR * T2;

  const int tid = threadIdx.x;
  const int tj = tid / TC, tl = (tid - tj * TC) * C;  // row, first column
  const bool in_tile = tid < T1 * TC;
  const int j0 = blockIdx.y * T1, l0 = blockIdx.x * T2;
  const int gj = j0 + tj, gl = l0 + tl;
  const bool row_ok = in_tile && gj < g.n1;
  bool owns[C];
#pragma unroll
  for (int c = 0; c < C; ++c) owns[c] = row_ok && gl + c < g.n2;
  const int i_begin = blockIdx.z * g.chunk;
  const int i_end = min(i_begin + g.chunk, g.n0);
  const int nu = pl.nu, nv = pl.nv, ng = pl.ng;
  const bool has_acc = a.acc != nullptr, has_d = a.d_in != nullptr;

  kron::build_window_offsets(soff, g, P, j0, l0);
  // axis-0 band rows of output planes [i_begin - 2P, i_begin + chunk + 2P),
  // per pre-summed partial: zero outside the grid and for absent partials
  for (int e = tid; e < kCG * crows * W; e += nthreads) {
    const int gi = e / (crows * W);
    const int rem = e - gi * crows * W;
    const int i = i_begin - 2 * P + rem / W;
    c0s[e] = (gi < ng && i >= 0 && i < g.n0)
                 ? a.band[0][((int64_t)pl.g_lab[gi] * g.n0 + i) * W + rem % W]
                 : T(0);
  }
  // this thread's band rows: axis 2 at its columns, axis 1 at row gj; an
  // absent partial has zero rows, so the arithmetic below needs no branches
  T c2r[kCU][C][W], c1r[kCV][W];
#pragma unroll
  for (int k = 0; k < kCU; ++k)
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int t = 0; t < W; ++t)
        c2r[k][c][t] =
            (k < nu && in_tile && gl + c < g.n2)
                ? a.band[2][((int64_t)pl.u_lab[k] * g.n2 + gl + c) * W + t]
                : T(0);
#pragma unroll
  for (int k = 0; k < kCV; ++k)
#pragma unroll
    for (int t = 0; t < W; ++t)
      c1r[k][t] = (k < nv && row_ok)
                      ? a.band[1][((int64_t)pl.v_lab[k] * g.n1 + gj) * W + t]
                      : T(0);
  T gm[kCG][kCV];
#pragma unroll
  for (int gi = 0; gi < kCG; ++gi)
#pragma unroll
    for (int k = 0; k < kCV; ++k)
      gm[gi][k] = (gi < ng && k < nv) ? T(pl.g_mult[gi][k]) : T(0);
  int uoff[kCV];  // where each v reads its u column
#pragma unroll
  for (int k = 0; k < kCV; ++k)
    uoff[k] = ((k < nv ? pl.v_src[k] : 0) * WR + tj) * T2 + tl;

  // the diagonal's centre columns along axes 1 and 2 do not change on the
  // march: the first kRD terms' stay in registers
  T d1[kRD], d2[kRD][C];
  if (need_dg) {
#pragma unroll
    for (int r = 0; r < kRD; ++r) {
      d1[r] = (r < g.R && row_ok) ? a.col[1][r * g.n1 + gj] : T(0);
#pragma unroll
      for (int c = 0; c < C; ++c)
        d2[r][c] = (r < g.R && owns[c]) ? a.col[2][r * g.n2 + gl + c] : T(0);
    }
  }

  // outs[c][s]: the sum so far of output plane q - P + s; plane q of the
  // pre-summed partials adds its tap to each of the W planes it reaches
  T outs[C][W];
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int s = 0; s < W; ++s) outs[c][s] = T(0);

  __syncthreads();  // the offset table is complete

  // The window elements this thread copies are the same for every plane, so
  // their in-plane source offsets stay in registers (the first kNL of them;
  // a window larger than kNL per thread takes the rest through the table).
  // An element whose index rule gives zero is zero in every plane: it is
  // written once here and never copied.
  int loff[kNL];
#pragma unroll
  for (int k = 0; k < kNL; ++k) {
    const int e = tid + k * nthreads;
    const int64_t o = e < NW ? soff[e] : -1;
    loff[k] = (int)o;
    if (e < NW && o < 0)
      for (int sb = 0; sb < S; ++sb) win[sb * NW + e] = T(0);
  }
  const bool tail = NW > kNL * nthreads;

  // input planes q in [i_begin - P, i_end + P); plane q lands in buffer
  // (q - q_begin) % S, its copy started S - 1 steps ahead (one commit per
  // step, empty or not, keeps the group count in step)
  const int q_begin = i_begin - P, q_end = i_end + P;
  int buf = 0;
  auto issue = [&](int q, int sb) {
    const int gq = q < q_end ? kron::resolve(q, g.n0, g.per0) : -1;
    if (gq >= 0) {
      const T* src = a.x + gq * g.s0;
      T* dst = win + sb * NW + tid;
#pragma unroll
      for (int k = 0; k < kNL; ++k)
        if (loff[k] >= 0)
          kron::cp_async_zfill<sizeof(T)>(dst + k * nthreads, src + loff[k],
                                          true);
      if (tail)
        kron::load_window(win + sb * NW, a.x, soff, NW, gq * g.s0,
                          kNL * nthreads);
    }
    kron::cp_async_commit();
  };
  for (int k = 0; k < S - 1; ++k) issue(q_begin + k, k);

  const int64_t plane = (int64_t)g.n1 * g.n2;
  const int64_t base = (int64_t)gj * g.n2 + gl;
  const int64_t xbase = gj * g.s1 + gl * g.s2;
  for (int q = q_begin; q < q_end; ++q) {
    const int gq = kron::resolve(q, g.n0, g.per0);
    issue(q + S - 1, buf == 0 ? S - 1 : buf - 1);

    // the epilogue's operands of the plane this step completes, asked for
    // now so that they arrive under the step's arithmetic
    const int i = q - P;
    const bool emits = i >= i_begin && row_ok;
    const int64_t idx = base + i * plane;
    T acc_v[C], b_v[C], d_v[C], x_v[C], dg[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      acc_v[c] = b_v[c] = d_v[c] = x_v[c] = dg[c] = T(0);
      if (emits && owns[c]) {
        if (has_acc) acc_v[c] = a.acc[idx + c];
        if (need_b) b_v[c] = a.b[idx + c];
        if (MODE == kCheb) {
          if (has_d) d_v[c] = a.d_in[idx + c];
          x_v[c] = a.x[i * g.s0 + xbase + c * g.s2];
        }
        if (need_dg) {
#pragma unroll
          for (int r = 0; r < kRD; ++r)
            if (r < g.R)
              dg[c] = add_rn(dg[c], mul_rn(mul_rn(a.col[0][r * g.n0 + i],
                                                  d1[r]),
                                           d2[r][c]));
          for (int r = kRD; r < g.R; ++r)
            dg[c] = add_rn(dg[c],
                           mul_rn(mul_rn(a.col[0][r * g.n0 + i],
                                         a.col[1][r * g.n1 + gj]),
                                  a.col[2][r * g.n2 + gl + c]));
        }
      }
    }

    kron::cp_async_wait<S - 1>();  // all but the newest S - 1: plane q is in
    __syncthreads();

    if (gq >= 0) {  // a zero ghost plane adds nothing (uniform branch)
      const T* wq = win + buf * NW;
      // axis 2: u[k][rr][l] = sum_t c2r[k][.][t] * window[rr][l + t] for the
      // thread's C columns l, from W + C - 1 window values
      if (in_tile) {
        for (int rr = tj; rr < WR; rr += T1) {
          const T* xrow = wq + rr * WC + tl;
          T xv[W + C - 1];
#pragma unroll
          for (int t = 0; t < W + C - 1; ++t) xv[t] = xrow[t];
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
#pragma unroll
            for (int c = 0; c < C; ++c)
              u[(k * WR + rr) * T2 + tl + c] = s[k][c];
        }
      }
      __syncthreads();
      // axis 1: v[k] = sum_t c1r[k][t] * u[v_src[k]][tj + t][l], then the
      // sums that share an axis-0 band
      if (in_tile) {
        T v[kCV][C];
#pragma unroll
        for (int k = 0; k < kCV; ++k)
#pragma unroll
          for (int c = 0; c < C; ++c) v[k][c] = T(0);
#pragma unroll
        for (int t = 0; t < W; ++t)
#pragma unroll
          for (int k = 0; k < kCV; ++k) {
            T uv[C];
            load_cols<T, C>(u + uoff[k] + t * T2, uv);
#pragma unroll
            for (int c = 0; c < C; ++c) v[k][c] += c1r[k][t] * uv[c];
          }
        T wsum[kCG][C];
#pragma unroll
        for (int gi = 0; gi < kCG; ++gi)
#pragma unroll
          for (int c = 0; c < C; ++c) {
            wsum[gi][c] = gm[gi][0] * v[0][c];
#pragma unroll
            for (int k = 1; k < kCV; ++k) wsum[gi][c] += gm[gi][k] * v[k][c];
          }
        // axis 0: output plane q - P + s takes tap 2P - s of plane q
        const T* cq = c0s + (q - i_begin + P) * W + 2 * P;
#pragma unroll
        for (int gi = 0; gi < kCG; ++gi)
#pragma unroll
          for (int s = 0; s < W; ++s) {
            const T coef = cq[gi * crows * W + s * (W - 1)];
#pragma unroll
            for (int c = 0; c < C; ++c) outs[c][s] += coef * wsum[gi][c];
          }
      }
    }

    if (emits) {  // output plane i: its last input has arrived
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (!owns[c]) continue;
        const T ax = acc_v[c] + outs[c][0];
        T r = ax;
        if (need_b) r = b_v[c] - ax;
        if (need_dg) r = r / dg[c];
        if (MODE == kCheb) {
          T d = a.c2 * r;
          if (has_d) d += a.c1 * d_v[c];
          a.d_out[idx + c] = d;
          a.out[idx + c] = x_v[c] + d;
        } else {
          a.out[idx + c] = r;
        }
      }
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
#pragma unroll
      for (int s = 0; s + 1 < W; ++s) outs[c][s] = outs[c][s + 1];
      outs[c][W - 1] = T(0);
    }
    buf = buf + 1 == S ? 0 : buf + 1;
    // the next step's barrier orders these reads of u before its writes; a
    // window is refilled S - 1 steps after its last read
  }
  kron::cp_async_wait<0>();
}

template <typename T, int P, int MODE>
int launch_pm(const Args<T>& a, cudaStream_t stream) {
  const Geometry& g = a.g;
  constexpr int C = columns<T, P>();
  if (g.threads > kMaxThreads || g.T2 % C != 0 ||
      g.threads < g.T1 * (g.T2 / C) || g.threads % 32 != 0)
    return (int)cudaErrorInvalidConfiguration;
  // the copy offsets a thread keeps are 32-bit: the last in-plane offset
  if ((g.n1 - 1) * g.s1 + (g.n2 - 1) * g.s2 > (int64_t)INT32_MAX)
    return (int)cudaErrorInvalidValue;
  const size_t bytes = smem_bytes<P>(g, sizeof(T));
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kron_march_kernel<T, P, MODE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear it, or the next launch reports it
      return (int)err;
    }
  }
  const dim3 grid((g.n2 + g.T2 - 1) / g.T2, (g.n1 + g.T1 - 1) / g.T1,
                  (g.n0 + g.chunk - 1) / g.chunk);
  kron_march_kernel<T, P, MODE><<<grid, g.threads, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int P>
int launch_p(const Args<T>& a, cudaStream_t stream) {
  switch (a.mode) {
    case kApply: return launch_pm<T, P, kApply>(a, stream);
    case kResidual: return launch_pm<T, P, kResidual>(a, stream);
    case kDinv: return launch_pm<T, P, kDinv>(a, stream);
    default: return launch_pm<T, P, kCheb>(a, stream);
  }
}

// geo: n0 n1 n2 per0 per1 per2 P T1 T2 chunk threads R
// plan: nu nv ng u_lab[kCU] v_src[kCV] v_lab[kCV] g_lab[kCG] g_mult[kCG][kCV]
template <typename T>
int launch(const void* x, const void* b0, const void* b1, const void* b2,
           const void* c0, const void* c1, const void* c2, const void* acc,
           const void* b, const void* d_in, void* d_out, void* out,
           double s1, double s2, int mode, const int64_t* xstrides,
           const int* geo, const int* plan, void* stream) {
  Args<T> a;
  a.x = (const T*)x;
  a.band[0] = (const T*)b0;
  a.band[1] = (const T*)b1;
  a.band[2] = (const T*)b2;
  a.col[0] = (const T*)c0;
  a.col[1] = (const T*)c1;
  a.col[2] = (const T*)c2;
  a.acc = (const T*)acc;
  a.b = (const T*)b;
  a.d_in = (const T*)d_in;
  a.d_out = (T*)d_out;
  a.out = (T*)out;
  a.c1 = (T)s1;
  a.c2 = (T)s2;
  a.mode = mode;
  Geometry& g = a.g;
  g.n0 = geo[0], g.n1 = geo[1], g.n2 = geo[2];
  g.per0 = geo[3], g.per1 = geo[4], g.per2 = geo[5];
  const int P = geo[6];
  g.T1 = geo[7], g.T2 = geo[8], g.chunk = geo[9], g.threads = geo[10];
  g.R = geo[11];
  g.s0 = xstrides[0], g.s1 = xstrides[1], g.s2 = xstrides[2];
  Plan& p = a.p;
  const int* q = plan;
  p.nu = *q++, p.nv = *q++, p.ng = *q++;
  for (int k = 0; k < kCU; ++k) p.u_lab[k] = *q++;
  for (int k = 0; k < kCV; ++k) p.v_src[k] = *q++;
  for (int k = 0; k < kCV; ++k) p.v_lab[k] = *q++;
  for (int k = 0; k < kCG; ++k) p.g_lab[k] = *q++;
  for (int gi = 0; gi < kCG; ++gi)
    for (int k = 0; k < kCV; ++k) p.g_mult[gi][k] = *q++;
  if (p.nu < 1 || p.nu > kCU || p.nv < 1 || p.nv > kCV || p.ng < 1 ||
      p.ng > kCG || g.T1 < 1 || g.T2 < 1 || g.chunk < 1 || mode < 0 ||
      mode > kCheb)
    return (int)cudaErrorInvalidValue;
  if ((mode == kResidual || mode == kCheb) && b == nullptr)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (P) {  // the instantiated half-widths; ops/kron.py pads bands to one
    case 1: return launch_p<T, 1>(a, st);
    case 2: return launch_p<T, 2>(a, st);
    case 3: return launch_p<T, 3>(a, st);
    case 5: return launch_p<T, 5>(a, st);
    case 8: return launch_p<T, 8>(a, st);
    default: return (int)cudaErrorInvalidValue;  // refused: no such kernel
  }
}

}  // namespace

extern "C" {

int kron_apply_f32(const void* x, const void* b0, const void* b1,
                   const void* b2, const void* c0, const void* c1,
                   const void* c2, const void* acc, const void* b,
                   const void* d_in, void* d_out, void* out, double s1,
                   double s2, int mode, const int64_t* xstrides,
                   const int* geo, const int* plan, void* stream) {
  return launch<float>(x, b0, b1, b2, c0, c1, c2, acc, b, d_in, d_out, out,
                       s1, s2, mode, xstrides, geo, plan, stream);
}

int kron_apply_f64(const void* x, const void* b0, const void* b1,
                   const void* b2, const void* c0, const void* c1,
                   const void* c2, const void* acc, const void* b,
                   const void* d_in, void* d_out, void* out, double s1,
                   double s2, int mode, const int64_t* xstrides,
                   const int* geo, const int* plan, void* stream) {
  return launch<double>(x, b0, b1, b2, c0, c1, c2, acc, b, d_in, d_out, out,
                        s1, s2, mode, xstrides, geo, plan, stream);
}

const char* kron_apply_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

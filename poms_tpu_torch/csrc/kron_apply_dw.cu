// K5: the Kronecker-sum residual in double-word f32,
//   (r_h, r_l) = (b_h, b_l) - sum_r (B_r0 (x) B_r1 (x) B_r2) (x_h, x_l),
// every value a pair of floats whose sum carries ~49 bits.
//
// Replaces poms_tpu/ops/twofloat.py::residual_kron_df (no Pallas original:
// one XLA computation under jit there; in eager PyTorch about 3,000
// elementwise launches per apply).  It runs once per dw-PCG iteration, for
// A p.
//
// What bounds it on an H100: the operations.  It moves 3 to 6 fields once
// (25.8 MB for A p at 129^3: 7.7 us at 3.35 TB/s), but every tap is a
// double-word multiply (9 f32 operations) and a double-word add (20), none of
// which may fuse: about 29 x 56 taps = 1,650 operations per point, 3.5 G at
// 129^3, 0.1 ms at the card's 33.5 T non-fused f32 operations per second.
//
// Design: the marching skeleton of K1 (kron_march.cuh, kron_apply.cu) with
// pairs for values.  A block owns a T1 x T2 column of the (axis 1, axis 2)
// grid and marches over a run of axis-0 planes; a thread owns R rows of one
// column (R, 2 or 1, a template parameter the host's tile model picks with
// the tile from the grid and the histories: ops/twofloat.py::K5_ROWS,
// k5_step_cost).  What bounds it is the issue of dependent f32 operations,
// so the design gives each thread many independent double-word chains and
// few other instructions.  Step q of the march, one block barrier:
//   axis 2: plane q + 1's pass into the u buffer this step does not read:
//           each thread contracts its column of the window for the kCU
//           axis-2 bands (in registers), two window rows at a time;
//   axis 1: plane q: each thread contracts the R + 2P u rows of its group
//           for each v: every u pair it reads serves R rows, and the band
//           pairs come from a table in shared memory laid out so that one
//           vector read returns a tap's pairs for the R rows;
//   axis 0: plane q of each history's v brings its tap to the 2P + 1 output
//           planes it reaches, R x CW x (2P + 1) accumulators in registers
//           (a ring, shifted each step), the band pairs of the run from
//           shared memory; plane q - P is then complete and emitted.
// Windows, u partials and band tables hold hi and lo interleaved, so a pair
// is one 64-bit shared load.  The arithmetic has no branch on the plan: an
// absent partial has zero band pairs.  It mirrors the plain version
// operation for operation: each chain takes taps in order t = 0..2P, the
// first tap assigned and the others added with dw_add (on axis 0 output
// plane i receives tap t at step i - P + t, so in order too); one axis-0
// contraction per distinct history (no sum before it); the terms added in
// order; then dw_add(b, -Ax).  Every add and multiply is an intrinsic that
// the compiler never contracts; two_prod is p = fl(a b), e = fma(a, b, -p),
// the pair the plain version rounds from the exact f64 product (the shared
// functions of dw_eft.cuh).  So the words equal the plain version's bit for
// bit (up to the sign of a zero).  With `negate` the pair leaves the kernel
// negated word by word, which is the negated normalised pair: A p itself
// for the b = 0 call of the PCG step.  Bands narrower than the compiled
// half-width are zero-padded: a zero tap adds (0, 0), which leaves a
// normalised pair unchanged.  A zero ghost plane enters axis 0 as zeros.  A
// null x_l or b is a field of zeros: it is neither read nor allocated, the
// arithmetic on its zeros is still done.
//
// The number of distinct histories a launch holds is a template parameter
// (CW): an operator with up to 3 (Poisson: 3) runs the 3-history
// instantiation, one with 4 (the periodic shifted 3D operator: sigma M M M,
// K M M, M K M, M M K) the 4-history one, whose axis-0 ring is a third
// larger; both are bit-equal to the plain version.
//
// One route per half-width (ops/kron.py::COMPILED_P, as for K1): this
// kernel is compiled at half-widths 1, 2 and 3, and bands up to 3 wide are
// padded to the widest of them; every wider band runs on K5r at its own
// half-width, which stepped the headline solve faster than the compiled
// kernels from spline degree 4 on (NVIDIA H100 80GB HBM3).
//
// K5r (k5r_pass_a/b/c, entry kron_residual_dw_rt): bands wider than the
// compiled half-widths, the half-width a launch argument, as three one-axis
// passes through the plan's scratch in device memory (kron_pass.cuh), the
// JAX reference's own structure (residual_kron_df contracts one axis at a
// time): A (axis 2) x -> the u pairs, B (axis 1) u -> each v pair, C (axis
// 0) one contraction per distinct history, then the terms and b - sum as
// emit() forms them.  What bounds it: the operations (29 a tap, none
// fusing), so no pass keeps a ring or recomputes a halo row, and a thread
// owns several outputs whose double-word chains are independent (kRowsA or
// kOutR per partial: up to 8 chains a thread in pass C), in blocks small
// enough that several share an SM.  Each chain's operations are the plain
// version's in its order (taps in order, the first assigned), and a pair
// written to the scratch and read back is exact, so the words equal the
// plain version's.  Its smallest block (one warp a pass) fits the card's
// shared memory up to the half-width ops/kron.py::widest_half_width finds
// for ops/twofloat.py::k5r_smem; wider bands are refused by the host
// (ops/kron.py::refuse_half_width).
//
// More terms than one launch holds (kCU u, kCV v, kCW histories, kCT terms):
// the host splits the terms, in order, into runs that fit, one launch each.
// Every launch but the last writes the double-word sum of its terms added
// onto the previous launch's (acc, read as the first summand), and the last
// one forms dw_add(b, -sum): the additions of the single pass in its order,
// so the words are the same.
//
// Redesigns that were measured and not kept (129^3, p = 3,
// NVIDIA H100 80GB HBM3 at 700 W; ops/twofloat.py::k5_resources reads the
// registers): the band rows and the axis-0 ring in shared memory, two
// columns a thread, no branch on the plan, two blocks of 128 threads an SM
// (72-79 registers, no spill): 0.335-0.355 ms; the same with the ring back
// in registers, three blocks an SM (145 registers): 0.343 ms; against
// 0.327-0.332 ms for the design before this one (one output a thread, the
// axis-1 band rows in registers, axis 0 gathered from a ring of inputs, two
// barriers a plane).  Clock counters in the first showed its arithmetic
// passes issuing about 2.3 f32 instructions a cycle per SM with 8 warps,
// the rate that design's time implies too; runs of fewer planes (more
// blocks) lost more to the blocks' uneven spread over the SMs than they
// gained.
//
// This design keeps the ring in registers and was measured at the grids
// the solves run (same card, in turns with the design before it, words
// equal): A p at 513^3 15.03-15.59 -> 12.10 ms, b - A x with b and x_l
// 18.02-18.09 -> 12.29 ms, 512^3 periodic with 4 histories 16.12-16.18 ->
// 12.06-12.07 ms, 129^3 0.320-0.321 -> 0.283 ms; 166 registers (196 with 4
// histories), no spill, one block of 256 threads an SM.  One row a thread
// at two blocks an SM (121 registers) comes within 5% of two rows at 513^3
// and is faster from 65^3 down, where the tile model takes it.

#include "dw_eft.cuh"
#include "kron_march.cuh"
#include "kron_pass.cuh"

namespace {

using namespace dwf;
using kron::Geometry;

constexpr int kCU = 2;  // u partials (distinct axis-2 bands)
constexpr int kCV = 3;  // v partials
constexpr int kCW = 4;  // distinct full histories, at most (CW = 3 or 4)
constexpr int kCT = 4;  // terms
constexpr int kMaxThreads = 256;

struct Plan {
  int nu, nv, nw, nt;
  int u_lab[kCU];
  int v_src[kCV], v_lab[kCV];
  int w_src[kCW], w_lab[kCW];
  int term_w[kCT];
};

struct Args {
  const float* xh;
  const float* xl;  // null: zeros
  const float* bh;  // null: b = 0 (then bl is null too)
  const float* bl;
  const float* acc_h;  // null: no earlier launch; else its sum of terms
  const float* acc_l;
  const float* band_h[3];  // per axis (labels, n_a, 2P+1)
  const float* band_l[3];
  float* rh;
  float* rl;
  int negate;  // write -(b - A x): A x itself when b = 0
  int last;    // 0: write the sum of the terms so far (acc + this launch's)
  int rows;    // rows of the tile a thread owns (R: 2 or 1)
  Geometry g;
  Plan p;
};

__host__ __device__ constexpr size_t align16(size_t bytes) {
  return (bytes + 15) / 16 * 16;
}

// shared memory of the compiled kernel at R rows a thread and CW histories,
// by byte offset, each section 16-byte aligned (ops/twofloat.py::
// k5_smem_bytes mirrors it): the ring of windows, the u partials of two
// planes, the axis-1 band table of the tile's rows, the axis-0 band rows of
// this run of planes (every value a (hi, lo) pair, 8 bytes), the window's
// in-plane source offsets (int64)
template <int P, int R, int CW>
struct K5Smem {
  size_t win, u, c1, c0, off, bytes;
  __host__ __device__ explicit K5Smem(const Geometry& g) {
    const size_t WR = g.T1 + 2 * P, WC = g.T2 + 2 * P, W = 2 * P + 1;
    const size_t e = sizeof(float2);
    win = 0;
    u = align16(win + kron::kStages * WR * WC * e);
    c1 = align16(u + 2 * kCU * WR * g.T2 * e);
    c0 = align16(c1 + kCV * g.T1 * (R + 2 * P) * e);
    off = align16(c0 + CW * (g.chunk + 4 * P) * W * e);
    bytes = align16(off + WR * WC * sizeof(int64_t));
  }
};

__device__ __forceinline__ dw ld_pair(const float2* p) {
  const float2 v = *p;
  return {v.x, v.y};
}

__device__ __forceinline__ void st_pair(float2* p, dw v) {
  *p = make_float2(v.h, v.l);
}

// the R pairs of shared memory at p, one load (p aligned to R pairs)
template <int R>
__device__ __forceinline__ void ld_pairs(const float2* p, dw (&v)[R]) {
  if constexpr (R == 2) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = dw{q.x, q.y}, v[1] = dw{q.z, q.w};
  } else {
    v[0] = ld_pair(p);
  }
}

// the terms in order, each its history's y, onto the earlier launches' sum
// (or the first term assigned); the last launch writes b - sum (negated on
// request; b from b_at(), called there only), every other one the sum.  The
// choice is a branch around the add, so y is never indexed by a value (which
// would put it in local memory)
template <typename A, int CW, typename B>
__device__ __forceinline__ void emit(const A& a, const dw (&y)[CW],
                                     int64_t idx, B b_at) {
  const Plan& pl = a.p;
  const bool has_acc = a.acc_h != nullptr;
  dw ax = has_acc ? dw{a.acc_h[idx], a.acc_l[idx]} : dw{0.0f, 0.0f};
#pragma unroll
  for (int r = 0; r < kCT; ++r)
#pragma unroll
    for (int k = 0; k < CW; ++k)
      if (r < pl.nt && pl.term_w[r] == k)
        ax = (r == 0 && !has_acc) ? y[k] : dw_add(ax, y[k]);
  if (!a.last) {
    a.rh[idx] = ax.h;
    a.rl[idx] = ax.l;
    return;
  }
  const dw b = b_at();
  const dw r = dw_add(b, dw_neg(ax));
  a.rh[idx] = a.negate ? -r.h : r.h;
  a.rl[idx] = a.negate ? -r.l : r.l;
}

// b at idx (zero where it is absent or this launch is not the last)
template <typename A>
__device__ __forceinline__ dw load_b(const A& a, int64_t idx) {
  return (a.last && a.bh != nullptr) ? dw{a.bh[idx], a.bl[idx]}
                                     : dw{0.0f, 0.0f};
}

template <int P, int R, int CW>
__global__ void __launch_bounds__(kMaxThreads)
kron_march_dw_kernel(const Args a) {
  static_assert(R == 1 || R == 2);
  constexpr int W = 2 * P + 1;
  constexpr int RH = R + 2 * P;     // u rows a row group's outputs reach
  constexpr int S = kron::kStages;  // window buffers, copies started ahead
  const Geometry& g = a.g;
  const Plan& pl = a.p;
  const int T1 = g.T1, T2 = g.T2;  // T1 a multiple of R
  const int NG = T1 / R;           // row groups
  const int WR = T1 + 2 * P, WC = T2 + 2 * P, NW = WR * WC;
  const int UB = kCU * WR * T2;    // one plane's u pairs
  const int crows = g.chunk + 4 * P;
  const int nthreads = blockDim.x;

  const K5Smem<P, R, CW> L(g);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float2* win = reinterpret_cast<float2*>(smem_raw + L.win);
  float2* u = reinterpret_cast<float2*>(smem_raw + L.u);
  float2* c1t = reinterpret_cast<float2*>(smem_raw + L.c1);
  float2* c0t = reinterpret_cast<float2*>(smem_raw + L.c0);
  int64_t* soff = reinterpret_cast<int64_t*>(smem_raw + L.off);

  const int tid = threadIdx.x;
  const int tg = tid / T2, tl = tid - tg * T2;  // row group, column
  const bool in_tile = tid < NG * T2;
  const int j0 = blockIdx.y * T1, l0 = blockIdx.x * T2;
  const int gj = j0 + tg * R, gl = l0 + tl;  // first row owned, column
  const int nrow = in_tile && gl < g.n2 ? min(R, g.n1 - gj) : 0;
  const int i_begin = blockIdx.z * g.chunk;
  const int i_end = min(i_begin + g.chunk, g.n0);

  // input planes q in [i_begin - P, i_end + P): plane q lands in window
  // buffer (q - q_begin) % S, its copy started S steps before its axis-2
  // pass; one commit per plane, empty or not, keeps the group count in step.
  // A window holds (hi, lo) pairs: a thread copies the words of the
  // elements whose offsets it wrote, so the first copies need no barrier
  const int q_begin = i_begin - P, q_end = i_end + P;
  auto issue = [&](int q) {
    const int gq = q < q_end ? kron::resolve(q, g.n0, g.per0) : -1;
    if (gq >= 0) {
      float2* dst = win + (q - q_begin) % S * NW;
      const int64_t base = (int64_t)gq * g.s0;
      for (int e = tid; e < NW; e += nthreads) {
        const int64_t o = soff[e];
        const int64_t src = o < 0 ? 0 : base + o;
        kron::cp_async_zfill<4>(&dst[e].x, a.xh + src, o >= 0);
        if (a.xl != nullptr)
          kron::cp_async_zfill<4>(&dst[e].y, a.xl + src, o >= 0);
      }
    }
    kron::cp_async_commit();
  };
  kron::build_window_offsets(soff, g, P, j0, l0);
  if (a.xl == nullptr)  // the low word is zero: fill once, never load
    for (int e = tid; e < S * NW; e += nthreads) win[e].y = 0.0f;
  for (int k = 0; k < S; ++k) issue(q_begin + k);

  // the tables, while the first planes arrive.  This thread's axis-2 band
  // rows at its column (in registers for the march); an absent partial has
  // zero rows, so the arithmetic below needs no branch on the plan
  dw c2r[kCU][W];
#pragma unroll
  for (int k = 0; k < kCU; ++k)
#pragma unroll
    for (int t = 0; t < W; ++t) {
      const bool ok = k < pl.nu && in_tile && gl < g.n2;
      const int64_t src = ((int64_t)(ok ? pl.u_lab[k] : 0) * g.n2 +
                           (ok ? gl : 0)) * W + t;
      c2r[k][t] = ok ? dw{a.band_h[2][src], a.band_l[2][src]}
                     : dw{0.0f, 0.0f};
    }
  // axis-1 band rows as the row groups read them:
  // c1t[((k * NG + grp) * RH + p) * R + r] multiplies u row p of group grp
  // for its output row r, tap p - r of band row j0 + grp * R + r; zero off
  // the band, past the grid and for absent partials
  for (int e = tid; e < kCV * T1 * RH; e += nthreads) {
    const int r = e % R, p = e / R % RH, kg = e / (R * RH);
    const int k = kg / NG, j = j0 + (kg - k * NG) * R + r, t = p - r;
    const bool ok = k < pl.nv && j < g.n1 && t >= 0 && t < W;
    const int64_t src = ok ? ((int64_t)pl.v_lab[k] * g.n1 + j) * W + t : 0;
    c1t[e] = ok ? make_float2(a.band_h[1][src], a.band_l[1][src])
                : make_float2(0.0f, 0.0f);
  }
  // axis-0 band rows of output planes [i_begin - 2P, i_begin + chunk + 2P),
  // per history: zero outside the grid and for absent histories
  for (int e = tid; e < CW * crows * W; e += nthreads) {
    const int k = e / (crows * W);
    const int rem = e - k * crows * W;
    const int i = i_begin - 2 * P + rem / W;
    const bool ok = k < pl.nw && i >= 0 && i < g.n0;
    const int64_t src =
        ok ? ((int64_t)pl.w_lab[k] * g.n0 + i) * W + rem % W : 0;
    c0t[e] = ok ? make_float2(a.band_h[0][src], a.band_l[0][src])
                : make_float2(0.0f, 0.0f);
  }
  int uoff[kCV];  // where each v reads its u rows
#pragma unroll
  for (int k = 0; k < kCV; ++k)
    uoff[k] = ((k < pl.nv ? pl.v_src[k] : 0) * WR + tg * R) * T2 + tl;

  // outs[k][s][r]: history k of output plane q - P + s at row r, its taps
  // so far; plane q of the v's brings tap 2P - s to each of the W planes it
  // reaches, the first tap assigned, so each chain is the plain version's
  dw outs[CW][W][R];
#pragma unroll
  for (int k = 0; k < CW; ++k)
#pragma unroll
    for (int s = 0; s < W; ++s)
#pragma unroll
      for (int r = 0; r < R; ++r) outs[k][s][r] = dw{0.0f, 0.0f};

  // axis 2 of the plane in window wq into the u pairs uq:
  // u[k][rr][l] = sum_t c2r[k][t] * window[rr][l + t], taps in order, the
  // first assigned, over the window rows of this row group's turn, two rows
  // at a time (2 kCU independent chains)
  auto axis2 = [&](const float2* wq, float2* uq) {
    if (!in_tile) return;
    int rr = tg;
    for (; rr + NG < WR; rr += 2 * NG) {
      const float2* x0 = wq + rr * WC + tl;
      const float2* x1 = x0 + NG * WC;
      dw s[kCU][2];
      const dw a0 = ld_pair(x0), a1 = ld_pair(x1);
#pragma unroll
      for (int k = 0; k < kCU; ++k) {
        s[k][0] = dw_mul(c2r[k][0], a0);
        s[k][1] = dw_mul(c2r[k][0], a1);
      }
#pragma unroll
      for (int t = 1; t < W; ++t) {
        const dw b0 = ld_pair(x0 + t), b1 = ld_pair(x1 + t);
#pragma unroll
        for (int k = 0; k < kCU; ++k) {
          s[k][0] = dw_add(s[k][0], dw_mul(c2r[k][t], b0));
          s[k][1] = dw_add(s[k][1], dw_mul(c2r[k][t], b1));
        }
      }
#pragma unroll
      for (int k = 0; k < kCU; ++k) {
        st_pair(uq + (k * WR + rr) * T2 + tl, s[k][0]);
        st_pair(uq + (k * WR + rr + NG) * T2 + tl, s[k][1]);
      }
    }
    if (rr < WR) {
      const float2* x0 = wq + rr * WC + tl;
      dw s[kCU];
      const dw a0 = ld_pair(x0);
#pragma unroll
      for (int k = 0; k < kCU; ++k) s[k] = dw_mul(c2r[k][0], a0);
#pragma unroll
      for (int t = 1; t < W; ++t) {
        const dw b0 = ld_pair(x0 + t);
#pragma unroll
        for (int k = 0; k < kCU; ++k)
          s[k] = dw_add(s[k], dw_mul(c2r[k][t], b0));
      }
#pragma unroll
      for (int k = 0; k < kCU; ++k)
        st_pair(uq + (k * WR + rr) * T2 + tl, s[k]);
    }
  };

  kron::cp_async_wait<S - 1>();  // plane q_begin is in
  __syncthreads();                // and the tables are complete
  if (kron::resolve(q_begin, g.n0, g.per0) >= 0) axis2(win, u);

  const int64_t plane = (int64_t)g.n1 * g.n2;
  const int64_t base = (int64_t)gj * g.n2 + gl;
  // The march.  One barrier a step: step q runs the axis-2 pass of plane
  // q + 1 (into the u buffer this step does not read) beside the axis-1
  // and axis-0 passes of plane q.
  for (int q = q_begin; q < q_end; ++q) {
    const int step = q - q_begin;

    // b of the plane this step completes, asked for now so that it arrives
    // under the step's arithmetic
    const int i = q - P;
    const bool emits = i >= i_begin;
    const int64_t idx = base + i * plane;
    dw bv[R];
#pragma unroll
    for (int r = 0; r < R; ++r)
      bv[r] = emits && r < nrow ? load_b(a, idx + r * g.n2) : dw{0.0f, 0.0f};

    kron::cp_async_wait<S - 2>();  // plane q + 1 is in
    __syncthreads();
    // this barrier orders the last step's reads of plane q's window and of
    // u buffer (step + 1) & 1 before the writes below
    issue(q + S);
    if (q + 1 < q_end && kron::resolve(q + 1, g.n0, g.per0) >= 0)
      axis2(win + (step + 1) % S * NW, u + ((step + 1) & 1) * UB);

    if (!in_tile) continue;
    // axis 1: v[k][r] = sum_t B1[v_lab[k]][gj + r][t] * u[v_src[k]] at row
    // gj + r + t - P (u row r + t of the group's window), taps in order, the
    // first assigned; every u pair serves R rows.  A zero ghost plane
    // enters as zeros
    dw v[kCV][R];
    if (kron::resolve(q, g.n0, g.per0) >= 0) {
      const float2* uq = u + (step & 1) * UB;
      const float2* cg = c1t + tg * RH * R;
#pragma unroll
      for (int p = 0; p < RH; ++p)
#pragma unroll
        for (int k = 0; k < kCV; ++k) {
          const dw uv = ld_pair(uq + uoff[k] + p * T2);
          dw cv[R];
          ld_pairs<R>(cg + (k * NG * RH + p) * R, cv);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const int t = p - r;
            if (t < 0 || t >= W) continue;
            const dw m = dw_mul(cv[r], uv);
            v[k][r] = t == 0 ? m : dw_add(v[k][r], m);
          }
        }
    } else {
#pragma unroll
      for (int k = 0; k < kCV; ++k)
#pragma unroll
        for (int r = 0; r < R; ++r) v[k][r] = dw{0.0f, 0.0f};
    }
    // axis 0: history k contracts v[w_src[k]]; output plane q - P + s takes
    // tap 2P - s of plane q (tap 0, the newest plane's, assigned)
    const float2* cq = c0t + (q - i_begin + P) * W + 2 * P;
#pragma unroll
    for (int k = 0; k < CW; ++k) {
      dw w[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        w[r] = dw{0.0f, 0.0f};
#pragma unroll
        for (int kk = 0; kk < kCV; ++kk)
          if (k < pl.nw && pl.w_src[k] == kk) w[r] = v[kk][r];
      }
#pragma unroll
      for (int s = 0; s < W; ++s) {
        const dw c = ld_pair(cq + k * crows * W + s * (W - 1));
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const dw m = dw_mul(c, w[r]);
          outs[k][s][r] = s == W - 1 ? m : dw_add(outs[k][s][r], m);
        }
      }
    }

    if (emits) {  // output plane i: its last tap has arrived
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r >= nrow) continue;
        dw y[CW];
#pragma unroll
        for (int k = 0; k < CW; ++k) y[k] = outs[k][0][r];
        emit(a, y, idx + r * g.n2, [&] { return bv[r]; });
      }
    }
#pragma unroll
    for (int k = 0; k < CW; ++k)
#pragma unroll
      for (int s = 0; s + 1 < W; ++s)
#pragma unroll
        for (int r = 0; r < R; ++r) outs[k][s][r] = outs[k][s + 1][r];
  }
  kron::cp_async_wait<0>();
}

// -- K5r: three one-axis passes (see the note at the top) --------------------

constexpr int kRowsA = 2;  // pass A: rows of the field a thread
constexpr int kOutR = 2;   // passes B and C: outputs along the axis a thread

// geometry of the run-time passes: the field, the half-width, the warps of
// a block of each pass (pass A: 32 columns, kRowsA rows a warp)
struct RtGeo {
  int n0, n1, n2;
  int per0, per1, per2;
  int P;
  int NWA, NWB, NWC;
};

struct RtArgs {
  const float* xh;
  const float* xl;  // null: zeros
  const float* bh;  // null: b = 0 (then bl is null too)
  const float* bl;
  const float* acc_h;  // null: no earlier launch; else its sum of terms
  const float* acc_l;
  const float* band_h[3];
  const float* band_l[3];
  float* rh;
  float* rl;
  int negate;
  int last;
  // the plan's scratch, each a contiguous (n0, n1, n2) f32 field: the hi
  // and lo words of the kCU u partials, then of the kCV v partials
  float* scratch;
  // this pass's band table for this run of terms, laid out by the host
  // (ops/twofloat.py::k5r_tables) as each block's shared memory holds it,
  // hi then lo: per tile of columns (k, t, column) in pass A, per block of
  // outputs (k, output, t) in B and C
  const float* table;
  RtGeo g;
  Plan p;
};

// shared memory of each pass, in bytes (ops/twofloat.py::k5r_smem mirrors
// it): the staged tile and the band rows, hi and lo
__host__ __device__ inline size_t smem_pass(int pass, int NW, int P) {
  const size_t W = 2 * P + 1, L = kpass::kLanes;
  if (pass == 0)
    return 2 * ((size_t)NW * kRowsA * (L + 2 * P) + kCU * W * L) *
           sizeof(float);
  const size_t rows = (size_t)NW * kOutR + 2 * P;
  const int sources = pass == 1 ? kCU : kCV, bands = pass == 1 ? kCV : kCW;
  return 2 * (sources * rows * L + (size_t)bands * NW * kOutR * W) *
         sizeof(float);
}

// stage a strided pass's tile of a double-word field (hi, lo)
__device__ __forceinline__ void stage_pair(float* th, float* tl,
                                           const float* fh, const float* fl,
                                           int64_t sa, int n_a, int per,
                                           int a0, int P, int rows, int l0,
                                           int n2) {
  kpass::stage_strided(th, fh, sa, n_a, per, a0, P, rows, l0, n2);
  kpass::stage_strided(tl, fl, sa, n_a, per, a0, P, rows, l0, n2);
}

// Pass A, axis 2: u[k] = sum_t B2[u_lab[k]][l][t] x[.., l + t - P] in
// double-word, the first tap assigned and the others added in order.  A
// thread owns one column of kRowsA rows: kRowsA * nu independent chains.
__global__ void __launch_bounds__(kMaxThreads) k5r_pass_a(const RtArgs a) {
  const RtGeo& g = a.g;
  const Plan& pl = a.p;
  const int P = g.P, W = 2 * P + 1, L = kpass::kLanes, WC = L + 2 * P;
  const int rows = g.NWA * kRowsA;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* wh = reinterpret_cast<float*>(smem_raw);  // rows x WC
  float* wl = wh + rows * WC;
  float* ch = wl + rows * WC;  // (k, t, column)
  float* cl = ch + kCU * W * L;
  const int l0 = blockIdx.x * L;
  const int64_t row0 = (int64_t)blockIdx.y * rows;
  const int64_t nrows = (int64_t)g.n0 * g.n1;
  // the window: a warp a row at a time, a lane a column
  for (int r = threadIdx.x / L; r < rows; r += blockDim.x / L) {
    const int64_t row = row0 + r;
    for (int c = threadIdx.x % L; c < WC; c += L) {
      const int gl = kron::resolve(l0 - P + c, g.n2, g.per2);
      const int64_t off = (row < nrows && gl >= 0) ? row * g.n2 + gl : -1;
      kpass::stage<float, float>(wh + r * WC + c, a.xh, off);
      if (a.xl != nullptr)
        kpass::stage<float, float>(wl + r * WC + c, a.xl, off);
      else
        wl[r * WC + c] = 0.0f;  // the low word is zero: never loaded
    }
  }
  kpass::copy_table(ch, a.table + (int64_t)blockIdx.x * 2 * kCU * W * L,
                    2 * kCU * W * L);
  kron::cp_async_commit();
  kron::cp_async_wait<0>();
  __syncthreads();

  const int lane = threadIdx.x % L, grp = threadIdx.x / L;
  const int nu = pl.nu;
  dw s[kCU][kRowsA];
  const int xb = grp * kRowsA * WC + lane;
#pragma unroll
  for (int k = 0; k < kCU; ++k) {
    const dw c = dw{ch[k * W * L + lane], cl[k * W * L + lane]};
#pragma unroll
    for (int r = 0; r < kRowsA; ++r)
      s[k][r] = k < nu ? dw_mul(c, dw{wh[xb + r * WC], wl[xb + r * WC]})
                       : dw{0.0f, 0.0f};
  }
  for (int t = 1; t < W; ++t) {
    dw x[kRowsA];
#pragma unroll
    for (int r = 0; r < kRowsA; ++r)
      x[r] = dw{wh[xb + r * WC + t], wl[xb + r * WC + t]};
#pragma unroll
    for (int k = 0; k < kCU; ++k) {
      if (k >= nu) break;
      const int cb = (k * W + t) * L + lane;
      const dw c = dw{ch[cb], cl[cb]};
#pragma unroll
      for (int r = 0; r < kRowsA; ++r)
        s[k][r] = dw_add(s[k][r], dw_mul(c, x[r]));
    }
  }
  const int l = l0 + lane;
  if (l >= g.n2) return;
  const int64_t npts = nrows * g.n2;
#pragma unroll
  for (int r = 0; r < kRowsA; ++r) {
    const int64_t row = row0 + grp * kRowsA + r;
    if (row >= nrows) break;
#pragma unroll
    for (int k = 0; k < kCU; ++k) {
      if (k >= nu) break;
      a.scratch[2 * k * npts + row * g.n2 + l] = s[k][r].h;
      a.scratch[(2 * k + 1) * npts + row * g.n2 + l] = s[k][r].l;
    }
  }
}

// Pass B, axis 1: v[k] = sum_t B1[v_lab[k]][j][t] u[v_src[k]][.., j + t -
// P, ..], each v written on its own (the double-word kernel sums no
// partials before the last contraction).  A thread owns kOutR outputs along
// axis 1: kOutR * nv independent chains.
__global__ void __launch_bounds__(kMaxThreads) k5r_pass_b(const RtArgs a) {
  const RtGeo& g = a.g;
  const Plan& pl = a.p;
  const int P = g.P, W = 2 * P + 1, L = kpass::kLanes, NW = g.NWB;
  const int TA = NW * kOutR, TAH = TA + 2 * P;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* th = reinterpret_cast<float*>(smem_raw);  // (source, row, lane)
  float* tl = th + kCU * TAH * L;
  float* bdh = tl + kCU * TAH * L;  // (k, output, t)
  float* bdl = bdh + kCV * TA * W;
  const int l0 = blockIdx.x * L, j0 = blockIdx.y * TA, i = blockIdx.z;
  const int64_t plane = (int64_t)g.n1 * g.n2, npts = plane * g.n0;
  for (int s = 0; s < pl.nu; ++s)
    stage_pair(th + s * TAH * L, tl + s * TAH * L,
               a.scratch + 2 * s * npts + i * plane,
               a.scratch + (2 * s + 1) * npts + i * plane, g.n2, g.n1,
               g.per1, j0, P, TAH, l0, g.n2);
  kpass::copy_table(bdh, a.table + (int64_t)blockIdx.y * 2 * kCV * TA * W,
                    2 * kCV * TA * W);
  kron::cp_async_commit();
  kron::cp_async_wait<0>();
  __syncthreads();

  const int lane = threadIdx.x % L, grp = threadIdx.x / L;
  const int nv = pl.nv;
  dw s[kCV][kOutR];
  int ub[kCV];  // where each v reads its u column
#pragma unroll
  for (int k = 0; k < kCV; ++k) {
    ub[k] = ((k < nv ? pl.v_src[k] : 0) * TAH + grp * kOutR) * L + lane;
#pragma unroll
    for (int r = 0; r < kOutR; ++r) {
      const int cb = (k * TA + grp * kOutR + r) * W;
      const int ui = ub[k] + r * L;
      s[k][r] = k < nv ? dw_mul(dw{bdh[cb], bdl[cb]}, dw{th[ui], tl[ui]})
                       : dw{0.0f, 0.0f};
    }
  }
  for (int t = 1; t < W; ++t) {
#pragma unroll
    for (int k = 0; k < kCV; ++k) {
      if (k >= nv) break;
#pragma unroll
      for (int r = 0; r < kOutR; ++r) {
        const int cb = (k * TA + grp * kOutR + r) * W + t;
        const int ui = ub[k] + (r + t) * L;
        s[k][r] = dw_add(s[k][r], dw_mul(dw{bdh[cb], bdl[cb]},
                                         dw{th[ui], tl[ui]}));
      }
    }
  }
  const int l = l0 + lane;
  if (l >= g.n2) return;
#pragma unroll
  for (int r = 0; r < kOutR; ++r) {
    const int j = j0 + grp * kOutR + r;
    if (j >= g.n1) break;
    const int64_t idx = i * plane + (int64_t)j * g.n2 + l;
#pragma unroll
    for (int k = 0; k < kCV; ++k) {
      if (k >= nv) break;
      a.scratch[2 * (kCU + k) * npts + idx] = s[k][r].h;
      a.scratch[(2 * (kCU + k) + 1) * npts + idx] = s[k][r].l;
    }
  }
}

// Pass C, axis 0: the history k = sum_t B0[w_lab[k]][i][t] v[w_src[k]][i +
// t - P, ..] for each distinct history, then the terms in order onto the
// earlier launches' sum and the last launch's b - sum (emit).  A thread
// owns kOutR outputs along axis 0: kOutR * nw independent chains.
__global__ void __launch_bounds__(kMaxThreads) k5r_pass_c(const RtArgs a) {
  const RtGeo& g = a.g;
  const Plan& pl = a.p;
  const int P = g.P, W = 2 * P + 1, L = kpass::kLanes, NW = g.NWC;
  const int TA = NW * kOutR, TAH = TA + 2 * P;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* th = reinterpret_cast<float*>(smem_raw);  // (v, row, lane)
  float* tl = th + kCV * TAH * L;
  float* bdh = tl + kCV * TAH * L;  // (history, output, t)
  float* bdl = bdh + kCW * TA * W;
  const int l0 = blockIdx.x * L, j = blockIdx.y, i0 = blockIdx.z * TA;
  const int64_t plane = (int64_t)g.n1 * g.n2, npts = plane * g.n0;
  for (int s = 0; s < pl.nv; ++s)
    stage_pair(th + s * TAH * L, tl + s * TAH * L,
               a.scratch + 2 * (kCU + s) * npts + (int64_t)j * g.n2,
               a.scratch + (2 * (kCU + s) + 1) * npts + (int64_t)j * g.n2,
               plane, g.n0, g.per0, i0, P, TAH, l0, g.n2);
  kpass::copy_table(bdh, a.table + (int64_t)blockIdx.z * 2 * kCW * TA * W,
                    2 * kCW * TA * W);
  kron::cp_async_commit();
  kron::cp_async_wait<0>();
  __syncthreads();

  const int lane = threadIdx.x % L, grp = threadIdx.x / L;
  const int nw = pl.nw;
  dw y[kCW][kOutR];
  int vb[kCW];  // where each history reads its v column
#pragma unroll
  for (int k = 0; k < kCW; ++k) {
    vb[k] = ((k < nw ? pl.w_src[k] : 0) * TAH + grp * kOutR) * L + lane;
#pragma unroll
    for (int r = 0; r < kOutR; ++r) {
      const int cb = (k * TA + grp * kOutR + r) * W;
      const int vi = vb[k] + r * L;
      y[k][r] = k < nw ? dw_mul(dw{bdh[cb], bdl[cb]}, dw{th[vi], tl[vi]})
                       : dw{0.0f, 0.0f};
    }
  }
  for (int t = 1; t < W; ++t) {
#pragma unroll
    for (int k = 0; k < kCW; ++k) {
      if (k >= nw) break;
#pragma unroll
      for (int r = 0; r < kOutR; ++r) {
        const int cb = (k * TA + grp * kOutR + r) * W + t;
        const int vi = vb[k] + (r + t) * L;
        y[k][r] = dw_add(y[k][r], dw_mul(dw{bdh[cb], bdl[cb]},
                                         dw{th[vi], tl[vi]}));
      }
    }
  }
  const int l = l0 + lane;
  if (l >= g.n2) return;
#pragma unroll
  for (int r = 0; r < kOutR; ++r) {
    const int i = i0 + grp * kOutR + r;
    if (i >= g.n0) break;
    dw yr[kCW];
#pragma unroll
    for (int k = 0; k < kCW; ++k) yr[k] = y[k][r];
    const int64_t idx = i * plane + (int64_t)j * g.n2 + l;
    emit(a, yr, idx, [&] {
      return a.bh != nullptr ? dw{a.bh[idx], a.bl[idx]} : dw{0.0f, 0.0f};
    });
  }
}

template <int P, int R, int CW>
int launch_prw(const Args& a, cudaStream_t stream) {
  const Geometry& g = a.g;
  if (g.threads > kMaxThreads || g.threads < g.T1 / R * g.T2 ||
      g.threads % 32 != 0 || g.T1 % R != 0)
    return (int)cudaErrorInvalidConfiguration;
  const size_t bytes = K5Smem<P, R, CW>(g).bytes;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kron_march_dw_kernel<P, R, CW>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear it, or the next launch reports it
      return (int)err;
    }
  }
  const dim3 grid((g.n2 + g.T2 - 1) / g.T2, (g.n1 + g.T1 - 1) / g.T1,
                  (g.n0 + g.chunk - 1) / g.chunk);
  kron_march_dw_kernel<P, R, CW><<<grid, g.threads, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

// the instantiation of the launch's rows a thread (2 or 1) and histories
// (3, or 4 for up to kCW)
template <int P>
int launch_p(const Args& a, cudaStream_t stream) {
  if (a.rows == 2)
    return a.p.nw <= 3 ? launch_prw<P, 2, 3>(a, stream)
                       : launch_prw<P, 2, 4>(a, stream);
  return a.p.nw <= 3 ? launch_prw<P, 1, 3>(a, stream)
                     : launch_prw<P, 1, 4>(a, stream);
}

// K5r: one pass (0 A, 1 B, 2 C) of the run-time design
int launch_rt(int pass, const RtArgs& a, cudaStream_t stream) {
  const RtGeo& g = a.g;
  const int NW = pass == 0 ? g.NWA : pass == 1 ? g.NWB : g.NWC;
  if (g.P < 1 || NW < 1 || NW > kpass::kMaxWarps || a.scratch == nullptr ||
      a.table == nullptr)
    return (int)cudaErrorInvalidConfiguration;
  const size_t bytes = smem_pass(pass, NW, g.P);
  const int threads = NW * kpass::kLanes;
  const int tiles2 = (g.n2 + kpass::kLanes - 1) / kpass::kLanes;
  const auto kernel = pass == 0 ? k5r_pass_a : pass == 1 ? k5r_pass_b
                                                         : k5r_pass_c;
  const cudaError_t err = kpass::allow_smem(kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid;
  if (pass == 0) {
    const int64_t rows = (int64_t)g.n0 * g.n1, per = NW * kRowsA;
    grid = dim3(tiles2, (unsigned)((rows + per - 1) / per));
  } else if (pass == 1) {
    grid = dim3(tiles2, (g.n1 + NW * kOutR - 1) / (NW * kOutR), g.n0);
  } else {
    grid = dim3(tiles2, g.n1, (g.n0 + NW * kOutR - 1) / (NW * kOutR));
  }
  kernel<<<grid, threads, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int P, int R, int CW>
int resources_prw(const Args& a, int* out) {
  return kron::resources_of(kron_march_dw_kernel<P, R, CW>, a.g.threads,
                            K5Smem<P, R, CW>(a.g).bytes, out);
}

template <int P>
int resources_p(const Args& a, int* out) {
  if (a.rows == 2)
    return a.p.nw <= 3 ? resources_prw<P, 2, 3>(a, out)
                       : resources_prw<P, 2, 4>(a, out);
  return a.p.nw <= 3 ? resources_prw<P, 1, 3>(a, out)
                     : resources_prw<P, 1, 4>(a, out);
}

// plan: nu nv nw nt u_lab[kCU] v_src[kCV] v_lab[kCV] w_src[kCW] w_lab[kCW]
//       term_w[kCT]
bool parse_plan(const int* plan, Plan& p) {
  const int* q = plan;
  p.nu = *q++, p.nv = *q++, p.nw = *q++, p.nt = *q++;
  for (int k = 0; k < kCU; ++k) p.u_lab[k] = *q++;
  for (int k = 0; k < kCV; ++k) p.v_src[k] = *q++;
  for (int k = 0; k < kCV; ++k) p.v_lab[k] = *q++;
  for (int k = 0; k < kCW; ++k) p.w_src[k] = *q++;
  for (int k = 0; k < kCW; ++k) p.w_lab[k] = *q++;
  for (int k = 0; k < kCT; ++k) p.term_w[k] = *q++;
  return !(p.nu < 1 || p.nu > kCU || p.nv < 1 || p.nv > kCV || p.nw < 1 ||
           p.nw > kCW || p.nt < 1 || p.nt > kCT);
}

// geo: n0 n1 n2 per0 per1 per2 P T1 T2 chunk threads R rows
bool parse(const int* geo, const int* plan, Args& a, int& P) {
  Geometry& g = a.g;
  g.n0 = geo[0], g.n1 = geo[1], g.n2 = geo[2];
  g.per0 = geo[3], g.per1 = geo[4], g.per2 = geo[5];
  P = geo[6];
  g.T1 = geo[7], g.T2 = geo[8], g.chunk = geo[9], g.threads = geo[10];
  g.R = geo[11];
  a.rows = geo[12];
  g.s0 = (int64_t)g.n1 * g.n2, g.s1 = g.n2, g.s2 = 1;  // contiguous fields
  return parse_plan(plan, a.p) && g.T1 >= 1 && g.T2 >= 1 && g.chunk >= 1 &&
         (a.rows == 1 || a.rows == 2);
}

// the arguments of one launch, checked: false for an invalid plan or
// operands that must come in pairs
bool pack(const float* xh, const float* xl, const float* bh, const float* bl,
          const float* acc_h, const float* acc_l, const float* b0h,
          const float* b0l, const float* b1h, const float* b1l,
          const float* b2h, const float* b2l, float* rh, float* rl,
          const int* geo, const int* plan, int negate, int last, Args& a,
          int& P) {
  a.xh = xh, a.xl = xl, a.bh = bh, a.bl = bl;
  a.acc_h = acc_h, a.acc_l = acc_l, a.last = last;
  a.band_h[0] = b0h, a.band_h[1] = b1h, a.band_h[2] = b2h;
  a.band_l[0] = b0l, a.band_l[1] = b1l, a.band_l[2] = b2l;
  a.rh = rh, a.rl = rl, a.negate = negate;
  return parse(geo, plan, a, P) && (bh == nullptr) == (bl == nullptr) &&
         (acc_h == nullptr) == (acc_l == nullptr);
}

// K5r's geo: n0 n1 n2 per0 per1 per2 P R NWA NWB NWC
bool parse_rt(const int* geo, const int* plan, RtArgs& a) {
  RtGeo& g = a.g;
  g.n0 = geo[0], g.n1 = geo[1], g.n2 = geo[2];
  g.per0 = geo[3], g.per1 = geo[4], g.per2 = geo[5];
  g.P = geo[6];
  g.NWA = geo[8], g.NWB = geo[9], g.NWC = geo[10];
  return parse_plan(plan, a.p);
}

// the error-free transformations on their own, for the exactness check:
// out is (8, n): two_sum(ah, bh), two_prod(ah, bh), dw_mul(a, b), dw_add(a, b)
__global__ void eft_test_kernel(const float* ah, const float* al,
                                const float* bh, const float* bl, float* out,
                                int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const dw x{ah[i], al[i]}, y{bh[i], bl[i]};
  const dw s = two_sum(x.h, y.h), p = two_prod(x.h, y.h);
  const dw m = dw_mul(x, y), d = dw_add(x, y);
  const float vals[8] = {s.h, s.l, p.h, p.l, m.h, m.l, d.h, d.l};
  for (int k = 0; k < 8; ++k) out[(int64_t)k * n + i] = vals[k];
}

}  // namespace

extern "C" {

// geo and plan: as parse() reads them (ops/twofloat.py::_df_c_args)
// acc_h/acc_l: the sum of the terms of the earlier launches (null for the
// first); last: 1 writes (b - sum) (negated on request), 0 the sum
int kron_residual_dw(const float* xh, const float* xl, const float* bh,
                     const float* bl, const float* acc_h, const float* acc_l,
                     const float* b0h, const float* b0l, const float* b1h,
                     const float* b1l, const float* b2h, const float* b2l,
                     float* rh, float* rl, const int* geo, const int* plan,
                     int negate, int last, void* stream) {
  Args a;
  int P;
  if (!pack(xh, xl, bh, bl, acc_h, acc_l, b0h, b0l, b1h, b1l, b2h, b2l, rh,
            rl, geo, plan, negate, last, a, P))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (P) {  // the compiled half-widths; ops/kron.py pads bands to one
    case 1: return launch_p<1>(a, st);
    case 2: return launch_p<2>(a, st);
    case 3: return launch_p<3>(a, st);
    default: return (int)cudaErrorInvalidValue;  // no such kernel: K5r's
  }
}

// K5r, one pass (0: A, 1: B, 2: C) of the run-time design: the compiled
// entry's arguments, K5r's geo, the plan's scratch (2 (kCU + kCV) f32
// fields) and the pass's band table of the run
int kron_residual_dw_rt(int pass, const float* xh, const float* xl,
                        const float* bh, const float* bl, const float* acc_h,
                        const float* acc_l, const float* b0h,
                        const float* b0l, const float* b1h, const float* b1l,
                        const float* b2h, const float* b2l, float* rh,
                        float* rl, const int* geo, const int* plan,
                        int negate, int last, float* scratch,
                        const float* table, void* stream) {
  RtArgs a;
  a.xh = xh, a.xl = xl, a.bh = bh, a.bl = bl;
  a.acc_h = acc_h, a.acc_l = acc_l, a.last = last, a.negate = negate;
  a.band_h[0] = b0h, a.band_h[1] = b1h, a.band_h[2] = b2h;
  a.band_l[0] = b0l, a.band_l[1] = b1l, a.band_l[2] = b2l;
  a.rh = rh, a.rl = rl, a.scratch = scratch, a.table = table;
  if (!parse_rt(geo, plan, a) || pass < 0 || pass > 2 ||
      (bh == nullptr) != (bl == nullptr) ||
      (acc_h == nullptr) != (acc_l == nullptr) ||
      (pass == 2 && (rh == nullptr || rl == nullptr)))
    return (int)cudaErrorInvalidValue;
  return launch_rt(pass, a, (cudaStream_t)stream);
}

// out: registers a thread, local memory a thread in bytes (spills), shared
// memory a block in bytes, blocks an SM holds, for the launch of geo and plan
// (pass -1: the compiled kernel's; 0-2: K5r's pass, geo then K5r's)
int kron_residual_dw_resources(const int* geo, const int* plan, int* out,
                               int pass) {
  if (pass >= 0) {
    RtArgs a;
    if (!parse_rt(geo, plan, a) || pass > 2) return (int)cudaErrorInvalidValue;
    const int NW = pass == 0 ? a.g.NWA : pass == 1 ? a.g.NWB : a.g.NWC;
    const auto kernel = pass == 0 ? k5r_pass_a : pass == 1 ? k5r_pass_b
                                                           : k5r_pass_c;
    return kron::resources_of(kernel, NW * kpass::kLanes,
                              smem_pass(pass, NW, a.g.P), out);
  }
  Args a;
  int P;
  if (!parse(geo, plan, a, P)) return (int)cudaErrorInvalidValue;
  switch (P) {
    case 1: return resources_p<1>(a, out);
    case 2: return resources_p<2>(a, out);
    case 3: return resources_p<3>(a, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

int kron_dw_eft_test(const float* ah, const float* al, const float* bh,
                     const float* bl, float* out, int n, void* stream) {
  eft_test_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      ah, al, bh, bl, out, n);
  return (int)cudaGetLastError();
}

const char* kron_apply_dw_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

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
// pairs for values: windows of x_h and x_l, u partials in shared memory, v
// partials and a ring of the last 2P+1 planes in registers.  It mirrors the
// plain version operation for operation: taps in order t = 0..2P, the first
// tap assigned and the others added with dw_add; one axis-0 contraction per
// distinct history (no sum before it); the terms added in order; then
// dw_add(b, -Ax).  Every add and multiply is an intrinsic that the compiler
// never contracts; two_prod is p = fl(a b), e = fma(a, b, -p), the pair the
// plain version rounds from the exact f64 product (the shared functions of
// dw_eft.cuh).  So the words equal the plain version's bit for bit (up to
// the sign of a zero).  With `negate`
// the pair leaves the kernel negated word by word, which is the negated
// normalised pair: A p itself for the b = 0 call of the PCG step.  Bands narrower than the compiled half-width
// are zero-padded: a zero tap adds (0, 0), which leaves a normalised pair
// unchanged.  A null x_l or b is a field of zeros: it is neither read nor
// allocated, the arithmetic on its zeros is still done.
//
// The number of distinct histories a launch holds is a template parameter
// (CW): an operator with up to 3 (Poisson: 3) runs the 3-history
// instantiation, whose registers (221 at P = 3) a fourth ring of 2P+1 pairs
// would push past the limit of 255; one with 4 (the periodic shifted 3D
// operator: sigma M M M, K M M, M K M, M M K) runs the 4-history one, which
// may spill and is slower, and is bit-equal all the same.
//
// Every half-width 1 to 8 is instantiated (spline degrees 1 to 8, no tap
// padded; ops/twofloat.py::COMPILED_P_DW).  Wide ones (P > kRegisterP: 6,
// 7, 8) take a second kernel, kron_march_dw_wide_kernel: the band rows of
// axes 1 and 2 and the axis-0 ring of each history live in shared memory
// (the ring a thread's own slots, so it needs no barrier), and only one
// window row of x sits in registers.  Its registers do not grow with P;
// the ring's shared memory does (2 CW (2P+1) words a thread), and the
// host's tiling keeps a block within the card's limit
// (ops/twofloat.py::k5_smem_bytes mirrors smem_bytes_wide).  It performs
// the same operations in the same order.
//
// K5r: bands wider than 8 (spline degrees above 8) run on the same body with
// the half-width a launch argument (kron_march_dw_rt_kernel, entry
// kron_residual_dw_rt): the shared memory is sized at launch, the taps are
// loops, and the window row is read from shared memory tap by tap.  The
// operations and their order are the wide kernel's, so its words too equal
// the plain version's.  Its smallest block (one row, one column, one plane)
// fits the card's shared memory up to P = 36 with 3 or 4 histories; wider
// bands are refused by the host (ops/kron.py::refuse_half_width).
//
// More terms than one launch holds (kCU u, kCV v, kCW histories, kCT terms):
// the host splits the terms, in order, into runs that fit, one launch each.
// Every launch but the last writes the double-word sum of its terms added
// onto the previous launch's (acc, read as the first summand), and the last
// one forms dw_add(b, -sum): the additions of the single pass in its order,
// so the words are the same.
//
// Redesigns that were measured and not kept for P <= 5 (129^3, p = 3,
// NVIDIA H100 80GB HBM3 at 700 W; ops/twofloat.py::k5_resources reads the
// registers): the band rows and the axis-0 ring in shared memory, two
// columns a thread, no branch on the plan, two blocks of 128 threads an SM
// (72-79 registers, no spill): 0.335-0.355 ms; the same with the ring back
// in registers, three blocks an SM (145 registers): 0.343 ms; against
// 0.327-0.332 ms for this design.  Clock counters in the first showed its
// arithmetic passes issuing about 2.3 f32 instructions a cycle per SM with 8
// warps, the rate this design's time implies too; runs of fewer planes (more
// blocks) lost more to the blocks' uneven spread over the SMs than they
// gained.

#include "dw_eft.cuh"
#include "kron_march.cuh"

namespace {

using namespace dwf;
using kron::Geometry;

constexpr int kCU = 2;  // u partials (distinct axis-2 bands)
constexpr int kCV = 3;  // v partials
constexpr int kCW = 4;  // distinct full histories, at most (CW = 3 or 4)
constexpr int kCT = 4;  // terms
constexpr int kMaxThreads = 256;
constexpr int kRegisterP = 5;  // the widest half-width of the register ring

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
  Geometry g;
  Plan p;
};

template <int P, int CW>
__host__ __device__ inline size_t smem_bytes(const Geometry& g) {
  const size_t WR = g.T1 + 2 * P, WC = g.T2 + 2 * P, W = 2 * P + 1;
  return WR * WC * sizeof(int64_t) +
         (2 * kron::kStages * WR * WC + 2 * kCU * WR * g.T2 +
          2 * CW * g.chunk * W) *
             sizeof(float);
}

// the terms in order, each its history's y, onto the earlier launches' sum
// (or the first term assigned); the last launch writes b - sum (negated on
// request), every other one the sum.  The choice is a branch around the add,
// so y is never indexed by a value (which would put it in local memory)
template <int CW>
__device__ __forceinline__ void emit(const Args& a, const dw (&y)[CW],
                                     int64_t idx) {
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
  const dw b = a.bh != nullptr ? dw{a.bh[idx], a.bl[idx]} : dw{0.0f, 0.0f};
  const dw r = dw_add(b, dw_neg(ax));
  a.rh[idx] = a.negate ? -r.h : r.h;
  a.rl[idx] = a.negate ? -r.l : r.l;
}

template <int P, int CW>
__global__ void __launch_bounds__(kMaxThreads)
kron_march_dw_kernel(const Args a) {
  constexpr int W = 2 * P + 1;
  const Geometry& g = a.g;
  const Plan& pl = a.p;
  const int T1 = g.T1, T2 = g.T2;
  const int WR = T1 + 2 * P, WC = T2 + 2 * P;
  const int NW = WR * WC;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  int64_t* soff = reinterpret_cast<int64_t*>(smem_raw);
  constexpr int S = kron::kStages;
  float* win_h = reinterpret_cast<float*>(soff + NW);  // S buffers
  float* win_l = win_h + S * NW;                       // S buffers
  float* u_h = win_l + S * NW;
  float* u_l = u_h + kCU * WR * T2;
  float* c0h = u_l + kCU * WR * T2;
  float* c0l = c0h + CW * g.chunk * W;

  const int tid = threadIdx.x;
  const int tj = tid / T2, tl = tid - tj * T2;
  const bool in_tile = tid < T1 * T2;
  const int j0 = blockIdx.y * T1, l0 = blockIdx.x * T2;
  const int gj = j0 + tj, gl = l0 + tl;
  const bool owns = in_tile && gj < g.n1 && gl < g.n2;
  const int i_begin = blockIdx.z * g.chunk;
  const int i_end = min(i_begin + g.chunk, g.n0);

  kron::build_window_offsets(soff, g, P, j0, l0);
  for (int e = tid; e < pl.nw * g.chunk * W; e += blockDim.x) {
    const int k = e / (g.chunk * W);
    const int rem = e - k * g.chunk * W;
    const int i = i_begin + rem / W;
    const int64_t src = ((int64_t)pl.w_lab[k] * g.n0 + i) * W + rem % W;
    c0h[e] = i < g.n0 ? a.band_h[0][src] : 0.0f;
    c0l[e] = i < g.n0 ? a.band_l[0][src] : 0.0f;
  }
  if (a.xl == nullptr)  // the low word is zero: fill once, never load
    for (int e = tid; e < S * NW; e += blockDim.x) win_l[e] = 0.0f;

  dw c2r[kCU][W], c1r[kCV][W];
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
#pragma unroll
  for (int k = 0; k < kCV; ++k)
#pragma unroll
    for (int t = 0; t < W; ++t) {
      const bool ok = k < pl.nv && owns;
      const int64_t src = ((int64_t)(ok ? pl.v_lab[k] : 0) * g.n1 +
                           (ok ? gj : 0)) * W + t;
      c1r[k][t] = ok ? dw{a.band_h[1][src], a.band_l[1][src]}
                     : dw{0.0f, 0.0f};
    }

  dw ring[CW][W];
#pragma unroll
  for (int k = 0; k < CW; ++k)
#pragma unroll
    for (int t = 0; t < W; ++t) ring[k][t] = dw{0.0f, 0.0f};

  __syncthreads();

  // plane q lands in buffer (q - q_begin) % S, its copy started S - 1 steps
  // ahead; one commit per step keeps the group count in step
  const int q_begin = i_begin - P, q_end = i_end + P;
  for (int q = q_begin; q < q_begin + S - 1; ++q) {
    const int gq = q < q_end ? kron::resolve(q, g.n0, g.per0) : -1;
    if (gq >= 0) {
      const int buf = (q - q_begin) % S;
      kron::load_window(win_h + buf * NW, a.xh, soff, NW, gq * g.s0);
      if (a.xl != nullptr)
        kron::load_window(win_l + buf * NW, a.xl, soff, NW, gq * g.s0);
    }
    kron::cp_async_commit();
  }
  for (int q = q_begin; q < q_end; ++q) {
    const int buf = (q - q_begin) % S;
    const int gq = kron::resolve(q, g.n0, g.per0);
    if (q + S - 1 < q_end) {
      const int gn = kron::resolve(q + S - 1, g.n0, g.per0);
      if (gn >= 0) {
        const int nb = (q + S - 1 - q_begin) % S;
        kron::load_window(win_h + nb * NW, a.xh, soff, NW, gn * g.s0);
        if (a.xl != nullptr)
          kron::load_window(win_l + nb * NW, a.xl, soff, NW, gn * g.s0);
      }
    }
    kron::cp_async_commit();
    kron::cp_async_wait<S - 1>();
    __syncthreads();

    dw v[kCV];
#pragma unroll
    for (int k = 0; k < kCV; ++k) v[k] = dw{0.0f, 0.0f};

    if (gq >= 0) {  // a zero ghost plane enters the ring as zeros
      const float* wh = win_h + buf * NW;
      const float* wl = win_l + buf * NW;
      if (in_tile) {
        for (int rr = tj; rr < WR; rr += T1) {
          dw xv[W];
#pragma unroll
          for (int t = 0; t < W; ++t)
            xv[t] = dw{wh[rr * WC + tl + t], wl[rr * WC + tl + t]};
#pragma unroll
          for (int k = 0; k < kCU; ++k) {
            if (k < pl.nu) {
              dw s = dw_mul(c2r[k][0], xv[0]);
#pragma unroll
              for (int t = 1; t < W; ++t)
                s = dw_add(s, dw_mul(c2r[k][t], xv[t]));
              u_h[(k * WR + rr) * T2 + tl] = s.h;
              u_l[(k * WR + rr) * T2 + tl] = s.l;
            }
          }
        }
      }
      __syncthreads();
      if (in_tile) {
#pragma unroll
        for (int k = 0; k < kCV; ++k) {
          if (k < pl.nv) {
            const int base = (pl.v_src[k] * WR + tj) * T2 + tl;
            dw s = dw_mul(c1r[k][0], dw{u_h[base], u_l[base]});
#pragma unroll
            for (int t = 1; t < W; ++t)
              s = dw_add(s, dw_mul(c1r[k][t], dw{u_h[base + t * T2],
                                                  u_l[base + t * T2]}));
            v[k] = s;
          }
        }
      }
    }
    // ring[k] holds the planes q - 2P .. q of the v that history k contracts
#pragma unroll
    for (int k = 0; k < CW; ++k) {
      dw in = dw{0.0f, 0.0f};
#pragma unroll
      for (int kk = 0; kk < kCV; ++kk)
        if (k < pl.nw && pl.w_src[k] == kk) in = v[kk];
#pragma unroll
      for (int t = 0; t + 1 < W; ++t) ring[k][t] = ring[k][t + 1];
      ring[k][W - 1] = in;
    }

    const int i = q - P;
    if (i >= i_begin && owns) {
      dw y[CW];
#pragma unroll
      for (int k = 0; k < CW; ++k) {
        y[k] = dw{0.0f, 0.0f};
        if (k < pl.nw) {
          const int base = (k * g.chunk + (i - i_begin)) * W;
          dw s = dw_mul(dw{c0h[base], c0l[base]}, ring[k][0]);
#pragma unroll
          for (int t = 1; t < W; ++t)
            s = dw_add(s, dw_mul(dw{c0h[base + t], c0l[base + t]},
                                 ring[k][t]));
          y[k] = s;
        }
      }
      emit(a, y, ((int64_t)i * g.n1 + gj) * g.n2 + gl);
    }
  }
  kron::cp_async_wait<0>();
}

// shared memory of the wide kernel: the offset table, the windows, the u
// partials, the axis-0 band rows of the run, the axis-2 and axis-1 band rows
// of the tile, and each thread's ring of W planes per history, hi and lo
__host__ __device__ inline size_t smem_bytes_wide(const Geometry& g, int P,
                                                  int CW) {
  const size_t WR = g.T1 + 2 * P, WC = g.T2 + 2 * P, W = 2 * P + 1;
  return WR * WC * sizeof(int64_t) +
         2 * (kron::kStages * WR * WC + kCU * WR * g.T2 + CW * g.chunk * W +
              kCU * W * g.T2 + kCV * W * g.T1 + CW * W * g.T1 * g.T2) *
             sizeof(float);
}

// The same contractions as kron_march_dw_kernel, for half-widths whose
// register ring would spill: band rows and ring in shared memory (see the
// note at the top).  Thread (tj, tl) of the tile reads column tl of the
// axis-2 rows (k, t, column: neighbouring threads, neighbouring words), row
// tj of the axis-1 rows (a broadcast) and its own ring slots (k, slot,
// thread).  PC: the compiled half-width, or 0 for K5r, whose half-width is
// P_rt (the loops over taps then run, not unrolled, and the window row is
// read from shared memory where the compiled kernel holds it in registers).
template <int PC, int CW>
__device__ __forceinline__ void march_wide(const Args& a, const int P_rt) {
  const int P = PC > 0 ? PC : P_rt;
  const int W = 2 * P + 1;
  constexpr int S = kron::kStages;
  const Geometry& g = a.g;
  const Plan& pl = a.p;
  const int T1 = g.T1, T2 = g.T2, NT = T1 * T2;
  const int WR = T1 + 2 * P, WC = T2 + 2 * P;
  const int NW = WR * WC;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  int64_t* soff = reinterpret_cast<int64_t*>(smem_raw);
  float* win_h = reinterpret_cast<float*>(soff + NW);  // S buffers
  float* win_l = win_h + S * NW;                       // S buffers
  float* u_h = win_l + S * NW;
  float* u_l = u_h + kCU * WR * T2;
  float* c0h = u_l + kCU * WR * T2;
  float* c0l = c0h + CW * g.chunk * W;
  float* c2h = c0l + CW * g.chunk * W;
  float* c2l = c2h + kCU * W * T2;
  float* c1h = c2l + kCU * W * T2;
  float* c1l = c1h + kCV * W * T1;
  float* rg_h = c1l + kCV * W * T1;
  float* rg_l = rg_h + CW * W * NT;

  const int tid = threadIdx.x;
  const int tj = tid / T2, tl = tid - tj * T2;
  const bool in_tile = tid < NT;
  const int j0 = blockIdx.y * T1, l0 = blockIdx.x * T2;
  const int gj = j0 + tj, gl = l0 + tl;
  const bool owns = in_tile && gj < g.n1 && gl < g.n2;
  const int i_begin = blockIdx.z * g.chunk;
  const int i_end = min(i_begin + g.chunk, g.n0);

  kron::build_window_offsets(soff, g, P, j0, l0);
  for (int e = tid; e < pl.nw * g.chunk * W; e += blockDim.x) {
    const int k = e / (g.chunk * W);
    const int rem = e - k * g.chunk * W;
    const int i = i_begin + rem / W;
    const int64_t src = ((int64_t)pl.w_lab[k] * g.n0 + i) * W + rem % W;
    c0h[e] = i < g.n0 ? a.band_h[0][src] : 0.0f;
    c0l[e] = i < g.n0 ? a.band_l[0][src] : 0.0f;
  }
  // band rows: zero for absent partials and outside the grid
  for (int e = tid; e < kCU * W * T2; e += blockDim.x) {
    const int k = e / (W * T2), t = e / T2 - k * W, c = e - (e / T2) * T2;
    const bool ok = k < pl.nu && l0 + c < g.n2;
    const int64_t src =
        ((int64_t)(ok ? pl.u_lab[k] : 0) * g.n2 + (ok ? l0 + c : 0)) * W + t;
    c2h[e] = ok ? a.band_h[2][src] : 0.0f;
    c2l[e] = ok ? a.band_l[2][src] : 0.0f;
  }
  for (int e = tid; e < kCV * W * T1; e += blockDim.x) {
    const int k = e / (W * T1), t = e / T1 - k * W, r = e - (e / T1) * T1;
    const bool ok = k < pl.nv && j0 + r < g.n1;
    const int64_t src =
        ((int64_t)(ok ? pl.v_lab[k] : 0) * g.n1 + (ok ? j0 + r : 0)) * W + t;
    c1h[e] = ok ? a.band_h[1][src] : 0.0f;
    c1l[e] = ok ? a.band_l[1][src] : 0.0f;
  }
  if (a.xl == nullptr)  // the low word is zero: fill once, never load
    for (int e = tid; e < S * NW; e += blockDim.x) win_l[e] = 0.0f;

  __syncthreads();

  const int q_begin = i_begin - P, q_end = i_end + P;
  for (int q = q_begin; q < q_begin + S - 1; ++q) {
    const int gq = q < q_end ? kron::resolve(q, g.n0, g.per0) : -1;
    if (gq >= 0) {
      const int buf = (q - q_begin) % S;
      kron::load_window(win_h + buf * NW, a.xh, soff, NW, gq * g.s0);
      if (a.xl != nullptr)
        kron::load_window(win_l + buf * NW, a.xl, soff, NW, gq * g.s0);
    }
    kron::cp_async_commit();
  }
  int slot = 0;  // the ring slot of plane q: (q - q_begin) % W
  for (int q = q_begin; q < q_end; ++q) {
    const int buf = (q - q_begin) % S;
    const int gq = kron::resolve(q, g.n0, g.per0);
    if (q + S - 1 < q_end) {
      const int gn = kron::resolve(q + S - 1, g.n0, g.per0);
      if (gn >= 0) {
        const int nb = (q + S - 1 - q_begin) % S;
        kron::load_window(win_h + nb * NW, a.xh, soff, NW, gn * g.s0);
        if (a.xl != nullptr)
          kron::load_window(win_l + nb * NW, a.xl, soff, NW, gn * g.s0);
      }
    }
    kron::cp_async_commit();
    kron::cp_async_wait<S - 1>();
    __syncthreads();

    dw v[kCV];
#pragma unroll
    for (int k = 0; k < kCV; ++k) v[k] = dw{0.0f, 0.0f};

    if (gq >= 0) {  // a zero ghost plane enters the ring as zeros
      const float* wh = win_h + buf * NW;
      const float* wl = win_l + buf * NW;
      if (in_tile) {
        for (int rr = tj; rr < WR; rr += T1) {
          // tap t's window value: from registers (compiled P) or from
          // shared memory (K5r)
          dw xv[PC > 0 ? 2 * PC + 1 : 1];
          if constexpr (PC > 0) {
#pragma unroll
            for (int t = 0; t < W; ++t)
              xv[t] = dw{wh[rr * WC + tl + t], wl[rr * WC + tl + t]};
          }
          const auto x_at = [&](int t) -> dw {
            if constexpr (PC > 0)
              return xv[t];
            else
              return dw{wh[rr * WC + tl + t], wl[rr * WC + tl + t]};
          };
#pragma unroll
          for (int k = 0; k < kCU; ++k) {
            if (k < pl.nu) {
              const int cb = k * W * T2 + tl;
              dw s = dw_mul(dw{c2h[cb], c2l[cb]}, x_at(0));
#pragma unroll
              for (int t = 1; t < W; ++t)
                s = dw_add(s, dw_mul(dw{c2h[cb + t * T2], c2l[cb + t * T2]},
                                     x_at(t)));
              u_h[(k * WR + rr) * T2 + tl] = s.h;
              u_l[(k * WR + rr) * T2 + tl] = s.l;
            }
          }
        }
      }
      __syncthreads();
      if (in_tile) {
#pragma unroll
        for (int k = 0; k < kCV; ++k) {
          if (k < pl.nv) {
            const int base = (pl.v_src[k] * WR + tj) * T2 + tl;
            const int cb = k * W * T1 + tj;
            dw s = dw_mul(dw{c1h[cb], c1l[cb]}, dw{u_h[base], u_l[base]});
#pragma unroll
            for (int t = 1; t < W; ++t)
              s = dw_add(s, dw_mul(dw{c1h[cb + t * T1], c1l[cb + t * T1]},
                                   dw{u_h[base + t * T2],
                                      u_l[base + t * T2]}));
            v[k] = s;
          }
        }
      }
    }
    // slot `slot` of history k's ring takes plane q of the v it contracts;
    // the ring holds the planes q - 2P .. q, the oldest at slot + 1
    if (owns) {
#pragma unroll
      for (int k = 0; k < CW; ++k) {
        if (k < pl.nw) {
          dw in = dw{0.0f, 0.0f};
#pragma unroll
          for (int kk = 0; kk < kCV; ++kk)
            if (pl.w_src[k] == kk) in = v[kk];
          rg_h[(k * W + slot) * NT + tid] = in.h;
          rg_l[(k * W + slot) * NT + tid] = in.l;
        }
      }
    }
    slot = slot + 1 == W ? 0 : slot + 1;  // now the oldest plane's slot

    const int i = q - P;
    if (i >= i_begin && owns) {
      dw y[CW];
#pragma unroll
      for (int k = 0; k < CW; ++k) {
        y[k] = dw{0.0f, 0.0f};
        if (k < pl.nw) {
          const int base = (k * g.chunk + (i - i_begin)) * W;
          const float* rh = rg_h + k * W * NT + tid;
          const float* rl = rg_l + k * W * NT + tid;
          int sl = slot;
          dw s = dw_mul(dw{c0h[base], c0l[base]}, dw{rh[sl * NT], rl[sl * NT]});
#pragma unroll
          for (int t = 1; t < W; ++t) {
            sl = sl + 1 == W ? 0 : sl + 1;
            s = dw_add(s, dw_mul(dw{c0h[base + t], c0l[base + t]},
                                 dw{rh[sl * NT], rl[sl * NT]}));
          }
          y[k] = s;
        }
      }
      emit(a, y, ((int64_t)i * g.n1 + gj) * g.n2 + gl);
    }
  }
  kron::cp_async_wait<0>();
}

template <int P, int CW>
__global__ void __launch_bounds__(kMaxThreads)
kron_march_dw_wide_kernel(const Args a) {
  march_wide<P, CW>(a, P);
}

// K5r: the half-width P a launch argument
template <int CW>
__global__ void __launch_bounds__(kMaxThreads)
kron_march_dw_rt_kernel(const Args a, const int P) {
  march_wide<0, CW>(a, P);
}

// the kernel and the shared memory of half-width P with CW histories
template <int P, int CW>
inline auto kernel_of() {
  if constexpr (P > kRegisterP)
    return kron_march_dw_wide_kernel<P, CW>;
  else
    return kron_march_dw_kernel<P, CW>;
}

template <int P, int CW>
size_t smem_of(const Geometry& g) {
  if constexpr (P > kRegisterP)
    return smem_bytes_wide(g, P, CW);
  else
    return smem_bytes<P, CW>(g);
}

template <int P, int CW>
int launch_pw(const Args& a, cudaStream_t stream) {
  const Geometry& g = a.g;
  if (g.threads > kMaxThreads || g.threads < g.T1 * g.T2 ||
      g.threads % 32 != 0)
    return (int)cudaErrorInvalidConfiguration;
  const size_t bytes = smem_of<P, CW>(g);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel_of<P, CW>(), cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear it, or the next launch reports it
      return (int)err;
    }
  }
  const dim3 grid((g.n2 + g.T2 - 1) / g.T2, (g.n1 + g.T1 - 1) / g.T1,
                  (g.n0 + g.chunk - 1) / g.chunk);
  if constexpr (P > kRegisterP)
    kron_march_dw_wide_kernel<P, CW><<<grid, g.threads, bytes, stream>>>(a);
  else
    kron_march_dw_kernel<P, CW><<<grid, g.threads, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int P>
int launch_p(const Args& a, cudaStream_t stream) {
  return a.p.nw <= 3 ? launch_pw<P, 3>(a, stream) : launch_pw<P, 4>(a, stream);
}

// K5r: the shared memory of the half-width P, sized at launch
template <int CW>
int launch_rt_w(const Args& a, int P, cudaStream_t stream) {
  const Geometry& g = a.g;
  if (P < 1 || g.threads > kMaxThreads || g.threads < g.T1 * g.T2 ||
      g.threads % 32 != 0)
    return (int)cudaErrorInvalidConfiguration;
  const size_t bytes = smem_bytes_wide(g, P, CW);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kron_march_dw_rt_kernel<CW>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear it, or the next launch reports it
      return (int)err;
    }
  }
  const dim3 grid((g.n2 + g.T2 - 1) / g.T2, (g.n1 + g.T1 - 1) / g.T1,
                  (g.n0 + g.chunk - 1) / g.chunk);
  kron_march_dw_rt_kernel<CW><<<grid, g.threads, bytes, stream>>>(a, P);
  return (int)cudaGetLastError();
}

int launch_rt(const Args& a, int P, cudaStream_t stream) {
  return a.p.nw <= 3 ? launch_rt_w<3>(a, P, stream)
                     : launch_rt_w<4>(a, P, stream);
}

template <int P>
int resources_p(const Args& a, int* out) {
  const Geometry& g = a.g;
  return a.p.nw <= 3 ? kron::resources_of(kernel_of<P, 3>(), g.threads,
                                          smem_of<P, 3>(g), out)
                     : kron::resources_of(kernel_of<P, 4>(), g.threads,
                                          smem_of<P, 4>(g), out);
}

int resources_rt(const Args& a, int P, int* out) {
  const Geometry& g = a.g;
  return a.p.nw <= 3
             ? kron::resources_of(kron_march_dw_rt_kernel<3>, g.threads,
                                  smem_bytes_wide(g, P, 3), out)
             : kron::resources_of(kron_march_dw_rt_kernel<4>, g.threads,
                                  smem_bytes_wide(g, P, 4), out);
}

// geo: n0 n1 n2 per0 per1 per2 P T1 T2 chunk threads R
// plan: nu nv nw nt u_lab[kCU] v_src[kCV] v_lab[kCV] w_src[kCW] w_lab[kCW]
//       term_w[kCT]
bool parse(const int* geo, const int* plan, Args& a, int& P) {
  Geometry& g = a.g;
  g.n0 = geo[0], g.n1 = geo[1], g.n2 = geo[2];
  g.per0 = geo[3], g.per1 = geo[4], g.per2 = geo[5];
  P = geo[6];
  g.T1 = geo[7], g.T2 = geo[8], g.chunk = geo[9], g.threads = geo[10];
  g.R = geo[11];
  g.s0 = (int64_t)g.n1 * g.n2, g.s1 = g.n2, g.s2 = 1;  // contiguous fields
  Plan& p = a.p;
  const int* q = plan;
  p.nu = *q++, p.nv = *q++, p.nw = *q++, p.nt = *q++;
  for (int k = 0; k < kCU; ++k) p.u_lab[k] = *q++;
  for (int k = 0; k < kCV; ++k) p.v_src[k] = *q++;
  for (int k = 0; k < kCV; ++k) p.v_lab[k] = *q++;
  for (int k = 0; k < kCW; ++k) p.w_src[k] = *q++;
  for (int k = 0; k < kCW; ++k) p.w_lab[k] = *q++;
  for (int k = 0; k < kCT; ++k) p.term_w[k] = *q++;
  return !(p.nu < 1 || p.nu > kCU || p.nv < 1 || p.nv > kCV || p.nw < 1 ||
           p.nw > kCW || p.nt < 1 || p.nt > kCT || g.T1 < 1 || g.T2 < 1 ||
           g.chunk < 1);
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
  switch (P) {  // the instantiated half-widths
    case 1: return launch_p<1>(a, st);
    case 2: return launch_p<2>(a, st);
    case 3: return launch_p<3>(a, st);
    case 4: return launch_p<4>(a, st);
    case 5: return launch_p<5>(a, st);
    case 6: return launch_p<6>(a, st);
    case 7: return launch_p<7>(a, st);
    case 8: return launch_p<8>(a, st);
    default: return (int)cudaErrorInvalidValue;  // no such kernel: K5r's
  }
}

// K5r, the half-width geo[6] taken at run time: the same arguments
int kron_residual_dw_rt(const float* xh, const float* xl, const float* bh,
                        const float* bl, const float* acc_h,
                        const float* acc_l, const float* b0h,
                        const float* b0l, const float* b1h, const float* b1l,
                        const float* b2h, const float* b2l, float* rh,
                        float* rl, const int* geo, const int* plan,
                        int negate, int last, void* stream) {
  Args a;
  int P;
  if (!pack(xh, xl, bh, bl, acc_h, acc_l, b0h, b0l, b1h, b1l, b2h, b2l, rh,
            rl, geo, plan, negate, last, a, P))
    return (int)cudaErrorInvalidValue;
  return launch_rt(a, P, (cudaStream_t)stream);
}

// out: registers a thread, local memory a thread in bytes (spills), shared
// memory a block in bytes, blocks an SM holds, for the launch of geo and plan
// (runtime: K5r's)
int kron_residual_dw_resources(const int* geo, const int* plan, int* out,
                               int runtime) {
  Args a;
  int P;
  if (!parse(geo, plan, a, P)) return (int)cudaErrorInvalidValue;
  if (runtime) return resources_rt(a, P, out);
  switch (P) {
    case 1: return resources_p<1>(a, out);
    case 2: return resources_p<2>(a, out);
    case 3: return resources_p<3>(a, out);
    case 4: return resources_p<4>(a, out);
    case 5: return resources_p<5>(a, out);
    case 6: return resources_p<6>(a, out);
    case 7: return resources_p<7>(a, out);
    case 8: return resources_p<8>(a, out);
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

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
// never contracts; two_prod is p = fl(a b), e = fma(a, b, -p), which gives
// the same pair as the plain version's 12|12-bit split form wherever
// nothing underflows (the shared functions of dw_eft.cuh).  So the words equal
// the plain version's bit for bit (up to the sign of a zero).  With `negate`
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
  const float* band_h[3];  // per axis (labels, n_a, 2P+1)
  const float* band_l[3];
  float* rh;
  float* rl;
  int negate;  // write -(b - A x): A x itself when b = 0
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
      dw ax = dw{0.0f, 0.0f};
#pragma unroll
      for (int r = 0; r < kCT; ++r) {
        if (r < pl.nt) {
          dw term = y[0];
#pragma unroll
          for (int k = 1; k < CW; ++k)
            if (pl.term_w[r] == k) term = y[k];
          ax = r == 0 ? term : dw_add(ax, term);
        }
      }
      const int64_t idx = ((int64_t)i * g.n1 + gj) * g.n2 + gl;
      const dw b = a.bh != nullptr ? dw{a.bh[idx], a.bl[idx]}
                                   : dw{0.0f, 0.0f};
      const dw r = dw_add(b, dw_neg(ax));
      a.rh[idx] = a.negate ? -r.h : r.h;
      a.rl[idx] = a.negate ? -r.l : r.l;
    }
  }
  kron::cp_async_wait<0>();
}

template <int P, int CW>
int launch_pw(const Args& a, cudaStream_t stream) {
  const Geometry& g = a.g;
  if (g.threads > kMaxThreads || g.threads < g.T1 * g.T2 ||
      g.threads % 32 != 0)
    return (int)cudaErrorInvalidConfiguration;
  const size_t bytes = smem_bytes<P, CW>(g);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kron_march_dw_kernel<P, CW>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear it, or the next launch reports it
      return (int)err;
    }
  }
  const dim3 grid((g.n2 + g.T2 - 1) / g.T2, (g.n1 + g.T1 - 1) / g.T1,
                  (g.n0 + g.chunk - 1) / g.chunk);
  kron_march_dw_kernel<P, CW><<<grid, g.threads, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int P>
int launch_p(const Args& a, cudaStream_t stream) {
  return a.p.nw <= 3 ? launch_pw<P, 3>(a, stream) : launch_pw<P, 4>(a, stream);
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

// geo: n0 n1 n2 per0 per1 per2 P T1 T2 chunk threads R
// plan: nu nv nw nt u_lab[kCU] v_src[kCV] v_lab[kCV] w_src[kCW] w_lab[kCW]
//       term_w[kCT]
int kron_residual_dw(const float* xh, const float* xl, const float* bh,
                     const float* bl, const float* b0h, const float* b0l,
                     const float* b1h, const float* b1l, const float* b2h,
                     const float* b2l, float* rh, float* rl, const int* geo,
                     const int* plan, int negate, void* stream) {
  Args a;
  a.xh = xh, a.xl = xl, a.bh = bh, a.bl = bl;
  a.band_h[0] = b0h, a.band_h[1] = b1h, a.band_h[2] = b2h;
  a.band_l[0] = b0l, a.band_l[1] = b1l, a.band_l[2] = b2l;
  a.rh = rh, a.rl = rl, a.negate = negate;
  Geometry& g = a.g;
  g.n0 = geo[0], g.n1 = geo[1], g.n2 = geo[2];
  g.per0 = geo[3], g.per1 = geo[4], g.per2 = geo[5];
  const int P = geo[6];
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
  if (p.nu < 1 || p.nu > kCU || p.nv < 1 || p.nv > kCV || p.nw < 1 ||
      p.nw > kCW || p.nt < 1 || p.nt > kCT || g.T1 < 1 || g.T2 < 1 ||
      g.chunk < 1 || (bh == nullptr) != (bl == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (P) {  // the instantiated half-widths
    case 1: return launch_p<1>(a, st);
    case 2: return launch_p<2>(a, st);
    case 3: return launch_p<3>(a, st);
    case 5: return launch_p<5>(a, st);
    default: return (int)cudaErrorInvalidValue;  // refused: no such kernel
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

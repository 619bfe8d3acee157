// K6u: the elementwise recurrences of the double-word solvers, one pass each,
// their scalars read from device memory (0-dim f64 tensors), so a step never
// waits for the host:
//
//   cg        alpha = rz / pAp, (a_h, a_l) = split(alpha);
//             x += alpha p,  dr = -alpha Ap,  r += dr       (double-word)
//   direction p = z + f32(s / rz) p                          (f32)
//   defect    x += two_prod(e, f32(safe(rn)))                (double-word)
//   dwrr      x += alpha p (double-word); with Ap given also
//             dr = -f32(alpha) Ap,  rf += dr                 (f32)
//   div, mul  y = x / f32(safe(s)),  y = x f32(safe(s))      (f32)
//
// with safe(s) = s > 0 ? s : 1.  Replaces the elementwise lines of
// poms_tpu/mg/mixed.py::step_dw (:507-528), step_tf (:193-200), step_dwrr
// (:540-555) and precond_dw (:500-505); no Pallas original: XLA fuses each
// group into one loop there, eager PyTorch runs some 40 kernels for `cg`.
//
// What bounds it on an H100: the bytes.  `cg` reads 7 f32 fields and writes
// 6 (112 MB at 129^3: 33 us at 3.35 TB/s) and does about 70 unfused f32
// operations a point; the other modes move 2 to 4 fields.
//
// Design: one thread a point in a grid-stride loop, every add and multiply an
// intrinsic that the compiler may not contract (dw_eft.cuh), the operations
// in the plain version's order, so the words are the plain version's bit for
// bit (up to the sign of a zero).  Outputs may alias inputs.

#include "dw_eft.cuh"

namespace {

using namespace dwf;

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;

enum Mode { kCg = 0, kDirection, kDefect, kDwrr, kDiv, kMul, kModes };

struct Args {
  const float* in[7];
  const double* s0;
  const double* s1;
  float* out[6];
  long long n;
};

__device__ __forceinline__ float safe32(const double* s) {
  const double v = *s;
  return __double2float_rn(v > 0.0 ? v : 1.0);
}

template <int M>
__global__ void __launch_bounds__(kThreads) dw_update_kernel(const Args a) {
  const long long stride = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (M == kCg) {
    // in: xh xl rh rl p aph apl; s0 = rz, s1 = pAp; out: xh xl rh rl drh drl
    const dw al = split_f64(__ddiv_rn(*a.s0, *a.s1));
    for (long long i = first; i < a.n; i += stride) {
      const dw dx = dw_mul(al, dw{a.in[4][i], 0.0f});
      const dw x = dw_add(dw{a.in[0][i], a.in[1][i]}, dx);
      const dw dr = dw_mul(dw_neg(al), dw{a.in[5][i], a.in[6][i]});
      const dw r = dw_add(dw{a.in[2][i], a.in[3][i]}, dr);
      a.out[0][i] = x.h, a.out[1][i] = x.l;
      a.out[2][i] = r.h, a.out[3][i] = r.l;
      a.out[4][i] = dr.h, a.out[5][i] = dr.l;
    }
  } else if (M == kDirection) {
    // in: z p; s0 = s, s1 = rz; out: p
    const float beta = __double2float_rn(__ddiv_rn(*a.s0, *a.s1));
    for (long long i = first; i < a.n; i += stride)
      a.out[0][i] = add(a.in[0][i], mul(beta, a.in[1][i]));
  } else if (M == kDefect) {
    // in: xh xl e; s0 = rn; out: xh xl
    const float safe = safe32(a.s0);
    for (long long i = first; i < a.n; i += stride) {
      const dw x = dw_add(dw{a.in[0][i], a.in[1][i]},
                          two_prod(a.in[2][i], safe));
      a.out[0][i] = x.h, a.out[1][i] = x.l;
    }
  } else if (M == kDwrr) {
    // in: xh xl p [ap rf]; s0 = rz, s1 = pAp; out: xh xl [dr rf]
    const dw al = split_f64(__ddiv_rn(*a.s0, *a.s1));
    for (long long i = first; i < a.n; i += stride) {
      const dw dx = dw_mul(al, dw{a.in[2][i], 0.0f});
      const dw x = dw_add(dw{a.in[0][i], a.in[1][i]}, dx);
      a.out[0][i] = x.h, a.out[1][i] = x.l;
      if (a.in[3] != nullptr) {
        const float dr = mul(-al.h, a.in[3][i]);
        a.out[2][i] = dr;
        a.out[3][i] = add(a.in[4][i], dr);
      }
    }
  } else {
    // in: x; s0 = s; out: y
    const float safe = safe32(a.s0);
    for (long long i = first; i < a.n; i += stride)
      a.out[0][i] = M == kDiv ? __fdiv_rn(a.in[0][i], safe)
                              : mul(a.in[0][i], safe);
  }
}

template <int M>
int launch(const Args& a, cudaStream_t st) {
  long long blocks = (a.n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  dw_update_kernel<M><<<(int)blocks, kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// in: 7 pointers, out: 6 pointers (unused ones null), in the order each mode
// lists above; s0, s1: the mode's device scalars.
int dw_update(int mode, const void* const* in, const double* s0,
              const double* s1, void* const* out, long long n, void* stream) {
  // operands each mode reads and writes, and whether it reads s1
  static const int n_in[kModes] = {7, 2, 3, 3, 1, 1};
  static const int n_out[kModes] = {6, 1, 2, 2, 1, 1};
  static const bool two[kModes] = {true, true, false, true, false, false};
  if (mode < 0 || mode >= kModes || n < 1 || s0 == nullptr ||
      (two[mode] && s1 == nullptr))
    return (int)cudaErrorInvalidValue;
  Args a;
  for (int j = 0; j < 7; ++j) a.in[j] = (const float*)in[j];
  for (int j = 0; j < 6; ++j) a.out[j] = (float*)out[j];
  for (int j = 0; j < n_in[mode]; ++j)
    if (a.in[j] == nullptr) return (int)cudaErrorInvalidValue;
  for (int j = 0; j < n_out[mode]; ++j)
    if (a.out[j] == nullptr) return (int)cudaErrorInvalidValue;
  if (mode == kDwrr && a.in[3] != nullptr &&
      (a.in[4] == nullptr || a.out[2] == nullptr || a.out[3] == nullptr))
    return (int)cudaErrorInvalidValue;
  a.s0 = s0, a.s1 = s1, a.n = n;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (mode) {
    case kCg: return launch<kCg>(a, st);
    case kDirection: return launch<kDirection>(a, st);
    case kDefect: return launch<kDefect>(a, st);
    case kDwrr: return launch<kDwrr>(a, st);
    case kDiv: return launch<kDiv>(a, st);
    default: return launch<kMul>(a, st);
  }
}

const char* dw_update_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

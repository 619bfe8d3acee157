// K6r: up to four double-word dot products in one pass over their fields,
//   out[d] = sum_i (xh_d[i], xl_d[i]) * (yh_d[i], yl_d[i])   (d < k),
// each as one f64 value on the device; with sqrt_out the square root of it
// (the 2-norm is the k = 1 case with y = x).  A null low word is a field of
// zeros and is not read; a null y makes the term x itself (a plain
// double-word sum).
//
// Replaces poms_tpu/ops/twofloat.py::dw_dot_stack, dw_dot, dw_norm2 and
// dw_sum_tree (no Pallas original: XLA fuses the products and the pairwise
// tree there; in eager PyTorch the tree of a 129^3 field is ~21 levels of a
// 14-operation double-word add, some 430 launches for each dot or norm).
//
// What bounds it on an H100: the bytes.  A dot reads 2 to 4 f32 fields once
// (a norm of 129^3 points 17 MB: 5.1 us at 3.35 TB/s) and does about 30
// unfused f32 operations a point and product (0.13 G for the pair of dots of
// a PCG step: 4 us at half the f32 rate), so one pass that reads every field
// once is what there is to gain.
//
// Design: each thread forms the double-word product of its points and adds
// it to a double-word accumulator per dot (grid-stride loop, at most
// kMaxBlocks blocks of kThreads), a shared-memory tree adds the threads of a
// block, the block writes its partial pair, and a second launch of one block
// adds the partials and converts.  Every addition is the double-word add of
// dw_eft.cuh, and the order of additions depends on n alone: no atomics, so
// two runs give the same bits.  The order is not the plain version's
// first-half-plus-second-half tree, so the two agree to the accuracy of
// double-word addition (about 1e-14 of sum |terms|), not bitwise.

#include "dw_eft.cuh"

namespace {

using namespace dwf;

constexpr int kMaxDots = 4;
constexpr int kThreads = 256;
constexpr int kMaxBlocks = 1024;
constexpr int kPerThread = 8;  // points a thread takes before a block is added

struct Args {
  const float* xh[kMaxDots];
  const float* xl[kMaxDots];  // null: zeros
  const float* yh[kMaxDots];  // null: the term is x
  const float* yl[kMaxDots];  // null: zeros
  int k;
  long long n;
  float* part;  // (k, blocks, 2)
};

// the sum over the block's threads, valid in thread 0
__device__ __forceinline__ dw block_sum(dw v, dw* sm) {
  sm[threadIdx.x] = v;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s)
      sm[threadIdx.x] = dw_add(sm[threadIdx.x], sm[threadIdx.x + s]);
    __syncthreads();
  }
  const dw r = sm[0];
  __syncthreads();
  return r;
}

__global__ void __launch_bounds__(kThreads) dw_partial_kernel(const Args a) {
  __shared__ dw sm[kThreads];
  dw acc[kMaxDots];
#pragma unroll
  for (int d = 0; d < kMaxDots; ++d) acc[d] = dw{0.0f, 0.0f};
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < a.n;
       i += stride) {
#pragma unroll
    for (int d = 0; d < kMaxDots; ++d) {
      if (d < a.k) {
        const dw x{a.xh[d][i], a.xl[d] != nullptr ? a.xl[d][i] : 0.0f};
        dw term = x;
        if (a.yh[d] != nullptr) {
          const dw y{a.yh[d][i], a.yl[d] != nullptr ? a.yl[d][i] : 0.0f};
          term = dw_mul(x, y);
        }
        acc[d] = dw_add(acc[d], term);
      }
    }
  }
#pragma unroll
  for (int d = 0; d < kMaxDots; ++d) {
    if (d < a.k) {
      const dw s = block_sum(acc[d], sm);
      if (threadIdx.x == 0) {
        float* out = a.part + 2 * ((long long)d * gridDim.x + blockIdx.x);
        out[0] = s.h;
        out[1] = s.l;
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
dw_final_kernel(const float* part, int blocks, int k, double* out,
                int sqrt_out) {
  __shared__ dw sm[kThreads];
  for (int d = 0; d < k; ++d) {
    dw acc{0.0f, 0.0f};
    for (int b = threadIdx.x; b < blocks; b += kThreads) {
      const float* p = part + 2 * ((long long)d * blocks + b);
      acc = dw_add(acc, dw{p[0], p[1]});
    }
    const dw s = block_sum(acc, sm);
    if (threadIdx.x == 0) {
      const double v = merge_f64(s);
      out[d] = sqrt_out ? sqrt(v) : v;
    }
  }
}

}  // namespace

extern "C" {

// ptrs: 4 k pointers, (xh, xl, yh, yl) of each dot.  part: scratch of
// 2 k kMaxBlocks floats.  out: k doubles.
int dw_reduce(const void* const* ptrs, int k, long long n, float* part,
              double* out, int sqrt_out, void* stream) {
  if (k < 1 || k > kMaxDots || n < 1 || part == nullptr || out == nullptr)
    return (int)cudaErrorInvalidValue;
  Args a;
  for (int d = 0; d < kMaxDots; ++d) {
    const bool on = d < k;
    a.xh[d] = on ? (const float*)ptrs[4 * d] : nullptr;
    a.xl[d] = on ? (const float*)ptrs[4 * d + 1] : nullptr;
    a.yh[d] = on ? (const float*)ptrs[4 * d + 2] : nullptr;
    a.yl[d] = on ? (const float*)ptrs[4 * d + 3] : nullptr;
    if (on && a.xh[d] == nullptr) return (int)cudaErrorInvalidValue;
  }
  a.k = k, a.n = n, a.part = part;
  const long long per_block = (long long)kThreads * kPerThread;
  long long blocks = (n + per_block - 1) / per_block;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const cudaStream_t st = (cudaStream_t)stream;
  dw_partial_kernel<<<(int)blocks, kThreads, 0, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dw_final_kernel<<<1, kThreads, 0, st>>>(part, (int)blocks, k, out,
                                           sqrt_out);
  return (int)cudaGetLastError();
}

int dw_reduce_max_blocks() { return kMaxBlocks; }

const char* dw_reduce_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

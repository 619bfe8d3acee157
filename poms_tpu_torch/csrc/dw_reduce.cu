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
// Design: one launch per call.  The fields are read in chunks of four
// values, one 16-byte load a field and chunk when every field's address is
// 16-byte aligned (4-byte loads of the same chunks otherwise); chunk c goes
// to thread c mod (blocks * kThreads), and the four values of a chunk to
// four independent double-word accumulators per dot, so no point's add waits
// on the one before it.  A thread merges its four chains in a fixed order,
// a block adds its threads by warp-shuffle double-word trees (one barrier
// for the warps' partials), every dot in the same pass, and writes its
// partial pair into a scratch.  The last block to arrive (an arrival
// counter after __threadfence) adds every block's partial in block order
// and writes the f64 results; it resets the counter, which lives in a
// per-device buffer zeroed once, so the next call and every replay of a
// captured graph start from 0.  Every addition is the double-word add of
// dw_eft.cuh, and the order of additions depends on n alone, not on which
// block finishes last nor on the fields' alignment: no float atomics, so
// two runs give the same bits.  The order is not the plain version's
// first-half-plus-second-half tree, so the two agree to the accuracy of
// double-word addition (about 1e-14 of sum |terms|), not bitwise.

#include "dw_eft.cuh"

namespace {

using namespace dwf;

constexpr int kMaxDots = 4;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocks = 264;     // two a streaming multiprocessor
constexpr int kChunksPerThread = 4;  // chunks a thread takes before a block
                                     // is added

struct Args {
  const float* xh[kMaxDots];
  const float* xl[kMaxDots];  // null: zeros
  const float* yh[kMaxDots];  // null: the term is x
  const float* yl[kMaxDots];  // null: zeros
  long long n;
  int vec;                    // every field 16-byte aligned
  int sqrt_out;
  float* part;                // (k, blocks, 2)
  unsigned int* counter;      // blocks arrived; 0 between calls
  double* out;                // (k,)
};

// values 4c .. 4c + 3 of p (zeros past n, or where p is null)
__device__ __forceinline__ float4 load4(const float* p, long long c,
                                        long long n, bool vec) {
  if (p == nullptr) return make_float4(0.f, 0.f, 0.f, 0.f);
  const long long i = 4 * c;
  if (vec && i + 4 <= n) return __ldg(reinterpret_cast<const float4*>(p) + c);
  return make_float4(__ldg(p + i), i + 1 < n ? __ldg(p + i + 1) : 0.f,
                     i + 2 < n ? __ldg(p + i + 2) : 0.f,
                     i + 3 < n ? __ldg(p + i + 3) : 0.f);
}

__device__ __forceinline__ float lane_of(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

__device__ __forceinline__ dw shfl_down(dw v, int off) {
  return {__shfl_down_sync(0xffffffffu, v.h, off),
          __shfl_down_sync(0xffffffffu, v.l, off)};
}

// the sums over the block's threads of v[0..K-1], valid in thread 0
template <int K>
__device__ __forceinline__ void block_sum(dw (&v)[K], dw (*sm)[K]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int d = 0; d < K; ++d) v[d] = dw_add(v[d], shfl_down(v[d], off));
  }
  if (lane == 0) {
#pragma unroll
    for (int d = 0; d < K; ++d) sm[warp][d] = v[d];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int d = 0; d < K; ++d)
      v[d] = lane < kWarps ? sm[lane][d] : dw{0.0f, 0.0f};
#pragma unroll
    for (int off = kWarps / 2; off > 0; off >>= 1) {
#pragma unroll
      for (int d = 0; d < K; ++d) {
        const dw o = shfl_down(v[d], off);
        if (lane + off < kWarps) v[d] = dw_add(v[d], o);
      }
    }
  }
}

template <int K>
__global__ void __launch_bounds__(kThreads, 2)
dw_reduce_kernel(const Args a) {
  __shared__ dw sm[kWarps][K];
  __shared__ bool last;
  dw acc[K][4];
#pragma unroll
  for (int d = 0; d < K; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = dw{0.0f, 0.0f};

  const long long chunks = (a.n + 3) / 4, whole = a.n / 4;
  const long long stride = (long long)gridDim.x * kThreads;
  const bool vec = a.vec != 0;
  // every field's values of chunk c, each added to its own chain
  auto add_chunk = [&](const float4 (&f)[K][4], int valid) {
#pragma unroll
    for (int d = 0; d < K; ++d) {
      const bool prod = a.yh[d] != nullptr;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (e < valid) {
          const dw x{lane_of(f[d][0], e), lane_of(f[d][1], e)};
          const dw term =
              prod ? dw_mul(x, dw{lane_of(f[d][2], e), lane_of(f[d][3], e)})
                   : x;
          acc[d][e] = dw_add(acc[d][e], term);
        }
      }
    }
  };
  auto load_chunk = [&](float4 (&f)[K][4], long long c) {
#pragma unroll
    for (int d = 0; d < K; ++d) {
      f[d][0] = load4(a.xh[d], c, a.n, vec);
      f[d][1] = load4(a.xl[d], c, a.n, vec);
      f[d][2] = load4(a.yh[d], c, a.n, vec);
      f[d][3] = load4(a.yl[d], c, a.n, vec);
    }
  };
  long long c = (long long)blockIdx.x * kThreads + threadIdx.x;
  // whole chunks two at a time (one or two dots: the registers allow it):
  // both chunks' loads are in flight together
  if constexpr (K <= 2) {
    for (; c + stride < whole; c += 2 * stride) {
      float4 f0[K][4], f1[K][4];
      load_chunk(f0, c);
      load_chunk(f1, c + stride);
      add_chunk(f0, 4);
      add_chunk(f1, 4);
    }
  }
  for (; c < chunks; c += stride) {
    float4 f[K][4];
    load_chunk(f, c);
    add_chunk(f, (int)min(4LL, a.n - 4 * c));
  }
  dw v[K];
#pragma unroll
  for (int d = 0; d < K; ++d)
    v[d] = dw_add(dw_add(acc[d][0], acc[d][1]), dw_add(acc[d][2], acc[d][3]));
  block_sum<K>(v, sm);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int d = 0; d < K; ++d) {
      float* p = a.part + 2 * ((long long)d * gridDim.x + blockIdx.x);
      p[0] = v[d].h;
      p[1] = v[d].l;
    }
    __threadfence();  // the partials before the arrival
    last = atomicAdd(a.counter, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;

  // the last block: every partial, in block order
  __threadfence();
#pragma unroll
  for (int d = 0; d < K; ++d) {
    dw s{0.0f, 0.0f};
    for (int b = threadIdx.x; b < (int)gridDim.x; b += kThreads) {
      const float* p = a.part + 2 * ((long long)d * gridDim.x + b);
      s = dw_add(s, dw{__ldcg(p), __ldcg(p + 1)});
    }
    v[d] = s;
  }
  block_sum<K>(v, sm);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int d = 0; d < K; ++d) {
      const double r = merge_f64(v[d]);
      a.out[d] = a.sqrt_out ? sqrt(r) : r;
    }
    *a.counter = 0u;  // ready for the next call or replay
  }
}

}  // namespace

extern "C" {

// ptrs: 4 k pointers, (xh, xl, yh, yl) of each dot.  part: scratch of
// part_floats >= 2 k dw_reduce_max_blocks() floats; counter: one unsigned
// int, 0 (it is 0 again when the kernel ends).  out: k doubles.
int dw_reduce(const void* const* ptrs, int k, long long n, float* part,
              long long part_floats, unsigned int* counter, double* out,
              int sqrt_out, void* stream) {
  if (k < 1 || k > kMaxDots || n < 1 || part == nullptr ||
      counter == nullptr || out == nullptr ||
      part_floats < 2LL * k * kMaxBlocks)
    return (int)cudaErrorInvalidValue;
  Args a;
  bool aligned = true;
  for (int d = 0; d < kMaxDots; ++d) {
    const bool on = d < k;
    a.xh[d] = on ? (const float*)ptrs[4 * d] : nullptr;
    a.xl[d] = on ? (const float*)ptrs[4 * d + 1] : nullptr;
    a.yh[d] = on ? (const float*)ptrs[4 * d + 2] : nullptr;
    a.yl[d] = on ? (const float*)ptrs[4 * d + 3] : nullptr;
    if (on && a.xh[d] == nullptr) return (int)cudaErrorInvalidValue;
    const float* fields[4] = {a.xh[d], a.xl[d], a.yh[d], a.yl[d]};
    for (int f = 0; f < 4; ++f)
      aligned = aligned && ((uintptr_t)fields[f] & 15) == 0;
  }
  a.n = n, a.vec = aligned, a.sqrt_out = sqrt_out;
  a.part = part, a.counter = counter, a.out = out;
  const long long chunks = (n + 3) / 4;
  const long long per_block = (long long)kThreads * kChunksPerThread;
  long long blocks = (chunks + per_block - 1) / per_block;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (k) {
    case 1: dw_reduce_kernel<1><<<(int)blocks, kThreads, 0, st>>>(a); break;
    case 2: dw_reduce_kernel<2><<<(int)blocks, kThreads, 0, st>>>(a); break;
    case 3: dw_reduce_kernel<3><<<(int)blocks, kThreads, 0, st>>>(a); break;
    default: dw_reduce_kernel<4><<<(int)blocks, kThreads, 0, st>>>(a);
  }
  return (int)cudaGetLastError();
}

int dw_reduce_max_blocks() { return kMaxBlocks; }

const char* dw_reduce_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

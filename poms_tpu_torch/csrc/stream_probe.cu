// Stream probe (K4): the device-memory ceiling a banded SpMV is read
// against.  Reads a band-sized f32 buffer once and reduces it plane by
// plane:
//
//   out[i] = sum over the w^3 coefficient planes of band[plane, i]
//            + 1e-6 * x[i]
//
// in either of the two layouts of the TPU probe: the library layout
// (w, w, w, n, n, n), offset-major as StencilMatrix.band_t stores it, and
// the contiguous layout (w, n, w, w, n, n).
//
// Replaces the TPU kernel poms_tpu/bench/kernel_probe.py::probe_stream
// (the pallas_call at :85).  x is read so that the output depends on it,
// as in the TPU probe; the byte count (w^3 + 2) n^3 * 4 includes it and
// the output.
//
// What bounds it on an H100: nothing but device-memory bandwidth
// (3.35 TB/s): one add per 4-byte coefficient.  Design: each thread owns
// four consecutive points of the last axis (16-byte loads) and walks the
// planes in order; both layouts are written as
//   offset = ((k1 * A + a) * w^2 + k23) * B + c,   point = a * B + c
// (library: A = 1, B = n^3; contiguous: A = n, B = n^2), so one kernel
// reads either, each warp 512 consecutive bytes of one plane per load.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void __launch_bounds__(256)
stream_probe_kernel(const float4* __restrict__ band,
                    const float4* __restrict__ x, float4* __restrict__ out,
                    int w, int64_t A, int64_t B4, int64_t total4) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total4) return;
  const int64_t a = idx / B4, c = idx - a * B4;
  const int ww = w * w;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k1 = 0; k1 < w; ++k1) {
    const float4* base = band + ((int64_t)k1 * A + a) * ww * B4 + c;
#pragma unroll 7
    for (int k23 = 0; k23 < ww; ++k23) {
      const float4 v = base[(int64_t)k23 * B4];
      acc.x += v.x;
      acc.y += v.y;
      acc.z += v.z;
      acc.w += v.w;
    }
  }
  const float4 xv = x[idx];
  out[idx] = make_float4(acc.x + 1e-6f * xv.x, acc.y + 1e-6f * xv.y,
                         acc.z + 1e-6f * xv.z, acc.w + 1e-6f * xv.w);
}

}  // namespace

extern "C" {

// n % 4 == 0 and 16-byte aligned pointers (the wrapper checks both)
int stream_probe_f32(const float* band, const float* x, float* out, int n,
                     int w, int contiguous, void* stream) {
  if (n < 4 || n % 4 || w < 1) return (int)cudaErrorInvalidValue;
  const int64_t n3 = (int64_t)n * n * n;
  const int64_t A = contiguous ? n : 1;
  const int64_t B = contiguous ? (int64_t)n * n : n3;
  const int64_t total4 = n3 / 4;
  const int threads = 256;
  const int64_t blocks = (total4 + threads - 1) / threads;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  stream_probe_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(band),
      reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(out), w,
      A, B / 4, total4);
  return (int)cudaGetLastError();
}

const char* stream_probe_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

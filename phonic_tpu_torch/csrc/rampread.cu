// Batched 4-point Hermite read of fractional positions (kernel 1).
//
// Replaces the TPU kernel phonic_tpu/ops/rampread.py:_read_kernel (entered
// via ramp_read), which packed every source buffer into overlapped
// 124-stride rows, DMA'd per-chunk row windows into VMEM and selected the
// taps with one-hot dots on the MXU, because per-element gathers ran at
// scalar rate on that chip.
//
// What bounds it here: the read is memory-bound and gather-shaped.  Per
// output it loads one position (4 B) and four taps per channel, and stores
// one float per channel.  The taps of neighbouring outputs are neighbouring
// samples (positions are ramps), so a warp's tap loads hit a handful of
// cache lines and the source buffers (16 x 27k floats on the headline
// graph) stay resident in L2; what reaches device memory is essentially
// positions in and audio out.
//
// Design: no packing.  Buffers stay planar [S, ch, F] on the device; one
// thread per (lane b, output n) computes the tap index once and reads the
// four taps for every channel, with a bounds check per tap (missing taps
// contribute 0, exactly as ops/resample.py:hermite_read).  The arithmetic
// is the Niemitalo x-form of hermite_read (reference
// src/utils/resampler/cubic.rs:121-142); the CUDA compiler may contract
// it into FMAs, so it matches the plain version to ~1e-6 relative, not
// bit for bit.  A source index outside [0, S) reads silence.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float tap(const float* __restrict__ row, long long i,
                                     int frames) {
  return (i >= 0 && i < frames) ? __ldg(row + i) : 0.0f;
}

__global__ void ramp_read_kernel(const float* __restrict__ buf,
                                 const int* __restrict__ smap,
                                 const float* __restrict__ pos,
                                 float* __restrict__ out, int sources,
                                 int channels, int frames, int n) {
  const int b = blockIdx.y;
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= n) return;
  const float p = pos[(size_t)b * n + j];
  const int src = smap[b];
  float* o = out + (size_t)b * channels * n + j;
  // positions beyond every tap (including NaN) read silence; the bound also
  // keeps the float -> integer conversion in range
  const bool in_range = (p > -4.0f) && (p < (float)frames + 4.0f) &&
                        src >= 0 && src < sources;
  if (!in_range) {
    for (int c = 0; c < channels; ++c) o[(size_t)c * n] = 0.0f;
    return;
  }
  const float k = floorf(p);
  const float f = p - k;
  const long long ki = (long long)k;
  for (int c = 0; c < channels; ++c) {
    const float* row = buf + ((size_t)src * channels + c) * frames;
    const float ym1 = tap(row, ki - 1, frames);
    const float y0 = tap(row, ki, frames);
    const float y1 = tap(row, ki + 1, frames);
    const float y2 = tap(row, ki + 2, frames);
    const float c1 = (y1 - ym1) * 0.5f;
    const float c2 = ym1 - y0 * 2.5f + y1 * 2.0f - y2 * 0.5f;
    const float c3 = (y2 - ym1) * 0.5f + (y0 - y1) * 1.5f;
    o[(size_t)c * n] = ((c3 * f + c2) * f + c1) * f + y0;
  }
}

}  // namespace

extern "C" int phonic_ramp_read(int device, const float* buf,
                                const int* smap, const float* pos, float* out,
                                int sources, int channels, int frames,
                                int lanes, int n, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n + kThreads - 1) / kThreads, lanes);
  ramp_read_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      buf, smap, pos, out, sources, channels, frames, n);
  return (int)cudaGetLastError();
}

extern "C" const char* phonic_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

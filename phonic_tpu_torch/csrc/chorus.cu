// The chorus's feedback line in one launch (kernel 9).
//
// ChorusEffect (effects/chorus.py) reads its line at an LFO-modulated
// position and writes the filtered input plus the read times the feedback
// back into it.  For every lane and both channels, sample t of a block:
//
//   k, f    = floor(pos[t]), pos[t] - k
//   wet[t]  = lerp read of the line at t - pos[t]  (ops/chrono.py's order)
//   line[t] = filtered[t] + wet[t] * feedback[t]
//
// This replaces no TPU kernel: the JAX package runs this loop as a
// lax.scan of jnp operations over sub-blocks (phonic_tpu/effects/
// chorus.py).  The plain version, ops/chorusline.py:line_plain, is that
// loop: a window read (~14 operations) and a roll per sub-block of at most
// 512 samples, ~240 launches per 8192-frame block.
//
// What bounds it here: the recurrence.  Every read position is at least
// b + 1 samples (the effect clamps it there), so a block is a chain of
// tiles of at most b samples, each of which starts only once the one
// before it has written the line.  The bytes (three streams read, the wet
// signal written, the window read and written once: ~0.5 MB per lane at
// the Player's 8192 samples) are not the limit: 16 tiles of a read, a
// barrier and a write are.
//
// Design: one block of 512 threads per (lane, channel), a thread per
// sample of a tile of min(b, 512) samples.  The window (5,376 samples at 48
// kHz, 21 KB) is a ring in shared memory, position p (of "old window, then
// this block's writes") in slot p mod W.  Per tile each thread reads its
// sample's two taps, interpolates, writes the wet sample and forms the
// line's input; after a barrier it writes that into the ring.  After the
// last tile the ring is copied out as the new window, newest last.
//
// Arithmetic: the plain version's order, with no FMA contraction
// (__fmul_rn / __fadd_rn): nothing sums over samples, so the kernel gives
// what the plain version gives, bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"

namespace {

constexpr int kThreads = 512;
// shared memory a block may take without opting in
constexpr size_t kDefaultShared = 48 * 1024;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

__global__ void __launch_bounds__(kThreads)
    chorus_line_kernel(const float* pos, const float* filtered,
                       const float* feedback, const float* hist, float* wet,
                       float* win, int n, int w, int tile) {
  extern __shared__ float ring[];
  const int g = blockIdx.x >> 1;
  const int c = blockIdx.x & 1;
  const int tid = threadIdx.x;
  const long long row = ((long long)g * 2 + c) * n;
  const float* fbk = feedback + (long long)g * n;
  const long long wrow = ((long long)g * 2 + c) * w;

  for (int q = tid; q < w; q += kThreads) ring[q] = hist[wrow + q];
  __syncthreads();

  for (int t0 = 0; t0 < n; t0 += tile) {
    const int t = t0 + tid;
    const bool on = tid < tile && t < n;
    float in = 0.0f;
    if (on) {
      // chrono.read_frac_win: position W + t - k - (f != 0), then the one
      // after it, weighted by 1 - f (or f when it is 0)
      const float p = pos[row + t];
      const float k = floorf(p);
      const float f = sub(p, k);  // exact (Sterbenz)
      const bool whole = f == 0.0f;
      const float frac = whole ? f : sub(1.0f, f);
      // clamping the offset keeps any position inside the window and
      // leaves a valid one as it is
      const int off = (int)fminf(fmaxf(k, 0.0f), (float)(w - 2));
      const int s1 = (w + t - off - (whole ? 0 : 1)) % w;
      const int s2 = s1 + 1 == w ? 0 : s1 + 1;
      const float v1 = ring[s1], v2 = ring[s2];
      const float d = add(v1, mul(sub(v2, v1), frac));
      wet[row + t] = d;
      in = add(filtered[row + t], mul(d, fbk[t]));
    }
    __syncthreads();  // the tile's reads before its writes
    if (on) ring[(w + t) % w] = in;
    __syncthreads();  // the tile's writes before the next tile's reads
  }
  // the last W positions, n .. n + W - 1, newest last
  for (int q = tid; q < w; q += kThreads) win[wrow + q] = ring[(n + q) % w];
}

}  // namespace

// One block of the chorus's feedback line for `lanes` lanes of `n`
// samples over a window of `w` samples.  Every read position must lie in
// [b + 1, w - 2] samples: the tiles are at most b samples long, so each
// read's source was written by an earlier tile.
extern "C" int phonic_chorus(int device, const float* pos,
                             const float* filtered, const float* feedback,
                             const float* hist, float* wet, float* win,
                             int lanes, int n, int w, int b, void* stream) {
  if (lanes < 1 || n < 1 || w < 3 || b < 1) return (int)cudaErrorInvalidValue;
  DeviceGuard on(device);
  if (on.err != cudaSuccess) return (int)on.err;
  const size_t shared = (size_t)w * sizeof(float);
  if (shared > kDefaultShared) {
    const cudaError_t err = cudaFuncSetAttribute(
        chorus_line_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)shared);
    if (err != cudaSuccess) return (int)err;
  }
  const int tile = b < kThreads ? b : kThreads;
  chorus_line_kernel<<<lanes * 2, kThreads, shared, (cudaStream_t)stream>>>(
      pos, filtered, feedback, hist, wet, win, n, w, tile);
  return (int)cudaGetLastError();
}

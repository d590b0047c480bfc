// Batched 4-point Hermite read of fractional positions (kernel 1).
//
// Replaces the TPU kernel phonic_tpu/ops/rampread.py:_read_kernel (entered
// via ramp_read), which packed every source buffer into overlapped
// 124-stride rows, DMA'd per-chunk row windows into VMEM and selected the
// taps with one-hot dots on the MXU, because per-element gathers ran at
// scalar rate on that chip.
//
// What bounds it here: the byte bound counts the positions read and the
// audio written (the tables, 16 x 27k floats on the headline graph or one
// 48k-frame tone under 64 sampler voices, stay in the 50 MB L2, and the
// taps of neighbouring outputs are neighbouring samples).  Measured on the
// H100 (PERF.md), what held the read back was neither those bytes
// nor the tap gathers but instructions per output (a bounds check and
// 64-bit address arithmetic per tap; in a first cp.async version, every
// copy re-deriving its shared address), so the four schedulers of an SM,
// not its memory, set the pace.  A
// variant whose taps were arithmetic, with no loads at all, took as long
// as the real read.
//
// Design: buffers stay planar [S, ch, F], no packing.  A warp owns chunks
// of 128 consecutive outputs of one lane; lane l computes outputs l, l+32,
// l+64 and l+96, so every load and store instruction of the warp covers 32
// consecutive outputs and any row start or length works without a vector
// path.  The grid is sized to the card (kBlocksPerSm blocks of kThreads
// per SM) and its warps stride over the (lane, chunk) items.  Each thread
// stages its own positions with 4-byte cp.async into a per-warp ring of
// kStages chunks, two chunks ahead of the one it reads, so position loads
// never stall the taps.  When every tap of the warp's chunk lies inside
// the table (a vote), each output takes one address and four loads at
// immediate offsets with no checks; a chunk that touches a table edge
// checks every tap.  Plain stores: streaming stores (st.global.cs)
// measured slower, since the output is read again soon from L2.
//
// Semantics, as ops/resample.py:hermite_read: a tap outside [0, F)
// contributes 0.  Beyond it, a position at or beyond 4 samples outside the
// table reads silence, and so does NaN (the bound also keeps the float ->
// integer conversion in range); a source index outside [0, S) reads
// silence.  The arithmetic is the Niemitalo x-form of hermite_read
// (reference src/utils/resampler/cubic.rs:121-142); the CUDA compiler may
// contract it into FMAs, so it matches the plain version to ~1e-6
// relative, not bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 5;
constexpr int kPer = 4;            // outputs per thread per chunk
constexpr int kChunk = 32 * kPer;  // outputs per warp per chunk
constexpr int kStages = 3;         // position chunks per warp: 1 read, 2 landing
constexpr unsigned kFull = 0xffffffffu;

struct Read {
  const float* buf;  // [sources, channels, frames]
  const int* smap;   // [lanes]
  const float* pos;  // [lanes, n]
  float* out;        // [lanes, channels, n]
  int sources, channels, frames, lanes, n;
};

__device__ __forceinline__ void cp_async4(unsigned dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// every group but the newest kStages - 1 has landed
__device__ __forceinline__ void cp_async_wait_stage() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1) : "memory");
}

// This thread's outputs of chunk q of lane b are q * kChunk + lane + 32 e,
// e < kPer: every load and store instruction of a warp covers 32
// consecutive outputs.  Each thread stages, and later reads, exactly its
// own positions, so no lane waits for another.  `slot` is the shared
// address of this thread's first position in a ring slot.
__device__ __forceinline__ void stage(const Read& r, unsigned slot, int b,
                                      int q, int lane) {
  const int j = q * kChunk + lane;
  const float* src = r.pos + (size_t)b * r.n + j;
#pragma unroll
  for (int e = 0; e < kPer; ++e)
    if (j + 32 * e < r.n) cp_async4(slot + 4 * 32 * e, src + 32 * e);
}

__device__ __forceinline__ float hermite(float ym1, float y0, float y1,
                                         float y2, float f) {
  const float c1 = (y1 - ym1) * 0.5f;
  const float c2 = ym1 - y0 * 2.5f + y1 * 2.0f - y2 * 0.5f;
  const float c3 = (y2 - ym1) * 0.5f + (y0 - y1) * 1.5f;
  return ((c3 * f + c2) * f + c1) * f + y0;
}

__device__ __forceinline__ float tap(const float* __restrict__ row, int i,
                                     int frames) {
  return (unsigned)i < (unsigned)frames ? __ldg(row + i) : 0.0f;
}

// The outputs of a chunk that touches a table edge: every tap checked.
__device__ __forceinline__ void read_edge(const Read& r, const float* row,
                                          const bool* ok, const int* k,
                                          const float* f, float* o) {
#pragma unroll
  for (int e = 0; e < kPer; ++e)
    o[e] = ok[e] ? hermite(tap(row, k[e] - 1, r.frames), tap(row, k[e], r.frames),
                           tap(row, k[e] + 1, r.frames),
                           tap(row, k[e] + 2, r.frames), f[e])
                 : 0.0f;
}

// This thread's outputs of chunk q of lane b, every channel, from the
// positions staged at `slot`.
__device__ __forceinline__ void read_chunk(const Read& r, const float* slot,
                                           int b, int q, int lane) {
  const int src = __ldg(r.smap + b);
  const bool src_ok = src >= 0 && src < r.sources;
  const float hi = (float)r.frames + 4.0f;
  bool ok[kPer];
  int k[kPer];
  float f[kPer];
  const int j = q * kChunk + lane;
  bool inside = r.frames >= 4;
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const float p = slot[32 * e];  // stale past n: never used
    // positions beyond every tap (and NaN) read silence
    ok[e] = src_ok && j + 32 * e < r.n && p > -4.0f && p < hi;
    const float kf = floorf(p);
    k[e] = ok[e] ? (int)kf : 1;  // 1: a safe index for a silent output
    f[e] = p - kf;
    inside = inside && (unsigned)(k[e] - 1) < (unsigned)(r.frames - 3);
  }
  // the whole warp's taps inside the table: no tap needs a check
  inside = __all_sync(kFull, inside);
  const float* rows = r.buf + (size_t)(src_ok ? src : 0) * r.channels * r.frames;
  float* dst = r.out + (size_t)b * r.channels * r.n + j;
  for (int c = 0; c < r.channels; ++c) {
    const float* row = rows + (size_t)c * r.frames;
    float o[kPer];
    if (inside) {
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        const float* t = row + k[e];
        const float v = hermite(__ldg(t - 1), __ldg(t), __ldg(t + 1),
                                __ldg(t + 2), f[e]);
        o[e] = ok[e] ? v : 0.0f;
      }
    } else {
      read_edge(r, row, ok, k, f, o);
    }
#pragma unroll
    for (int e = 0; e < kPer; ++e)
      if (j + 32 * e < r.n) dst[32 * e] = o[e];
    dst += r.n;
  }
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    ramp_read_kernel(Read r) {
  __shared__ float ring_sh[kWarps][kStages][kChunk];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* ring = &ring_sh[warp][0][lane];
  const unsigned ring_s =
      static_cast<unsigned>(__cvta_generic_to_shared(ring));
  const int chunks = (r.n + kChunk - 1) / kChunk;  // per lane
  // each warp takes the items (lane b, chunk q) `stride` apart, in
  // lane-major order: (b, q) is the item it reads, (sb_, sq_) the next one
  // it stages, kStages - 1 items ahead
  const int stride = gridDim.x * kWarps;
  const int first = blockIdx.x * kWarps + warp;
  const int db = stride / chunks, dq = stride % chunks;
  int b = first / chunks, q = first % chunks;
  int sb_ = b, sq_ = q;
  auto next = [&](int& x, int& y) {
    x += db;
    y += dq;
    if (y >= chunks) {
      y -= chunks;
      ++x;
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (sb_ < r.lanes) stage(r, ring_s + 4 * kChunk * s, sb_, sq_, lane);
    cp_async_commit();
    next(sb_, sq_);
  }
  for (int s = 0; b < r.lanes; s = s + 1 == kStages ? 0 : s + 1) {
    // into the slot read in the last iteration (its values are used)
    const int free = s == 0 ? kStages - 1 : s - 1;
    if (sb_ < r.lanes) stage(r, ring_s + 4 * kChunk * free, sb_, sq_, lane);
    cp_async_commit();
    next(sb_, sq_);
    cp_async_wait_stage();
    read_chunk(r, ring + kChunk * s, b, q, lane);
    next(b, q);
  }
}

}  // namespace

extern "C" int phonic_ramp_read(int device, const float* buf,
                                const int* smap, const float* pos, float* out,
                                int sources, int channels, int frames,
                                int lanes, int n, void* stream) {
  DeviceGuard on(device);
  if (on.err != cudaSuccess) return (int)on.err;
  int sms = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const long long items = (long long)lanes * ((n + kChunk - 1) / kChunk);
  const long long wanted = (items + kWarps - 1) / kWarps;
  const long long card = (long long)sms * kBlocksPerSm;
  const Read r = {buf, smap, pos, out, sources, channels, frames, lanes, n};
  ramp_read_kernel<<<(int)(wanted < card ? wanted : card), kThreads, 0,
                     (cudaStream_t)stream>>>(r);
  return (int)cudaGetLastError();
}

extern "C" const char* phonic_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

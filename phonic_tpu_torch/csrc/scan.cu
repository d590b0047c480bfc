// Time-varying first- and second-order linear recurrences (kernels 2, 3).
//
//   iir1:  y[n] = a[n] * y[n-1] + b[n],        y[-1] = y0
//   iir2:  s[n] = A[n] @ s[n-1] + b[n],        s[-1] = s0   (A is 2x2)
//
// over [R, T] row-major streams (rows x time).
//
// Replaces the TPU kernels phonic_tpu/ops/pallas_scan.py:_iir1_kernel and
// _iir2_kernel (entered via iir1_scan / iir2_scan), which ran a Hillis-Steele
// doubling scan over lane-aligned time chunks in VMEM and carried the state
// across the sequential TPU grid in scratch memory.
//
// What bounds it here: the headline graph's streams are tall and thin
// (R = 2..8 rows, T = 131072).  A loop with one thread per row would occupy
// a few SMs of 132 and serialise 131072 dependent steps.  Spread over the
// card, the work is memory-bound: iir2 reads six and writes two floats per
// element, iir1 reads two and writes one.
//
// Design: the two-level chunked form of ops/scan.py (_chunked_first /
// _chunked_second), spread over blocks.  A block owns one row and one
// segment of kSeg = 4096 samples; each of its 256 threads owns 16
// consecutive samples.
//   pass 1 (*_reduce): every thread runs its 16 samples from zero state,
//     keeping the particular solution w and the cumulative coefficient
//     product P (for iir2 a 2x2 matrix carried as four scalars); a block
//     scan (warp shuffles, then shared memory) composes them into the
//     segment's affine map s_out = P s_in + w, stored in a small scratch.
//   pass 2 (*_apply): one thread threads the row's initial state through
//     the maps of the preceding segments; the block scan gives each thread
//     the map from its segment start to its chunk start; each thread then
//     re-runs its 16 samples from the exact incoming state and stores them.
// Composition is "later after earlier" (A_r A_l, A_r b_l + b_r), as in
// pallas_scan.py:94-108; there is no time padding (loops stop at T), which
// is the A = I, b = 0 padding of pallas_scan.py:226-229.  The association
// order differs from both JAX paths, so float32 results agree to rounding.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 16;
constexpr int kSeg = kThreads * kPer;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// y_out = p * y_in + w
struct Aff1 {
  float p, w;
};
// s_out = M s_in + w
struct Aff2 {
  float m11, m12, m21, m22, w1, w2;
};

__device__ __forceinline__ Aff1 identity(Aff1) { return {1.0f, 0.0f}; }
__device__ __forceinline__ Aff2 identity(Aff2) {
  return {1.0f, 0.0f, 0.0f, 1.0f, 0.0f, 0.0f};
}

// the map of `second` applied after `first`
__device__ __forceinline__ Aff1 compose(const Aff1& first, const Aff1& second) {
  return {second.p * first.p, second.p * first.w + second.w};
}
__device__ __forceinline__ Aff2 compose(const Aff2& f, const Aff2& s) {
  return {s.m11 * f.m11 + s.m12 * f.m21, s.m11 * f.m12 + s.m12 * f.m22,
          s.m21 * f.m11 + s.m22 * f.m21, s.m21 * f.m12 + s.m22 * f.m22,
          s.m11 * f.w1 + s.m12 * f.w2 + s.w1, s.m21 * f.w1 + s.m22 * f.w2 + s.w2};
}

__device__ __forceinline__ Aff1 shfl_up(const Aff1& x, int d) {
  return {__shfl_up_sync(kFull, x.p, d), __shfl_up_sync(kFull, x.w, d)};
}
__device__ __forceinline__ Aff2 shfl_up(const Aff2& x, int d) {
  return {__shfl_up_sync(kFull, x.m11, d), __shfl_up_sync(kFull, x.m12, d),
          __shfl_up_sync(kFull, x.m21, d), __shfl_up_sync(kFull, x.m22, d),
          __shfl_up_sync(kFull, x.w1, d),  __shfl_up_sync(kFull, x.w2, d)};
}

// Exclusive scan of the threads' maps in thread order.  Returns, for each
// thread, the composition of all earlier threads' maps; *total receives the
// whole block's map.  Every thread of the block must call it.
template <class A>
__device__ A block_exclusive_scan(const A& x, A* total) {
  __shared__ A warp_tot[kWarps];
  __shared__ A block_tot;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  A inc = x;
  for (int d = 1; d < 32; d <<= 1) {
    A other = shfl_up(inc, d);
    if (lane >= d) inc = compose(other, inc);
  }
  if (lane == 31) warp_tot[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    A t = lane < kWarps ? warp_tot[lane] : identity(x);
    for (int d = 1; d < 32; d <<= 1) {
      A other = shfl_up(t, d);
      if (lane >= d) t = compose(other, t);
    }
    if (lane < kWarps) warp_tot[lane] = t;
    if (lane == kWarps - 1) block_tot = t;
  }
  __syncthreads();
  A prev = shfl_up(inc, 1);
  if (lane == 0) prev = identity(x);
  A res = warp > 0 ? compose(warp_tot[warp - 1], prev) : prev;
  *total = block_tot;
  return res;
}

struct Chunk {
  long long lo, hi;  // this thread's samples [lo, hi) within the row
};

__device__ __forceinline__ Chunk thread_chunk(long long t) {
  const long long lo = (long long)blockIdx.x * kSeg + (long long)threadIdx.x * kPer;
  long long hi = lo + kPer;
  if (hi > t) hi = t;
  return {lo, hi};
}

// ---------------------------------------------------------------- iir1

__device__ __forceinline__ Aff1 run1(const float* __restrict__ a,
                                     const float* __restrict__ b, Chunk c) {
  Aff1 acc = {1.0f, 0.0f};
  for (long long i = c.lo; i < c.hi; ++i) {
    const float ai = __ldg(a + i);
    acc.w = ai * acc.w + __ldg(b + i);
    acc.p *= ai;
  }
  return acc;
}

__global__ void iir1_reduce(const float* __restrict__ a,
                            const float* __restrict__ b, Aff1* agg,
                            long long t, int nseg) {
  const size_t row = blockIdx.y;
  const Chunk c = thread_chunk(t);
  Aff1 total;
  block_exclusive_scan(run1(a + row * t, b + row * t, c), &total);
  if (threadIdx.x == 0) agg[row * nseg + blockIdx.x] = total;
}

__global__ void iir1_apply(const float* __restrict__ a,
                           const float* __restrict__ b,
                           const float* __restrict__ y0,
                           const Aff1* __restrict__ agg,
                           float* __restrict__ out, long long t, int nseg) {
  __shared__ float y_seg;
  const size_t row = blockIdx.y;
  const float* ar = a + row * t;
  const float* br = b + row * t;
  if (threadIdx.x == 0) {
    float y = y0[row];
    for (int s = 0; s < (int)blockIdx.x; ++s) {
      const Aff1 g = agg[row * nseg + s];
      y = g.p * y + g.w;
    }
    y_seg = y;
  }
  const Chunk c = thread_chunk(t);
  Aff1 total;
  const Aff1 ex = block_exclusive_scan(run1(ar, br, c), &total);
  float y = ex.p * y_seg + ex.w;
  float* o = out + row * t;
  for (long long i = c.lo; i < c.hi; ++i) {
    y = ar[i] * y + br[i];
    o[i] = y;
  }
}

// ---------------------------------------------------------------- iir2

struct Streams2 {
  const float *a11, *a12, *a21, *a22, *b1, *b2;
};

__device__ __forceinline__ Streams2 row_of(const Streams2& s, size_t off) {
  return {s.a11 + off, s.a12 + off, s.a21 + off, s.a22 + off, s.b1 + off,
          s.b2 + off};
}

__device__ __forceinline__ Aff2 run2(const Streams2& s, Chunk c) {
  Aff2 acc = {1.0f, 0.0f, 0.0f, 1.0f, 0.0f, 0.0f};
  for (long long i = c.lo; i < c.hi; ++i) {
    const Aff2 step = {__ldg(s.a11 + i), __ldg(s.a12 + i), __ldg(s.a21 + i),
                       __ldg(s.a22 + i), __ldg(s.b1 + i),  __ldg(s.b2 + i)};
    acc = compose(acc, step);
  }
  return acc;
}

__global__ void iir2_reduce(Streams2 s, Aff2* agg, long long t, int nseg) {
  const size_t row = blockIdx.y;
  const Chunk c = thread_chunk(t);
  Aff2 total;
  block_exclusive_scan(run2(row_of(s, row * t), c), &total);
  if (threadIdx.x == 0) agg[row * nseg + blockIdx.x] = total;
}

__global__ void iir2_apply(Streams2 s, const float* __restrict__ s0_1,
                           const float* __restrict__ s0_2,
                           const Aff2* __restrict__ agg,
                           float* __restrict__ out1, float* __restrict__ out2,
                           long long t, int nseg) {
  __shared__ float seg1, seg2;
  const size_t row = blockIdx.y;
  const Streams2 r = row_of(s, row * t);
  if (threadIdx.x == 0) {
    float x1 = s0_1[row], x2 = s0_2[row];
    for (int k = 0; k < (int)blockIdx.x; ++k) {
      const Aff2 g = agg[row * nseg + k];
      const float n1 = g.m11 * x1 + g.m12 * x2 + g.w1;
      const float n2 = g.m21 * x1 + g.m22 * x2 + g.w2;
      x1 = n1;
      x2 = n2;
    }
    seg1 = x1;
    seg2 = x2;
  }
  const Chunk c = thread_chunk(t);
  Aff2 total;
  const Aff2 ex = block_exclusive_scan(run2(r, c), &total);
  float x1 = ex.m11 * seg1 + ex.m12 * seg2 + ex.w1;
  float x2 = ex.m21 * seg1 + ex.m22 * seg2 + ex.w2;
  float* o1 = out1 + row * t;
  float* o2 = out2 + row * t;
  for (long long i = c.lo; i < c.hi; ++i) {
    const float n1 = r.a11[i] * x1 + r.a12[i] * x2 + r.b1[i];
    const float n2 = r.a21[i] * x1 + r.a22[i] * x2 + r.b2[i];
    x1 = n1;
    x2 = n2;
    o1[i] = x1;
    o2[i] = x2;
  }
}

int segments(long long t) { return (int)((t + kSeg - 1) / kSeg); }

}  // namespace

// Scratch floats the caller allocates for iir1 / iir2 over [rows, t].
extern "C" long long phonic_iir1_scratch(int rows, long long t) {
  return (long long)rows * segments(t) * 2;
}
extern "C" long long phonic_iir2_scratch(int rows, long long t) {
  return (long long)rows * segments(t) * 6;
}

extern "C" int phonic_iir1(int device, const float* a, const float* b, const float* y0,
                           float* out, float* scratch, int rows, long long t,
                           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int nseg = segments(t);
  dim3 grid(nseg, rows);
  cudaStream_t st = (cudaStream_t)stream;
  Aff1* agg = reinterpret_cast<Aff1*>(scratch);
  iir1_reduce<<<grid, kThreads, 0, st>>>(a, b, agg, t, nseg);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  iir1_apply<<<grid, kThreads, 0, st>>>(a, b, y0, agg, out, t, nseg);
  return (int)cudaGetLastError();
}

extern "C" int phonic_iir2(int device, const float* a11, const float* a12, const float* a21,
                           const float* a22, const float* b1, const float* b2,
                           const float* s0_1, const float* s0_2, float* out1,
                           float* out2, float* scratch, int rows, long long t,
                           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int nseg = segments(t);
  dim3 grid(nseg, rows);
  cudaStream_t st = (cudaStream_t)stream;
  Aff2* agg = reinterpret_cast<Aff2*>(scratch);
  const Streams2 s = {a11, a12, a21, a22, b1, b2};
  iir2_reduce<<<grid, kThreads, 0, st>>>(s, agg, t, nseg);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  iir2_apply<<<grid, kThreads, 0, st>>>(s, s0_1, s0_2, agg, out1, out2, t, nseg);
  return (int)cudaGetLastError();
}

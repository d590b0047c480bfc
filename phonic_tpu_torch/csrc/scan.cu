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
// Both split a row into segments of kSeg = 4096 samples, one block of 256
// threads each, and each thread owns 16 consecutive samples.  A thread runs
// its samples from zero state, keeping the particular solution w and the
// cumulative coefficient product P (for iir2 a 2x2 matrix carried as four
// scalars); a block scan (warp shuffles, then shared memory) composes them
// into each thread's offset within the segment and the segment's affine map
// s_out = P s_in + w.  Composition is "later after earlier" (A_r A_l,
// A_r b_l + b_r), as in pallas_scan.py:94-108; there is no time padding
// (loops stop at T), which is the A = I, b = 0 padding of
// pallas_scan.py:226-229.
//
// iir1 (two passes, two launches): *_reduce stores each segment's map in a
// scratch; *_apply has one thread thread the row's initial state through
// the preceding segments' maps, then every thread re-runs its samples from
// the exact incoming state and stores them.
//
// iir2 (one pass, one launch): a single-pass chained scan with decoupled
// look-back (Merrill and Garland, "Single-pass Parallel Prefix Scan with
// Decoupled Look-back", 2016).  Each block takes its (row, segment) from an
// atomic tile counter, in row-major order, so a segment's predecessors were
// handed to blocks that are resident or finished.  It stages its segment of
// the six streams into shared memory (16-byte cp.async where the row start
// is 16-byte aligned, 4-byte copies for the ragged end and for other rows),
// so every stream is read from device memory once, with coalesced loads;
// the threads then read their 16 samples as float4s, through a swizzle that
// keeps those reads free of bank conflicts.  After the block scan, the
// block publishes its segment's map ("aggregate"), and warp 0 looks back
// over the predecessors 32 at a time: it composes the aggregates of those
// that have one up to the nearest that has published its inclusive state
// (the row's state after it), spinning only while a nearer one has
// published nothing yet.  The block publishes its own inclusive state,
// re-runs its samples from the exact incoming state, and writes out1 and
// out2 through shared memory with coalesced stores.  Flags carry a per-call
// epoch, so the scratch of flags and records is never cleared between
// calls; the last block to take a ticket resets the tile counter.
//
// Association order: both kernels compose in another order than either JAX
// path (and iir2's look-back in another order than the two-pass design),
// so float32 results agree to rounding, not bit for bit.

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

__device__ __forceinline__ Aff2 shfl_down(const Aff2& x, int d) {
  return {__shfl_down_sync(kFull, x.m11, d), __shfl_down_sync(kFull, x.m12, d),
          __shfl_down_sync(kFull, x.m21, d), __shfl_down_sync(kFull, x.m22, d),
          __shfl_down_sync(kFull, x.w1, d),  __shfl_down_sync(kFull, x.w2, d)};
}
__device__ __forceinline__ Aff2 shfl(const Aff2& x, int src) {
  return {__shfl_sync(kFull, x.m11, src), __shfl_sync(kFull, x.m12, src),
          __shfl_sync(kFull, x.m21, src), __shfl_sync(kFull, x.m22, src),
          __shfl_sync(kFull, x.w1, src),  __shfl_sync(kFull, x.w2, src)};
}

// Shared-memory slot of sample p of a staged stream: 16-byte groups, with
// group g stored at g ^ ((g >> 3) & 7).  Thread l reads groups 4l .. 4l+3,
// so the 8 threads of a quarter-warp read 8 distinct bank quads.
__device__ __forceinline__ int swz(int p) {
  const int g = p >> 2;
  return ((g ^ ((g >> 3) & 7)) << 2) | (p & 3);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}
__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ float elem(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Look-back state of one (row, segment): a flag word (epoch << 2 | status)
// and a record of the segment's map and its inclusive state.
constexpr unsigned kAggregate = 1;  // the map is published
constexpr unsigned kInclusive = 2;  // the state after the segment too
struct alignas(16) Record {
  float m11, m12, m21, m22, w1, w2, x1, x2;
};
struct Scratch {
  unsigned* counter;  // tile tickets handed out in this launch
  unsigned* flags;    // [rows * nseg]
  Record* rec;        // [rows * nseg]
};

__device__ __forceinline__ Scratch scratch_of(float* base, int tiles) {
  unsigned* w = reinterpret_cast<unsigned*>(base);
  const int rec_at = 4 + ((tiles + 3) & ~3);  // in words, 16-byte aligned
  return {w, w + 4, reinterpret_cast<Record*>(w + rec_at)};
}

// Warp 0: the row's state entering segment `seg` (> 0) of the row whose
// first segment's slot is `first`.  Every lane returns it.
__device__ void look_back(const Scratch& sc, int first, int seg,
                          unsigned epoch, float s0_1, float s0_2, float* x1,
                          float* x2) {
  const int lane = threadIdx.x & 31;
  Aff2 acc = identity(Aff2{});  // the segments after this window, composed
  for (int hi = seg - 1;; hi -= 32) {
    const int j = hi - lane;  // lane 0 holds the nearest predecessor
    int stop;
    while (true) {
      // j < 0: before the row's start, where the initial state is known
      unsigned status = kInclusive;
      if (j >= 0) {
        const unsigned f = ld_acquire(sc.flags + first + j);
        status = (f >> 2) == epoch ? (f & 3) : 0;
      }
      const unsigned incl = __ballot_sync(kFull, status == kInclusive);
      const unsigned none = __ballot_sync(kFull, status == 0);
      stop = incl ? __ffs(incl) - 1 : 32;  // the nearest inclusive one
      const unsigned nearer = stop == 32 ? kFull : (1u << stop) - 1;
      if (!(none & nearer)) break;  // all nearer ones have their maps
    }
    Aff2 m = identity(Aff2{});
    if (lane < stop) {
      const Record* r = sc.rec + first + j;
      const float4 q = __ldcg(reinterpret_cast<const float4*>(r));
      const float2 w = __ldcg(reinterpret_cast<const float2*>(&r->w1));
      m = {q.x, q.y, q.z, q.w, w.x, w.y};
    }
    // ordered reduction: lane 0 ends with the later-after-earlier
    // composition of lanes 0 .. 31
    for (int d = 1; d < 32; d <<= 1) {
      const Aff2 other = shfl_down(m, d);
      if (lane + d < 32) m = compose(other, m);
    }
    acc = compose(shfl(m, 0), acc);
    if (stop < 32) {
      float p1 = s0_1, p2 = s0_2;
      if (lane == stop && j >= 0) {
        const float2 x =
            __ldcg(reinterpret_cast<const float2*>(&sc.rec[first + j].x1));
        p1 = x.x;
        p2 = x.y;
      }
      p1 = __shfl_sync(kFull, p1, stop);
      p2 = __shfl_sync(kFull, p2, stop);
      *x1 = acc.m11 * p1 + acc.m12 * p2 + acc.w1;
      *x2 = acc.m21 * p1 + acc.m22 * p2 + acc.w2;
      return;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    iir2_kernel(Streams2 s, const float* __restrict__ s0_1,
                const float* __restrict__ s0_2, float* __restrict__ out1,
                float* __restrict__ out2, float* scratch, long long t, int rows,
                int nseg, unsigned epoch) {
  extern __shared__ float4 iir2_smem4[];
  float* sm = reinterpret_cast<float*>(iir2_smem4);  // [6][kSeg], swizzled
  __shared__ int tile_sh;
  __shared__ float in_sh[2];
  const int tiles = rows * nseg;
  const Scratch sc = scratch_of(scratch, tiles);
  if (threadIdx.x == 0) {
    const unsigned ticket = atomicAdd(sc.counter, 1u);
    if (ticket == (unsigned)tiles - 1) atomicExch(sc.counter, 0u);  // next call
    tile_sh = (int)ticket;
  }
  __syncthreads();
  const int tile = tile_sh;
  const int row = tile / nseg, seg = tile % nseg;
  const long long base = (long long)row * t + (long long)seg * kSeg;
  const long long rest = t - (long long)seg * kSeg;
  const int len = rest < kSeg ? (int)rest : kSeg;
  const float* src[6] = {s.a11 + base, s.a12 + base, s.a21 + base,
                         s.a22 + base, s.b1 + base,  s.b2 + base};
  float* dst[2] = {out1 + base, out2 + base};
  bool vec = aligned16(dst[0]) && aligned16(dst[1]);
#pragma unroll
  for (int k = 0; k < 6; ++k) vec = vec && aligned16(src[k]);

  // stage the segment: 16-byte copies of whole groups where aligned
  const int vec_end = vec ? len & ~3 : 0;
  for (int p = 4 * threadIdx.x; p < vec_end; p += 4 * kThreads) {
#pragma unroll
    for (int k = 0; k < 6; ++k) cp_async16(sm + k * kSeg + swz(p), src[k] + p);
  }
  for (int p = vec_end + threadIdx.x; p < len; p += kThreads) {
#pragma unroll
    for (int k = 0; k < 6; ++k) cp_async4(sm + k * kSeg + swz(p), src[k] + p);
  }
  cp_async_wait_all();
  __syncthreads();

  // this thread's samples [lo, lo + cnt) of the segment, from zero state
  const int lo = threadIdx.x * kPer;
  const int cnt = len - lo < 0 ? 0 : (len - lo < kPer ? len - lo : kPer);
  Aff2 acc = identity(Aff2{});
#pragma unroll
  for (int g = 0; g < kPer / 4; ++g) {
    float4 v[6];
#pragma unroll
    for (int k = 0; k < 6; ++k)
      v[k] = *reinterpret_cast<const float4*>(sm + k * kSeg + swz(lo + 4 * g));
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (4 * g + e < cnt)
        acc = compose(acc, Aff2{elem(v[0], e), elem(v[1], e), elem(v[2], e),
                                elem(v[3], e), elem(v[4], e), elem(v[5], e)});
    }
  }
  Aff2 total;
  const Aff2 ex = block_exclusive_scan(acc, &total);

  // publish, look back, publish: the row's state entering this segment
  if (threadIdx.x < 32) {
    float x1 = s0_1[row], x2 = s0_2[row];
    const int slot = row * nseg + seg;
    if (seg > 0) {
      if (threadIdx.x == 0) {
        Record* r = sc.rec + slot;
        *reinterpret_cast<float4*>(r) = make_float4(total.m11, total.m12,
                                                    total.m21, total.m22);
        *reinterpret_cast<float2*>(&r->w1) = make_float2(total.w1, total.w2);
        st_release(sc.flags + slot, epoch << 2 | kAggregate);
      }
      look_back(sc, row * nseg, seg, epoch, x1, x2, &x1, &x2);
    }
    if (threadIdx.x == 0) {
      *reinterpret_cast<float2*>(&sc.rec[slot].x1) =
          make_float2(total.m11 * x1 + total.m12 * x2 + total.w1,
                      total.m21 * x1 + total.m22 * x2 + total.w2);
      st_release(sc.flags + slot, epoch << 2 | kInclusive);
      in_sh[0] = x1;
      in_sh[1] = x2;
    }
  }
  __syncthreads();

  // re-run this thread's samples from the exact incoming state
  float x1 = ex.m11 * in_sh[0] + ex.m12 * in_sh[1] + ex.w1;
  float x2 = ex.m21 * in_sh[0] + ex.m22 * in_sh[1] + ex.w2;
  float o1[kPer], o2[kPer];
#pragma unroll
  for (int g = 0; g < kPer / 4; ++g) {
    float4 v[6];
#pragma unroll
    for (int k = 0; k < 6; ++k)
      v[k] = *reinterpret_cast<const float4*>(sm + k * kSeg + swz(lo + 4 * g));
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float n1 = elem(v[0], e) * x1 + elem(v[1], e) * x2 + elem(v[4], e);
      const float n2 = elem(v[2], e) * x1 + elem(v[3], e) * x2 + elem(v[5], e);
      x1 = n1;  // past cnt these run on stale data and are never stored
      x2 = n2;
      o1[4 * g + e] = x1;
      o2[4 * g + e] = x2;
    }
  }
  __syncthreads();  // every thread is done reading the staged streams
#pragma unroll
  for (int g = 0; g < kPer / 4; ++g) {
    const int q = swz(lo + 4 * g);
    *reinterpret_cast<float4*>(sm + q) =
        make_float4(o1[4 * g], o1[4 * g + 1], o1[4 * g + 2], o1[4 * g + 3]);
    *reinterpret_cast<float4*>(sm + kSeg + q) =
        make_float4(o2[4 * g], o2[4 * g + 1], o2[4 * g + 2], o2[4 * g + 3]);
  }
  __syncthreads();
  for (int p = 4 * threadIdx.x; p < vec_end; p += 4 * kThreads) {
#pragma unroll
    for (int k = 0; k < 2; ++k)
      *reinterpret_cast<float4*>(dst[k] + p) =
          *reinterpret_cast<const float4*>(sm + k * kSeg + swz(p));
  }
  for (int p = vec_end + threadIdx.x; p < len; p += kThreads) {
#pragma unroll
    for (int k = 0; k < 2; ++k) dst[k][p] = sm[k * kSeg + swz(p)];
  }
}

constexpr size_t kIir2Smem = sizeof(float) * 6 * kSeg;

int segments(long long t) { return (int)((t + kSeg - 1) / kSeg); }

}  // namespace

// Scratch floats the caller allocates for iir1 over [rows, t].
extern "C" long long phonic_iir1_scratch(int rows, long long t) {
  return (long long)rows * segments(t) * 2;
}
// 32-bit words of the scratch iir2 keeps between calls over [rows, t]: the
// tile counter, a flag and a record per segment.  Zeroed once when
// allocated; each call then passes a new epoch in [1, 2**30).
extern "C" long long phonic_iir2_scratch(int rows, long long t) {
  const long long tiles = (long long)rows * segments(t);
  return 4 + ((tiles + 3) & ~3LL) + tiles * (long long)(sizeof(Record) / 4);
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
                           unsigned epoch, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(iir2_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kIir2Smem);
  if (err != cudaSuccess) return (int)err;
  const int nseg = segments(t);
  const Streams2 s = {a11, a12, a21, a22, b1, b2};
  iir2_kernel<<<rows * nseg, kThreads, kIir2Smem, (cudaStream_t)stream>>>(
      s, s0_1, s0_2, out1, out2, scratch, t, rows, nseg, epoch);
  return (int)cudaGetLastError();
}

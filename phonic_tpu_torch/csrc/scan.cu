// Time-varying first- and second-order linear recurrences (kernels 3, 2).
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
// What bounds it here: the render paths' streams are tall and thin (R = 2..8
// rows, T = 8192..131072).  A loop with one thread per row would occupy a
// few SMs of 132 and serialise T dependent steps.  Spread over the card, the
// work is memory-bound: iir1 reads two floats and writes one per element,
// iir2 reads six and writes two.  At the small shapes (iir1 and iir2 at R=2,
// T=8192, 16 calls each per mastering block) a call costs the latency of
// its launches, so each call is one launch.
//
// Design, one kernel body for both (scan_body, templated on the affine map:
// Aff1 for iir1, Aff2 for iir2): a single-pass chained scan with decoupled
// look-back (Merrill and Garland, "Single-pass Parallel Prefix Scan with
// Decoupled Look-back", 2016).  A row is cut into segments of kSeg = 4096
// samples, one block each (for iir1, 8192-sample segments measured equal
// at R=2, T=8192 and slower at R=2, T=131072, where they leave half the
// blocks; PERF.md).  Each block takes its (row, segment) from an
// atomic ticket counter, in row-major order, so a segment's predecessors
// were handed to blocks that are resident or finished.  It stages its
// segment of every input stream into shared memory (16-byte cp.async where
// the row start is 16-byte aligned, 4-byte copies for other rows and the
// ragged end), so each stream is read from device memory once, with
// coalesced loads; each thread then reads its 16 consecutive samples as
// float4s, through a swizzle that keeps those reads free of bank
// conflicts.  A thread runs its
// samples from zero state, keeping the particular solution w and the
// cumulative coefficient product P (for iir2 a 2x2 matrix carried as four
// scalars); a block scan (warp shuffles, then shared memory) composes them
// into each thread's offset within the segment and the segment's affine map
// s_out = P s_in + w.  Composition is "later after earlier" (A_r A_l,
// A_r b_l + b_r), as in pallas_scan.py:94-108; there is no time padding
// (loops stop at T), which is the A = I, b = 0 padding of
// pallas_scan.py:226-229.  The block publishes its segment's map
// ("aggregate"), and warp 0 looks back over the predecessors 32 at a time:
// it composes the aggregates of those that have one up to the nearest that
// has published its inclusive state (the row's state after it), spinning
// only while a nearer one has published nothing yet.  The block publishes
// its own inclusive state, re-runs its samples from the exact incoming
// state, writing each output over its own input slot in shared memory, and
// stores the outputs with coalesced stores.  A row of one segment looks
// back at nothing.
//
// Scratch, kept by the wrapper per kernel, device and stream: flags carry a
// per-call epoch, so flags and records are never cleared between calls; the
// last block to take a ticket resets the tile counter.  The flags sit at
// the front of the buffer and the records at its end, so no flag word this
// call reads was ever written as part of a record by a call of another
// shape (a record's float bits could equal a later epoch).
//
// Association order: both kernels compose in another order than either JAX
// path, so float32 results agree to rounding, not bit for bit.

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
// the state a map acts on
template <int N>
struct Vec {
  float v[N];
};

__device__ __forceinline__ float elem(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// Per map type: the staged input streams, the state (= output streams), and
// the map of sample e of a group of four from the staged inputs.
template <class A>
struct Traits;
template <>
struct Traits<Aff1> {
  static constexpr int kIn = 2, kN = 1;  // a, b -> y
  static __device__ __forceinline__ Aff1 at(const float4* v, int e) {
    return {elem(v[0], e), elem(v[1], e)};
  }
};
template <>
struct Traits<Aff2> {
  static constexpr int kIn = 6, kN = 2;  // a11, a12, a21, a22, b1, b2 -> s1, s2
  static __device__ __forceinline__ Aff2 at(const float4* v, int e) {
    return {elem(v[0], e), elem(v[1], e), elem(v[2], e),
            elem(v[3], e), elem(v[4], e), elem(v[5], e)};
  }
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

__device__ __forceinline__ Vec<1> apply(const Aff1& m, const Vec<1>& x) {
  return {{m.p * x.v[0] + m.w}};
}
__device__ __forceinline__ Vec<2> apply(const Aff2& m, const Vec<2>& x) {
  return {{m.m11 * x.v[0] + m.m12 * x.v[1] + m.w1,
           m.m21 * x.v[0] + m.m22 * x.v[1] + m.w2}};
}

__device__ __forceinline__ Aff1 shfl_up(const Aff1& x, int d) {
  return {__shfl_up_sync(kFull, x.p, d), __shfl_up_sync(kFull, x.w, d)};
}
__device__ __forceinline__ Aff2 shfl_up(const Aff2& x, int d) {
  return {__shfl_up_sync(kFull, x.m11, d), __shfl_up_sync(kFull, x.m12, d),
          __shfl_up_sync(kFull, x.m21, d), __shfl_up_sync(kFull, x.m22, d),
          __shfl_up_sync(kFull, x.w1, d),  __shfl_up_sync(kFull, x.w2, d)};
}
__device__ __forceinline__ Aff1 shfl_down(const Aff1& x, int d) {
  return {__shfl_down_sync(kFull, x.p, d), __shfl_down_sync(kFull, x.w, d)};
}
__device__ __forceinline__ Aff2 shfl_down(const Aff2& x, int d) {
  return {__shfl_down_sync(kFull, x.m11, d), __shfl_down_sync(kFull, x.m12, d),
          __shfl_down_sync(kFull, x.m21, d), __shfl_down_sync(kFull, x.m22, d),
          __shfl_down_sync(kFull, x.w1, d),  __shfl_down_sync(kFull, x.w2, d)};
}
__device__ __forceinline__ Aff1 shfl(const Aff1& x, int src) {
  return {__shfl_sync(kFull, x.p, src), __shfl_sync(kFull, x.w, src)};
}
__device__ __forceinline__ Aff2 shfl(const Aff2& x, int src) {
  return {__shfl_sync(kFull, x.m11, src), __shfl_sync(kFull, x.m12, src),
          __shfl_sync(kFull, x.m21, src), __shfl_sync(kFull, x.m22, src),
          __shfl_sync(kFull, x.w1, src),  __shfl_sync(kFull, x.w2, src)};
}
template <int N>
__device__ __forceinline__ Vec<N> shfl(Vec<N> x, int src) {
#pragma unroll
  for (int i = 0; i < N; ++i) x.v[i] = __shfl_sync(kFull, x.v[i], src);
  return x;
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

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Look-back state of one (row, segment): a flag word (epoch << 2 | status)
// and a record of the segment's map and its inclusive state.
constexpr unsigned kAggregate = 1;  // the map is published
constexpr unsigned kInclusive = 2;  // the state after the segment too
template <class A>
struct alignas(16) Record {
  A m;
  Vec<Traits<A>::kN> x;
};

// records are read from L2 (another block wrote them), as vectors
__device__ __forceinline__ Aff1 ld_map(const Aff1* p) {
  const float2 q = __ldcg(reinterpret_cast<const float2*>(p));
  return {q.x, q.y};
}
__device__ __forceinline__ Aff2 ld_map(const Aff2* p) {
  const float4 q = __ldcg(reinterpret_cast<const float4*>(p));
  const float2 w = __ldcg(reinterpret_cast<const float2*>(&p->w1));
  return {q.x, q.y, q.z, q.w, w.x, w.y};
}
template <int N>
__device__ __forceinline__ Vec<N> ld_state(const Vec<N>* p) {
  Vec<N> x;
#pragma unroll
  for (int i = 0; i < N; ++i) x.v[i] = __ldcg(p->v + i);
  return x;
}

template <class A>
struct Scratch {
  unsigned* counter;  // tile tickets handed out in this launch
  unsigned* flags;    // [tiles], from word 4
  Record<A>* rec;     // [tiles], ending at the buffer's last word
};

// `words` (a multiple of 4) is the whole buffer's size, at least
// scratch_words<A>(tiles).  For any two calls whose tiles fit the buffer,
// the earlier call's records end above the later call's flags.
template <class A>
__device__ __forceinline__ Scratch<A> scratch_of(float* base, long long words,
                                                 int tiles) {
  unsigned* w = reinterpret_cast<unsigned*>(base);
  return {w, w + 4, reinterpret_cast<Record<A>*>(w + words) - tiles};
}

template <class A>
long long scratch_words(long long tiles) {
  return 4 + ((tiles + 3) & ~3LL) + tiles * (long long)(sizeof(Record<A>) / 4);
}

// Warp 0: the row's state entering segment `seg` (> 0) of the row whose
// first segment's slot is `first`, from the row's initial state s0.  Every
// lane returns it.
template <class A>
__device__ Vec<Traits<A>::kN> look_back(const Scratch<A>& sc, int first,
                                        int seg, unsigned epoch,
                                        const Vec<Traits<A>::kN>& s0) {
  const int lane = threadIdx.x & 31;
  A acc = identity(A{});  // the segments after this window, composed
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
    A m = identity(A{});
    if (lane < stop) m = ld_map(&sc.rec[first + j].m);
    // ordered reduction: lane 0 ends with the later-after-earlier
    // composition of lanes 0 .. 31
    for (int d = 1; d < 32; d <<= 1) {
      const A other = shfl_down(m, d);
      if (lane + d < 32) m = compose(other, m);
    }
    acc = compose(shfl(m, 0), acc);
    if (stop < 32) {
      Vec<Traits<A>::kN> p = s0;
      if (lane == stop && j >= 0) p = ld_state(&sc.rec[first + j].x);
      return apply(acc, shfl(p, stop));
    }
  }
}

// The kernel's streams: kIn inputs [R, T], kN initial states [R] and kN
// outputs [R, T].
template <class A>
struct Io {
  const float* in[Traits<A>::kIn];
  const float* s0[Traits<A>::kN];
  float* out[Traits<A>::kN];
};

template <class A>
__device__ __forceinline__ void scan_body(const Io<A>& io, float* scratch,
                                          long long words, long long t,
                                          int rows, int nseg, unsigned epoch) {
  constexpr int kIn = Traits<A>::kIn, kN = Traits<A>::kN;
  extern __shared__ float4 scan_smem4[];
  float* sm = reinterpret_cast<float*>(scan_smem4);  // [kIn][kSeg], swizzled
  __shared__ int tile_sh;
  __shared__ float in_sh[kN];
  const int tiles = rows * nseg;
  const Scratch<A> sc = scratch_of<A>(scratch, words, tiles);
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
  bool vec = true;
#pragma unroll
  for (int k = 0; k < kIn; ++k) vec = vec && aligned16(io.in[k] + base);
#pragma unroll
  for (int k = 0; k < kN; ++k) vec = vec && aligned16(io.out[k] + base);

  // stage the segment: 16-byte copies of whole groups where aligned
  const int vec_end = vec ? len & ~3 : 0;
  for (int p = 4 * threadIdx.x; p < vec_end; p += 4 * kThreads) {
#pragma unroll
    for (int k = 0; k < kIn; ++k)
      cp_async16(sm + k * kSeg + swz(p), io.in[k] + base + p);
  }
  for (int p = vec_end + threadIdx.x; p < len; p += kThreads) {
#pragma unroll
    for (int k = 0; k < kIn; ++k)
      cp_async4(sm + k * kSeg + swz(p), io.in[k] + base + p);
  }
  cp_async_wait_all();
  __syncthreads();

  // this thread's samples [lo, lo + cnt) of the segment, from zero state
  const int lo = threadIdx.x * kPer;
  const int cnt = len - lo < 0 ? 0 : (len - lo < kPer ? len - lo : kPer);
  A acc = identity(A{});
#pragma unroll
  for (int g = 0; g < kPer / 4; ++g) {
    float4 v[kIn];
#pragma unroll
    for (int k = 0; k < kIn; ++k)
      v[k] = *reinterpret_cast<const float4*>(sm + k * kSeg + swz(lo + 4 * g));
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (4 * g + e < cnt) acc = compose(acc, Traits<A>::at(v, e));
  }
  A total;
  const A ex = block_exclusive_scan(acc, &total);

  // publish, look back, publish: the row's state entering this segment
  if (threadIdx.x < 32) {
    Vec<kN> x;
#pragma unroll
    for (int k = 0; k < kN; ++k) x.v[k] = io.s0[k][row];
    const int slot = row * nseg + seg;
    if (seg > 0) {
      if (threadIdx.x == 0) {
        Record<A>* r = sc.rec + slot;
        r->m = total;
        st_release(sc.flags + slot, epoch << 2 | kAggregate);
      }
      x = look_back(sc, row * nseg, seg, epoch, x);
    }
    if (threadIdx.x == 0) {
      sc.rec[slot].x = apply(total, x);
      st_release(sc.flags + slot, epoch << 2 | kInclusive);
#pragma unroll
      for (int k = 0; k < kN; ++k) in_sh[k] = x.v[k];
    }
  }
  __syncthreads();

  // re-run this thread's samples from the exact incoming state; output k
  // goes over input k's slot, which no other thread reads
  Vec<kN> x;
#pragma unroll
  for (int k = 0; k < kN; ++k) x.v[k] = in_sh[k];
  x = apply(ex, x);
#pragma unroll
  for (int g = 0; g < kPer / 4; ++g) {
    const int q = swz(lo + 4 * g);
    float4 v[kIn];
#pragma unroll
    for (int k = 0; k < kIn; ++k)
      v[k] = *reinterpret_cast<const float4*>(sm + k * kSeg + q);
    float o[kN][4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      // past cnt this runs on stale data that is never stored
      x = apply(Traits<A>::at(v, e), x);
#pragma unroll
      for (int k = 0; k < kN; ++k) o[k][e] = x.v[k];
    }
#pragma unroll
    for (int k = 0; k < kN; ++k)
      *reinterpret_cast<float4*>(sm + k * kSeg + q) =
          make_float4(o[k][0], o[k][1], o[k][2], o[k][3]);
  }
  __syncthreads();
  for (int p = 4 * threadIdx.x; p < vec_end; p += 4 * kThreads) {
#pragma unroll
    for (int k = 0; k < kN; ++k)
      *reinterpret_cast<float4*>(io.out[k] + base + p) =
          *reinterpret_cast<const float4*>(sm + k * kSeg + swz(p));
  }
  for (int p = vec_end + threadIdx.x; p < len; p += kThreads) {
#pragma unroll
    for (int k = 0; k < kN; ++k) io.out[k][base + p] = sm[k * kSeg + swz(p)];
  }
}

__global__ void __launch_bounds__(kThreads)
    iir1_kernel(Io<Aff1> io, float* scratch, long long words, long long t,
                int rows, int nseg, unsigned epoch) {
  scan_body(io, scratch, words, t, rows, nseg, epoch);
}

__global__ void __launch_bounds__(kThreads)
    iir2_kernel(Io<Aff2> io, float* scratch, long long words, long long t,
                int rows, int nseg, unsigned epoch) {
  scan_body(io, scratch, words, t, rows, nseg, epoch);
}

int segments(long long t) { return (int)((t + kSeg - 1) / kSeg); }

template <class A>
int launch(void (*kernel)(Io<A>, float*, long long, long long, int, int,
                          unsigned),
           int device, const Io<A>& io, float* scratch, long long words,
           int rows, long long t, unsigned epoch, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = sizeof(float) * Traits<A>::kIn * kSeg;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int nseg = segments(t);
  kernel<<<rows * nseg, kThreads, smem, (cudaStream_t)stream>>>(
      io, scratch, words, t, rows, nseg, epoch);
  return (int)cudaGetLastError();
}

}  // namespace

// 32-bit words of the scratch each kernel keeps between calls over [rows, t]:
// the tile counter, a flag and a record per segment.  Zeroed once when
// allocated; each call then passes a new epoch in [1, 2**30) and the
// buffer's size in words.
extern "C" long long phonic_iir1_scratch(int rows, long long t) {
  return scratch_words<Aff1>((long long)rows * segments(t));
}
extern "C" long long phonic_iir2_scratch(int rows, long long t) {
  return scratch_words<Aff2>((long long)rows * segments(t));
}

extern "C" int phonic_iir1(int device, const float* a, const float* b,
                           const float* y0, float* out, float* scratch,
                           long long words, int rows, long long t,
                           unsigned epoch, void* stream) {
  const Io<Aff1> io = {{a, b}, {y0}, {out}};
  return launch(iir1_kernel, device, io, scratch, words, rows, t, epoch,
                stream);
}

extern "C" int phonic_iir2(int device, const float* a11, const float* a12,
                           const float* a21, const float* a22, const float* b1,
                           const float* b2, const float* s0_1, const float* s0_2,
                           float* out1, float* out2, float* scratch,
                           long long words, int rows, long long t,
                           unsigned epoch, void* stream) {
  const Io<Aff2> io = {{a11, a12, a21, a22, b1, b2}, {s0_1, s0_2}, {out1, out2}};
  return launch(iir2_kernel, device, io, scratch, words, rows, t, epoch,
                stream);
}

// Parameter smoothers over a block (kernel 6): one launch renders one
// smoother group's block, every row's values [R, n] and its new state.
//
//   exponential  cur -> tgt + (cur - tgt) (1 - alpha)^j, frozen once the
//                step falls below eps (the output is then the target)
//   linear       fixed signed steps, the last one snapping to the target
//   spring       critically damped, the closed form M^j (v, c - t) of the
//                2x2 update on (velocity, error)
//   step         stepped targets, or linear glides where an event is
//                flagged as a ramp
//
// A block's events split each row into at most K + 1 segments (K event
// slots; a slot whose time is >= n is masked and carries the previous
// target).  The state runs serially over the segments; inside a segment
// every sample is a closed-form function of its index in the segment.
//
// Replaces no TPU kernel: the JAX package's smoothers are plain jnp
// (phonic_tpu/ops/smoothing.py), which XLA fuses into one program.  The
// port's plain version (phonic_tpu_torch/ops/smoothing.py) issues 10-20
// elementwise operations per segment slot on [R] rows and ~10 more per live
// segment on [R, n], some 900-2,000 launches per block over a graph's
// groups, each costing host time in the engine's launch loop.  This kernel
// does the same work in one launch per group.
//
// What bounds it here: the writes, 4 bytes per sample (80 MB for the
// mastering lanes' 152 exponential rows at 131072 samples, ~25 us at 3.35
// TB/s), and the per-sample transcendental (one expf per exponential
// sample, two expf and a powf per spring sample).  The serial propagation
// is at most K + 1 = 17 steps of a few operations per row.
//
// Design: a grid of (row, tile of kTile samples).  Thread 0 of each block
// redoes its row's propagation over the segments into shared memory (cheap
// beside the tile's samples, and it keeps the launch single); the tile-0
// block of each row also writes the row's new state.  Then every thread
// evaluates its samples: it finds the sample's segment among the live
// ones, evaluates the segment's closed form, and the block stores the tile
// as float4 (scalar stores where n is not a multiple of 4).  Rows whose
// state or events are shared by several lanes read them by index (row %
// state_rows, row % event_rows) instead of a widened copy.
//
// Arithmetic: every operation of the plain version, in its order, each
// rounded to float32 once: __fadd_rn / __fsub_rn / __fmul_rn / __fdiv_rn
// keep nvcc from contracting a multiply and an add into an FMA, and the
// transcendentals are the same CUDA math functions PyTorch's elementwise
// kernels call (expf, logf, log1pf, powf, ceilf, nearbyintf for
// torch.round), with PyTorch's NaN rules for clamp and minimum.  Scalars
// the plain version takes from Python are rounded to float32 on the host
// as PyTorch rounds them.  So on the card the kernel agrees with the plain
// version bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "device_guard.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 2048;  // samples per block: 8 per thread
constexpr int kMaxSegs = 65;  // K + 1: at most 64 event slots
constexpr int kParams = 12;

enum Kind { kExp = 0, kLin = 1, kSpring = 2, kStep = 3 };

struct Params {
  float p[kParams];
};

// exponential: alpha, eps, tiny
// spring: l1, l2, inv_dl, m11 - l2, m12, m21, m22 - l2, m11 - l1,
//         m22 - l1, eps, tiny, l1 > 0
enum { kAlpha = 0, kExpEps = 1, kExpTiny = 2 };
enum {
  kL1 = 0, kL2, kInvDl, kM11L2, kM12, kM21, kM22L2, kM11L1, kM22L1,
  kSpEps, kSpTiny, kL1Pos
};

// PyTorch's clamp(v, min=lo), minimum and clamp(v, lo, hi): NaN passes
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float minimum(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
__device__ __forceinline__ float clamp01(float v) {
  return isnan(v) ? v : fminf(fmaxf(v, 0.0f), 1.0f);
}

// one row's segments, built by thread 0
struct Segs {
  float start[kMaxSegs];  // float(segment start), float(segment end)
  float end[kMaxSegs];
  float tgt[kMaxSegs];
  float a[kMaxSegs];  // per kind: exp (cur0 - tgt, n_freeze);
  float b[kMaxSegs];  // lin (cur0, pending, step); spring (a_v, a_e,
  float c[kMaxSegs];  // b_v, b_e); step (d, prev_t, 1/span, t, ramp)
  float d[kMaxSegs];
  float e[kMaxSegs];
  float k[4];  // per-kind constants computed on the card
};

// _exp_steps_to_freeze: ramp steps until |delta| alpha (1-alpha)^j <= eps
__device__ __forceinline__ float steps_to_freeze(float delta, float alpha,
                                                 float log1ma, float eps,
                                                 float tiny) {
  const float ad = __fmul_rn(alpha, fabsf(delta));
  // eps / clamp(ad) is reciprocal(clamp(ad)) * eps in PyTorch
  const float r = __fmul_rn(__fdiv_rn(1.0f, clamp_min(ad, tiny)), eps);
  const float nf = ceilf(__fdiv_rn(logf(clamp_min(r, tiny)), log1ma));
  return ad <= eps ? 0.0f : clamp_min(nf, 0.0f);
}

// the spring's (v_p, e_p) = M^p (v0, e0), from the segment's a_v, a_e,
// b_v, b_e; k = (log l1, sign l2, log(|l2| + tiny))
__device__ __forceinline__ void spring_pow(const Params& P, const float* k,
                                           float p, float av, float ae,
                                           float bv, float be, float* v,
                                           float* e) {
  const float l1p = P.p[kL1Pos] != 0.0f ? expf(__fmul_rn(k[0], p))
                                        : powf(P.p[kL1], p);
  const float l2p = __fmul_rn(powf(k[1], p), expf(__fmul_rn(k[2], p)));
  const float c1 = __fmul_rn(l1p, P.p[kInvDl]);
  const float c2 = __fmul_rn(l2p, P.p[kInvDl]);
  *v = __fsub_rn(__fmul_rn(c1, av), __fmul_rn(c2, bv));
  *e = __fsub_rn(__fmul_rn(c1, ae), __fmul_rn(c2, be));
}

template <class T>
struct Args {
  const T* times;       // [E, K]
  const float* values;  // [E, K]
  const float* ramps;   // [E, K], the step kind only
  const float* st[4];   // state fields, [S] each
  float* st_out;        // [F, R]
  float* out;           // [R, n]
  int state_rows, event_rows, rows, k, live;
  long long n;
};

// Thread 0: the row's propagation over its K + 1 segments (all of them,
// as the plain version: a masked slot's zero-length segment still rounds
// the state), into shared memory, and the new state if write_state.
template <int KIND, class T>
__device__ void propagate(const Args<T>& a, const Params& P, int row,
                          bool write_state, Segs& sg) {
  const int rs = row % a.state_rows;
  const T* t = a.times + (size_t)(row % a.event_rows) * a.k;
  const float* v = a.values + (size_t)(row % a.event_rows) * a.k;
  const T n = (T)a.n;
  const int K = a.k;
  const int R = a.rows;
  if (KIND == kStep) {
    // step_targets: value deltas d_k, previous event time, 1 / span
    float carry = a.st[0][rs];
    const float* rp = a.ramps + (size_t)(row % a.event_rows) * K;
    for (int q = 0; q < K; ++q) {
      const T tq = t[q];
      const T pt = q == 0 ? (T)0 : t[q - 1];
      const float nv = tq < n ? v[q] : carry;
      sg.a[q] = __fsub_rn(nv, carry);
      carry = nv;
      sg.b[q] = (float)pt;
      const T span = tq - pt;
      sg.c[q] = __fdiv_rn(1.0f, (float)(span < (T)1 ? (T)1 : span));
      sg.d[q] = (float)tq;
      sg.e[q] = rp[q] > 0.0f ? 1.0f : 0.0f;
    }
    sg.k[0] = a.st[0][rs];
    if (write_state) a.st_out[row] = carry;
    return;
  }
  float cur = a.st[0][rs];
  float tgt = KIND == kSpring ? a.st[2][rs] : a.st[1][rs];
  // exponential: log(1 - alpha); linear: |step|, step, pending; spring:
  // velocity
  float log1ma = 0.0f, mag = 0.0f, sgn = 0.0f, pend = 0.0f, vel = 0.0f;
  if (KIND == kExp) log1ma = log1pf(-P.p[kAlpha]);
  if (KIND == kLin) {
    sgn = a.st[2][rs];
    pend = a.st[3][rs];
    mag = fabsf(sgn);
  }
  if (KIND == kSpring) {
    vel = a.st[1][rs];
    sg.k[0] = logf(P.p[kL1]);
    const float l2 = P.p[kL2];
    sg.k[1] = (float)((0.0f < l2) - (l2 < 0.0f));  // torch.sign
    sg.k[2] = logf(__fadd_rn(fabsf(l2), P.p[kSpTiny]));
  }
  for (int s = 0; s <= K; ++s) {
    const T start = s == 0 ? (T)0 : t[s - 1];
    const T end = s < K ? t[s] : n;
    const bool valid = start < n;
    if (s > 0 && valid) tgt = v[s - 1];
    const bool is_ev = s > 0 && valid;
    const float len = (float)(end - start);
    sg.start[s] = (float)start;
    sg.end[s] = (float)end;
    sg.tgt[s] = tgt;
    if (KIND == kExp) {
      const float nf = steps_to_freeze(__fsub_rn(cur, tgt), P.p[kAlpha],
                                       log1ma, P.p[kExpEps], P.p[kExpTiny]);
      if (is_ev && nf == 0.0f) cur = tgt;
      const float steps = minimum(len, nf);
      const float diff = __fsub_rn(cur, tgt);
      sg.a[s] = diff;
      sg.b[s] = nf;
      cur = __fadd_rn(tgt, __fmul_rn(diff, expf(__fmul_rn(log1ma, steps))));
    } else if (KIND == kLin) {
      if (is_ev) {  // set_target: a new signed step and pending count
        const float ns = cur > tgt ? -mag : mag;
        sgn = ns;
        pend = clamp_min(nearbyintf(__fdiv_rn(__fsub_rn(tgt, cur), ns)),
                         0.0f);
      }
      if (is_ev && pend == 0.0f) cur = tgt;
      sg.a[s] = cur;
      sg.b[s] = pend;
      sg.c[s] = sgn;
      const float steps = minimum(len, pend);
      cur = (steps >= pend && pend > 0.0f)
                ? tgt
                : __fadd_rn(cur, __fmul_rn(sgn, steps));
      pend = __fsub_rn(pend, steps);
    } else {  // spring: set_target keeps the velocity
      const float e0 = __fsub_rn(cur, tgt);
      const float av = __fadd_rn(__fmul_rn(P.p[kM11L2], vel),
                                 __fmul_rn(P.p[kM12], e0));
      const float ae = __fadd_rn(__fmul_rn(P.p[kM21], vel),
                                 __fmul_rn(P.p[kM22L2], e0));
      const float bv = __fadd_rn(__fmul_rn(P.p[kM11L1], vel),
                                 __fmul_rn(P.p[kM12], e0));
      const float be = __fadd_rn(__fmul_rn(P.p[kM21], vel),
                                 __fmul_rn(P.p[kM22L1], e0));
      sg.a[s] = av;
      sg.b[s] = ae;
      sg.c[s] = bv;
      sg.d[s] = be;
      float e_end;
      spring_pow(P, sg.k, len, av, ae, bv, be, &vel, &e_end);
      cur = __fadd_rn(tgt, e_end);
    }
  }
  if (!write_state) return;
  a.st_out[row] = cur;
  if (KIND == kExp) {
    a.st_out[R + row] = tgt;
  } else if (KIND == kLin) {
    a.st_out[R + row] = tgt;
    a.st_out[2 * R + row] = sgn;
    a.st_out[3 * R + row] = pend;
  } else {
    a.st_out[R + row] = vel;
    a.st_out[2 * R + row] = tgt;
  }
}

// Sample i's value (the plain version's _per_sample: the last live
// segment whose [start, end) holds i, else segment 0 up to its end, else
// 0), or for the step kind the sum over the live events in their order.
template <int KIND>
__device__ __forceinline__ float value(const Segs& sg, const Params& P,
                                       int live, long long i) {
  const float fi = (float)i;
  if (KIND == kStep) {
    float val = sg.k[0];
    for (int q = 0; q < live - 1; ++q) {
      const float ramp_g = clamp01(__fmul_rn(__fsub_rn(fi, sg.b[q]), sg.c[q]));
      const float jump_g = fi >= sg.d[q] ? 1.0f : 0.0f;
      val = __fadd_rn(val, __fmul_rn(sg.a[q], sg.e[q] > 0.0f ? ramp_g : jump_g));
    }
    return val;
  }
  int s = -1;
  float j1 = 0.0f;
  for (int q = live - 1; q >= 1; --q) {
    const float jq = __fadd_rn(__fsub_rn(fi, sg.start[q]), 1.0f);
    if (jq > 0.0f && fi < sg.end[q]) {
      s = q;
      j1 = jq;
      break;
    }
  }
  if (s < 0) {
    if (!(fi < sg.end[0])) return 0.0f;
    s = 0;
    j1 = __fadd_rn(__fsub_rn(fi, sg.start[0]), 1.0f);
  }
  const float tgt = sg.tgt[s];
  if (KIND == kExp) {
    const float ramped = __fadd_rn(
        tgt, __fmul_rn(sg.a[s], expf(__fmul_rn(sg.k[0], clamp_min(j1, 0.0f)))));
    return j1 <= sg.b[s] ? ramped : tgt;
  } else if (KIND == kLin) {
    return j1 < sg.b[s] ? __fadd_rn(sg.a[s], __fmul_rn(sg.c[s], j1)) : tgt;
  } else {
    float vj, ej;
    spring_pow(P, sg.k, clamp_min(j1, 0.0f), sg.a[s], sg.b[s], sg.c[s],
               sg.d[s], &vj, &ej);
    const float eps = P.p[kSpEps];
    const bool settled = fabsf(vj) <= eps && fabsf(ej) <= eps;
    return settled ? tgt : __fadd_rn(tgt, ej);
  }
}

template <int KIND, class T>
__global__ void __launch_bounds__(kThreads)
    smooth_kernel(Args<T> a, Params P) {
  __shared__ Segs sg;
  const int row = blockIdx.x;
  if (threadIdx.x == 0) {
    propagate<KIND, T>(a, P, row, blockIdx.y == 0, sg);
    if (KIND == kExp) sg.k[0] = log1pf(-P.p[kAlpha]);
  }
  __syncthreads();
  const long long n = a.n;
  const long long base = (long long)blockIdx.y * kTile;
  float* orow = a.out + (size_t)row * n;
  const int live = a.live;
  if ((n & 3) == 0) {
#pragma unroll
    for (int j = 0; j < kTile / (4 * kThreads); ++j) {
      const long long i = base + 4 * (threadIdx.x + j * kThreads);
      if (i >= n) break;
      float4 out;
      out.x = value<KIND>(sg, P, live, i);
      out.y = value<KIND>(sg, P, live, i + 1);
      out.z = value<KIND>(sg, P, live, i + 2);
      out.w = value<KIND>(sg, P, live, i + 3);
      *reinterpret_cast<float4*>(orow + i) = out;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kTile / kThreads; ++j) {
      const long long i = base + threadIdx.x + j * kThreads;
      if (i < n) orow[i] = value<KIND>(sg, P, live, i);
    }
  }
}

template <int KIND, class T>
cudaError_t launch(const Args<T>& a, const Params& P, cudaStream_t stream) {
  // at least one tile, so that a block of 0 samples still writes the state
  const long long tiles = a.n > 0 ? (a.n + kTile - 1) / kTile : 1;
  const dim3 grid(a.rows, (unsigned)tiles);
  smooth_kernel<KIND, T><<<grid, kThreads, 0, stream>>>(a, P);
  return cudaGetLastError();
}

template <class T>
cudaError_t dispatch(int kind, const Args<T>& a, const Params& P,
                     cudaStream_t stream) {
  switch (kind) {
    case kExp: return launch<kExp, T>(a, P, stream);
    case kLin: return launch<kLin, T>(a, P, stream);
    case kSpring: return launch<kSpring, T>(a, P, stream);
    case kStep: return launch<kStep, T>(a, P, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <class T>
Args<T> args(const void* times, const float* values, const float* ramps,
             const float* st0, const float* st1, const float* st2,
             const float* st3, float* st_out, float* out, int state_rows,
             int event_rows, int rows, int k, long long n, int live) {
  Args<T> a;
  a.times = static_cast<const T*>(times);
  a.values = values;
  a.ramps = ramps;
  a.st[0] = st0;
  a.st[1] = st1;
  a.st[2] = st2;
  a.st[3] = st3;
  a.st_out = st_out;
  a.out = out;
  a.state_rows = state_rows;
  a.event_rows = event_rows;
  a.rows = rows;
  a.k = k;
  a.live = live;
  a.n = n;
  return a;
}

}  // namespace

// kind: 0 exponential, 1 linear, 2 spring, 3 step.  times int32 or int64
// (times64) [event_rows, k]; values, ramps float32 [event_rows, k]; the
// state's fields [state_rows] each in the order of the Python NamedTuple;
// st_out [fields, rows]; out [rows, n]; params: kParams host floats.
// Row r reads state row r % state_rows and event row r % event_rows.
extern "C" int phonic_smooth(int device, int kind, int times64,
                             const void* times, const float* values,
                             const float* ramps, const float* st0,
                             const float* st1, const float* st2,
                             const float* st3, float* st_out, float* out,
                             int state_rows, int event_rows, int rows, int k,
                             long long n, int live, const float* params,
                             void* stream) {
  if (k < 0 || k + 1 > kMaxSegs || live < 1 || live > k + 1 || rows < 1 ||
      state_rows < 1 || event_rows < 1 || n < 0 ||
      (n + kTile - 1) / kTile > 65535)
    return cudaErrorInvalidValue;
  DeviceGuard on(device);
  if (on.err != cudaSuccess) return (int)on.err;
  Params P;
  for (int i = 0; i < kParams; ++i) P.p[i] = params[i];
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (times64)
    return dispatch<long long>(
        kind, args<long long>(times, values, ramps, st0, st1, st2, st3, st_out,
                              out, state_rows, event_rows, rows, k, n, live),
        P, s);
  return dispatch<int>(
      kind, args<int>(times, values, ramps, st0, st1, st2, st3, st_out, out,
                      state_rows, event_rows, rows, k, n, live),
      P, s);
}

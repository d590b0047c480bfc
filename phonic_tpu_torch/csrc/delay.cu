// The feedback delay's block in one launch (kernel 7).
//
// DelayEffect (effects/delay.py) feeds its line back through a state
// variable filter, a soft clip and a DC blocker.  For every lane and both
// channels, sample t of a block:
//
//   delayed = lerp read of the line at t - d[t]
//   svf     = TPT SVF of delayed (per-sample a1, a2, a3, m0, m1, m2)
//   sat     = saturate(svf, drive[t])          (pass-through under 0.001)
//   blocked = DC blocker of sat (r constant)
//   clean   = clamp(blocked, -4, 4)            (the wet output)
//   line[t] = x[t] + clean[t-1] * fb[t]        (stereo), or the ping-pong
//             mix: left = mono + right clean[t-1] * fb, right = left
//             clean[t-1] * fb
//
// This replaces no TPU kernel: the JAX package runs this loop as a
// lax.scan of jnp operations over sub-blocks (phonic_tpu/effects/delay.py).
// The plain version, ops/delayline.py:feedback_loop_plain, is that loop:
// per sub-block of b samples a gather, an iir2 scan, an iir1 scan and some
// 80 small operations more, ~1,400 launches per 131072-frame block.
//
// What bounds it here: the recurrence.  A read at t needs the line at
// t - d with d >= b + 1, which a sample at least b + 1 earlier wrote, and
// that write needs the clean value of the sample before it; so a lane's
// block is a chain of tiles of at most b samples, each of which can only
// start once the one before it has written the line.  The bytes (each
// stream read once, the wet signal and the line written once: ~75 MB for
// 8 lanes of 131072 frames, 23 us at 3.35 TB/s) are not the limit: a lane
// runs on one SM, whose issue rate over the ~300 instructions of a sample
// (both channels: the read, the SVF and DC maps composed and re-run, the
// saturation, the feedback mix) and the tiles' barriers and scans bound
// it, ~5 ns a sample on an H100.  A serial loop per row would be ~30
// dependent cycles a sample, ~2 ms for 131072 samples.
//
// Design: one block of 512 threads per lane, both channels in it (the
// ping-pong mix couples them).  The block walks the lane's samples in tiles
// of min(b, 512 * per) samples, per = 4, 2 or 1 as b allows, so no read
// of a tile touches a sample the tile writes.  A thread takes per
// consecutive samples of both channels; per tile:
//   0. it loads every stream of its samples into registers, all loads in
//      flight together, so a tile waits on memory twice (these loads, then
//      the line's reads) and not once per sample;
//   1. it reads the line and forms each sample's SVF map (a 2x2 affine map
//      of the integrator state) and composes its samples' maps;
//   2. a block scan (warp shuffles, then shared memory) gives each thread
//      the composition of the maps before it; applied to the tile's
//      incoming state that gives the thread's own incoming state, from
//      which it re-runs its samples: SVF output, saturation;
//   3. the same for the DC blocker's first-order maps, after each thread
//      has taken its predecessor's last saturated sample from shared
//      memory; the clamp;
//   4. each thread takes its predecessor's last clean sample and writes
//      the feedback mix into the line and the clean samples out.
// The tile's last thread keeps the states for the next tile (shared
// memory, double-buffered by tile parity).
//
// The line is a ring of the window's W samples in the output buffer,
// slot (p - n) mod W for position p of the sequence "old window, then this
// block's writes": the block starts by copying the old window there,
// rotated, and a write at t overwrites the slot of position t, which no
// later read needs.  After the last tile the ring is the new window, newest
// last, as the plain version's rolls leave it: no copy per tile, none at
// the end.
//
// Arithmetic: every elementwise step in the plain version's order, with
// no FMA contraction (__fmul_rn / __fadd_rn).  The scans associate in
// another order than the iir2 / iir1 kernels and the CPU's chunked scans,
// so results agree to float32 rounding, not bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// the SVF's map of one channel's integrator state: s' = M s + w
struct Svf {
  float m11, m12, m21, m22, w1, w2;
};
// the DC blocker's map of its output: y' = p y + w
struct Dc {
  float p, w;
};
// one map per channel
template <class A>
struct Pair {
  A c[2];
};
struct State2 {
  float s1, s2;
};

__device__ __forceinline__ Svf identity(Svf) {
  return {1.0f, 0.0f, 0.0f, 1.0f, 0.0f, 0.0f};
}
__device__ __forceinline__ Dc identity(Dc) { return {1.0f, 0.0f}; }
template <class A>
__device__ __forceinline__ Pair<A> identity(Pair<A>) {
  return {{identity(A{}), identity(A{})}};
}

// the map of `s` applied after `f`
__device__ __forceinline__ Svf compose(const Svf& f, const Svf& s) {
  return {add(mul(s.m11, f.m11), mul(s.m12, f.m21)),
          add(mul(s.m11, f.m12), mul(s.m12, f.m22)),
          add(mul(s.m21, f.m11), mul(s.m22, f.m21)),
          add(mul(s.m21, f.m12), mul(s.m22, f.m22)),
          add(add(mul(s.m11, f.w1), mul(s.m12, f.w2)), s.w1),
          add(add(mul(s.m21, f.w1), mul(s.m22, f.w2)), s.w2)};
}
__device__ __forceinline__ Dc compose(const Dc& f, const Dc& s) {
  return {mul(s.p, f.p), add(mul(s.p, f.w), s.w)};
}
template <class A>
__device__ __forceinline__ Pair<A> compose(const Pair<A>& f, const Pair<A>& s) {
  return {{compose(f.c[0], s.c[0]), compose(f.c[1], s.c[1])}};
}

// as the plain scans step: c11 * s1 + c12 * s2 + b1
__device__ __forceinline__ State2 apply(const Svf& m, const State2& x) {
  return {add(add(mul(m.m11, x.s1), mul(m.m12, x.s2)), m.w1),
          add(add(mul(m.m21, x.s1), mul(m.m22, x.s2)), m.w2)};
}
__device__ __forceinline__ float apply(const Dc& m, float y) {
  return add(mul(m.p, y), m.w);
}

// the TPT core's step as filters.tpt_process forms it:
// A = [[2 a1 - 1, -2 a2], [2 a2, 1 - 2 a3]], b = (2 a2 x, 2 a3 x)
__device__ __forceinline__ Svf svf_map(float a1, float a2, float a3, float x) {
  const float a2x2 = mul(2.0f, a2), a3x2 = mul(2.0f, a3);
  return {sub(mul(2.0f, a1), 1.0f), mul(-2.0f, a2), a2x2,
          sub(1.0f, a3x2),          mul(a2x2, x),   mul(a3x2, x)};
}

// effects/delay.py:saturate, x(27 + x^2) / (27 + 9 x^2) of the gained
// signal over sqrt(gain); the signal itself where drive < 0.001
__device__ __forceinline__ float saturate(float x, float drive) {
  if (drive < 0.001f) return x;  // a branch: drive is one value per lane
  const float gain = add(1.0f, mul(drive, 4.0f));
  const float xg = mul(x, gain);
  const float x2 = mul(xg, xg);
  const float out = __fdiv_rn(__fdiv_rn(mul(xg, add(27.0f, x2)),
                                        add(27.0f, mul(9.0f, x2))),
                              __fsqrt_rn(gain));
  return out;
}

__device__ __forceinline__ float clamp4(float y) {
  // torch.clamp's order: NaN stays NaN
  return y < -4.0f ? -4.0f : (y > 4.0f ? 4.0f : y);
}

template <class T>
__device__ __forceinline__ T shfl_up(T v, int d) {
  float* f = reinterpret_cast<float*>(&v);
#pragma unroll
  for (int i = 0; i < (int)(sizeof(T) / sizeof(float)); ++i)
    f[i] = __shfl_up_sync(kFull, f[i], d);
  return v;
}

// Exclusive scan of the threads' maps in thread order: each thread gets the
// composition of all earlier threads' maps, *total the block's.  Every
// thread of the block calls it.
template <class A>
__device__ A block_exclusive_scan(const A& x, A* total) {
  __shared__ A warp_tot[kWarps];
  __shared__ A block_tot;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  A inc = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const A other = shfl_up(inc, d);
    if (lane >= d) inc = compose(other, inc);
  }
  if (lane == 31) warp_tot[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    A t = lane < kWarps ? warp_tot[lane] : identity(x);
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const A other = shfl_up(t, d);
      if (lane >= d) t = compose(other, t);
    }
    if (lane < kWarps) warp_tot[lane] = t;
    if (lane == kWarps - 1) block_tot = t;
  }
  __syncthreads();
  A prev = shfl_up(inc, 1);
  if (lane == 0) prev = identity(x);
  const A res = warp > 0 ? compose(warp_tot[warp - 1], prev) : prev;
  *total = block_tot;
  return res;
}

struct Io {
  const float* x;     // [G, 2, n] the effect's input
  const float* hist;  // [G, 2, W] the line's window before the block
  const float* svf1;  // [G, 2] SVF integrator states ic1, ic2
  const float* svf2;
  const float* dcy;   // [G, 2] DC blocker's last output and input
  const float* dcx;
  const float* fb;    // [G, 2] the last clean sample
  const float* dly;   // [G, n] delay in samples, in [b + 1, W - 2]
  const float* fbk;   // [G, n] feedback
  const float* drive; // [G, n]
  const float* a1;    // [G, n] SVF coefficients and output mix
  const float* a2;
  const float* a3;
  const float* m0;
  const float* m1;
  const float* m2;
  const uint8_t* pp;  // [G] ping-pong
  float* wet;         // [G, 2, n] the clean samples
  float* line;        // [G, 2, W] the window after the block
  float* state;       // [5, G, 2] svf1, svf2, dcy, dcx, fb after the block
};

// the carried states' rows in shared memory and in Io::state
enum { kSvf1, kSvf2, kDcy, kDcx, kFb, kCarried };

template <int kPer>
__global__ void __launch_bounds__(kThreads)
    delay_iir2_feedback_kernel(Io io, float dc_r, int lanes, int n, int w,
                               int tile) {
  __shared__ float carry[2][kCarried][2];  // by tile parity
  __shared__ float last_sat[2][kThreads];
  __shared__ float last_clean[2][kThreads];
  const int g = blockIdx.x;
  const int tid = threadIdx.x;
  const long long row = (long long)g * n;
  const float* x0 = io.x + 2 * row;
  const float* x1 = x0 + n;
  float* line = io.line + (long long)g * 2 * w;
  const float* hist = io.hist + (long long)g * 2 * w;
  const int nw = n % w;
  const int shift = nw == 0 ? 0 : w - nw;  // slot of position p: (p + shift) % w

  // the ring starts as the old window: position p < W in slot (p - n) mod W
  for (int q = tid; q < w; q += kThreads) {
    const int p = q + nw < w ? q + nw : q + nw - w;
    line[q] = hist[p];
    line[w + q] = hist[w + p];
  }
  if (tid < kCarried * 2) {
    const float* src[kCarried] = {io.svf1, io.svf2, io.dcy, io.dcx, io.fb};
    carry[0][tid >> 1][tid & 1] = src[tid >> 1][2 * g + (tid & 1)];
  }
  __syncthreads();

  const bool pp = io.pp[g] != 0;
  const int lo = tid * kPer;
  int par = 0;
  for (int t0 = 0; t0 < n; t0 += tile, par ^= 1) {
    const int len = n - t0 < tile ? n - t0 : tile;
    const int cnt = len - lo <= 0 ? 0 : (len - lo < kPer ? len - lo : kPer);
    const bool last = tid == (len - 1) / kPer;  // holds the tile's last sample
    float v[2][kPer];

    // every stream of this thread's samples, all loads in flight at once
    // (past the tile's end the tile's last sample is read again, unused)
    float dd[kPer], ca1[kPer], ca2[kPer], ca3[kPer], cm0[kPer], cm1[kPer],
        cm2[kPer], drv[kPer], fbv[kPer], xl[kPer], xr[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int t = t0 + (lo + i < len ? lo + i : len - 1);
      dd[i] = io.dly[row + t];
      ca1[i] = io.a1[row + t];
      ca2[i] = io.a2[row + t];
      ca3[i] = io.a3[row + t];
      cm0[i] = io.m0[row + t];
      cm1[i] = io.m1[row + t];
      cm2[i] = io.m2[row + t];
      drv[i] = io.drive[row + t];
      fbv[i] = io.fbk[row + t];
      xl[i] = x0[t];
      xr[i] = x1[t];
    }

    // 1. read the line (written before this tile), every read in flight at
    // once, then compose the SVF maps.  `at` is the slot of position W + t,
    // this thread's sample t (past the tile's end a slot all the same)
    const int first = (t0 + lo + shift) % w;
    int at = first;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const float oi = floorf(dd[i]);
      const float of = sub(dd[i], oi);  // exact (Sterbenz)
      const bool whole = of == 0.0f;
      const float frac = whole ? of : sub(1.0f, of);
      // position W + t - oi - (not whole); clamping the offset keeps any
      // delay inside the ring and leaves a valid one as it is
      const int off = (int)fminf(fmaxf(oi, 0.0f), (float)(w - 2));
      int s1 = at + w - off - (whole ? 0 : 1);  // in [at + 1, at + w]
      if (s1 >= w) s1 -= w;
      const int s2 = s1 + 1 == w ? 0 : s1 + 1;
      at = at + 1 == w ? 0 : at + 1;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float u1 = line[c * w + s1], u2 = line[c * w + s2];
        v[c][i] = add(u1, mul(sub(u2, u1), frac));
      }
    }
    Pair<Svf> acc = identity(Pair<Svf>{});
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      if (i < cnt) {
#pragma unroll
        for (int c = 0; c < 2; ++c)
          acc.c[c] = compose(acc.c[c], svf_map(ca1[i], ca2[i], ca3[i], v[c][i]));
      }
    }
    Pair<Svf> svf_tot;
    const Pair<Svf> svf_ex = block_exclusive_scan(acc, &svf_tot);

    // 2. re-run from the exact incoming state: SVF output, saturation
    State2 s[2];
    float sat_end[2] = {0.0f, 0.0f};
#pragma unroll
    for (int c = 0; c < 2; ++c)
      s[c] = apply(svf_ex.c[c], State2{carry[par][kSvf1][c], carry[par][kSvf2][c]});
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      if (i < cnt) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const State2 prev = s[c];
          s[c] = apply(svf_map(ca1[i], ca2[i], ca3[i], v[c][i]), s[c]);
          // the taps are the midpoints of consecutive integrator states
          const float v1 = mul(0.5f, add(s[c].s1, prev.s1));
          const float v2 = mul(0.5f, add(s[c].s2, prev.s2));
          const float y = add(add(mul(cm0[i], v[c][i]), mul(cm1[i], v1)),
                              mul(cm2[i], v2));
          v[c][i] = saturate(y, drv[i]);
          sat_end[c] = v[c][i];
        }
      }
    }
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      if (cnt > 0) last_sat[c][tid] = sat_end[c];
      if (last) {
        carry[par ^ 1][kSvf1][c] = s[c].s1;
        carry[par ^ 1][kSvf2][c] = s[c].s2;
      }
    }
    __syncthreads();

    // 3. the DC blocker over the saturated samples: y = r y + (x - x_prev)
    float before[2];
    Pair<Dc> dacc = identity(Pair<Dc>{});
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      before[c] = tid == 0 ? carry[par][kDcx][c] : last_sat[c][tid - 1];
      float ps = before[c];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        if (i < cnt) {
          dacc.c[c] = compose(dacc.c[c], Dc{dc_r, sub(v[c][i], ps)});
          ps = v[c][i];
        }
      }
    }
    Pair<Dc> dc_tot;
    const Pair<Dc> dc_ex = block_exclusive_scan(dacc, &dc_tot);
    float clean_end[2] = {0.0f, 0.0f};
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      float y = apply(dc_ex.c[c], carry[par][kDcy][c]);
      float ps = before[c];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        if (i < cnt) {
          y = apply(Dc{dc_r, sub(v[c][i], ps)}, y);
          ps = v[c][i];
          v[c][i] = clamp4(y);
          clean_end[c] = v[c][i];
        }
      }
      if (cnt > 0) last_clean[c][tid] = clean_end[c];
      if (last) {
        carry[par ^ 1][kDcy][c] = y;
        carry[par ^ 1][kDcx][c] = ps;
        carry[par ^ 1][kFb][c] = clean_end[c];
      }
    }
    __syncthreads();

    // 4. the feedback mix from the previous sample's clean values into the
    // line, and the clean samples out
    float pc[2];
#pragma unroll
    for (int c = 0; c < 2; ++c)
      pc[c] = tid == 0 ? carry[par][kFb][c] : last_clean[c][tid - 1];
    at = first;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      if (i < cnt) {
        const int t = t0 + lo + i;
        float l_in, r_in;
        if (pp) {
          l_in = add(mul(add(xl[i], xr[i]), 0.5f), mul(pc[1], fbv[i]));
          r_in = mul(pc[0], fbv[i]);
        } else {
          l_in = add(xl[i], mul(pc[0], fbv[i]));
          r_in = add(xr[i], mul(pc[1], fbv[i]));
        }
        line[at] = l_in;  // position W + t
        line[w + at] = r_in;
        at = at + 1 == w ? 0 : at + 1;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          io.wet[2 * row + (long long)c * n + t] = v[c][i];
          pc[c] = v[c][i];
        }
      }
    }
    __syncthreads();  // the line's writes before the next tile's reads
  }
  if (tid < kCarried * 2)
    io.state[((tid >> 1) * lanes + g) * 2 + (tid & 1)] =
        carry[par][tid >> 1][tid & 1];
}

template <int kPer>
void launch(const Io& io, float dc_r, int lanes, int n, int w, int b,
            cudaStream_t stream) {
  const int tile = b < kThreads * kPer ? b : kThreads * kPer;
  delay_iir2_feedback_kernel<kPer>
      <<<lanes, kThreads, 0, stream>>>(io, dc_r, lanes, n, w, tile);
}

}  // namespace

// One block of the delay's feedback loop for `lanes` lanes of `n` samples
// over a line window of `w` samples.  Every delay must lie in [b + 1, w - 2]
// samples: tiles are at most b samples long, so each read's source was
// written by an earlier tile.
extern "C" int phonic_delay(int device, const float* x, const float* hist,
                            const float* svf1, const float* svf2,
                            const float* dcy, const float* dcx,
                            const float* fb, const float* dly,
                            const float* fbk, const float* drive,
                            const float* a1, const float* a2, const float* a3,
                            const float* m0, const float* m1, const float* m2,
                            const uint8_t* pp, float dc_r, float* wet,
                            float* line, float* state, int lanes, int n,
                            int w, int b, void* stream) {
  if (lanes < 1 || n < 1 || w < 3 || b < 1) return (int)cudaErrorInvalidValue;
  DeviceGuard on(device);
  if (on.err != cudaSuccess) return (int)on.err;
  const Io io = {x,  hist, svf1, svf2, dcy, dcx, fb,  dly,  fbk, drive,
                 a1, a2,   a3,   m0,   m1,  m2,  pp,  wet,  line, state};
  const cudaStream_t s = (cudaStream_t)stream;
  if (b >= kThreads * 4) launch<4>(io, dc_r, lanes, n, w, b, s);
  else if (b >= kThreads * 2) launch<2>(io, dc_r, lanes, n, w, b, s);
  else launch<1>(io, dc_r, lanes, n, w, b, s);
  return (int)cudaGetLastError();
}

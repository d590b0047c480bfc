// The reverb's delay network in one launch (kernel 8).
//
// ReverbEffect (effects/reverb.py) drives its input through four chained
// Schroeder allpasses into 8 vibrato-read delay lines coupled in two
// Householder groups of 4.  For every lane and channel, sample t of a
// block:
//
//   s0      = x[t]                                  (after biquad A and sin)
//   w_a[t]  = s_a - 0.5 w_a[t - d_a]                a = 0..3
//   s_a+1   = 0.5 w_a[t] + w_a[t - d_a]
//   phase_l = phase0_l + inc_l t; off_l = (sin(phase_l + inc_l) + 1) * 7
//             (the sine in float64, rounded to float32: it picks the tap)
//   k, f    = floor(off_l), off_l - k
//   v1, v2  = line_l[t - D_l + k], line_l[t - D_l + k + 1]
//   r_l     = (1 - blend) (v1 (1 - f) + v2 f) + v1 blend
//   fb_l[t] = (2 r_l - sum of r over l's group of 4) * regen[t]
//   line_l[t] = s_(4 - l or l - 3)[t] + fb_l[t - 1]
//   wet[t]  = the mean of r over the 8 lines
//
// This replaces no TPU kernel: the JAX package runs these loops as
// lax.scans of jnp operations over sub-blocks (phonic_tpu/effects/
// reverb.py).  The plain version, ops/reverbnet.py:network_plain, is that
// pair of loops: ~22 operations per allpass sub-block and ~35 per FDN
// sub-block, ~230 launches per 8192-frame block at the Player's sizes.
//
// What bounds it here: the recurrence.  A read at t needs a line at
// t - D + 15 or an allpass at t - d, which an earlier sample wrote, so a
// block is a chain of tiles no longer than the smallest delay (less the
// vibrato's 15 samples of reach), each of which starts only once the one
// before it has written the lines.  The bytes (the input, two streams, the
// windows read and written once: ~1.7 MB per lane at the Player's 8192
// samples and 8192-sample windows, 0.5 us at 3.35 TB/s) are not the limit:
// a chain of 6-12 tiles, each a round of loads, a barrier and a round of
// stores, is.
//
// Design: one block of 512 threads per (lane, channel), since channels
// never couple and the lines couple only within a channel.  The tile is
// the smallest allpass delay, the smallest line delay less 15 and 1024,
// whichever is least, taken from the delays this block reads: the tiles
// follow the room.  A thread takes 2 consecutive samples; per tile:
//   1. it reads its samples' allpass taps (4) and line taps (8 x 2), all
//      from earlier tiles, runs the allpass chain and the FDN's maths, and
//      writes the wet sample; its last sample's feedback goes to shared
//      memory for the next thread;
//   2. after a barrier, it writes its samples into the allpass rings and
//      the lines (the input plus the previous sample's feedback).
// Reads before the barrier and writes after it: a ring slot a tile writes
// is one its reads may still need.
//
// Each window is a ring of its H samples (a power of two) in the output
// buffer, slot (p - n) mod H for position p of the sequence "old window,
// then this block's writes": the block starts by copying the old window
// there, rotated, and after the last tile the ring is the new window,
// newest last, as the plain version's rolls leave it.
//
// Arithmetic: every elementwise step in the plain version's order, with no
// FMA contraction (__fmul_rn / __fadd_rn), and the sums over the lines in
// its order, so the kernel rounds as the plain version does.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kPer = 2;  // consecutive samples per thread
constexpr int kMaxTile = kThreads * kPer;
constexpr int kStages = 4;
constexpr int kLines = 8;
constexpr int kSpan = 15;  // the newest tap's reach past a line's delay

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

struct Io {
  const float* x;          // [G, 2, n] the driven input
  const int64_t* ap_d;     // [G, 4] allpass delays
  const int64_t* ln_d;     // [G, 8] line delays
  const float* blend;      // [G, n]
  const float* regen;      // [G, n]
  const float* phase;      // [G, 8, 2] vibrato phases at block start
  const float* inc;        // [8] vibrato phase increments per sample
  const float* ap_hist;    // [G, 4, 2, Ha] windows before the block
  const float* ln_hist;    // [G, 8, 2, Hl]
  const float* fb;         // [G, 8, 2] feedback before the block
  float* wet;              // [G, 2, n]
  float* ap;               // [G, 4, 2, Ha] windows after the block
  float* ln;               // [G, 8, 2, Hl]
  float* fb_out;           // [G, 8, 2]
};

// line l's input: allpass L, K, J, I, I, J, K, L (reverb.rs:275-283)
__device__ __forceinline__ int line_stage(int l) {
  return l < 4 ? 3 - l : l - 4;
}

__global__ void __launch_bounds__(kThreads)
    reverb_net_kernel(Io io, int n, int ha, int hl) {
  __shared__ float carry[2][kLines];          // by tile parity
  __shared__ float last_fb[kThreads][kLines];
  const int g = blockIdx.x >> 1;
  const int c = blockIdx.x & 1;
  const int tid = threadIdx.x;
  const int ma = ha - 1, ml = hl - 1;
  const long long xrow = ((long long)g * 2 + c) * n;
  const float* x = io.x + xrow;
  const float* blend = io.blend + (long long)g * n;
  const float* regen = io.regen + (long long)g * n;

  float* ap[kStages];
  float* ln[kLines];
  int dap[kStages], dln[kLines];
  float ph[kLines], inc[kLines];
  int tile = kMaxTile;
#pragma unroll
  for (int a = 0; a < kStages; ++a) {
    const long long r = ((long long)g * kStages + a) * 2 + c;
    ap[a] = io.ap + r * ha;
    dap[a] = (int)io.ap_d[g * kStages + a];
    tile = min(tile, dap[a]);
    // the ring starts as the old window: position p in slot (p - n) mod H
    const float* old = io.ap_hist + r * ha;
    for (int q = tid; q < ha; q += kThreads) ap[a][(q - n) & ma] = old[q];
  }
#pragma unroll
  for (int l = 0; l < kLines; ++l) {
    const long long r = ((long long)g * kLines + l) * 2 + c;
    ln[l] = io.ln + r * hl;
    dln[l] = (int)io.ln_d[g * kLines + l];
    tile = min(tile, dln[l] - kSpan);
    ph[l] = io.phase[r];
    inc[l] = io.inc[l];
    const float* old = io.ln_hist + r * hl;
    for (int q = tid; q < hl; q += kThreads) ln[l][(q - n) & ml] = old[q];
  }
  tile = max(tile, 1);
  if (tid < kLines) carry[0][tid] = io.fb[((long long)g * kLines + tid) * 2 + c];
  __syncthreads();

  const int lo = tid * kPer;
  int par = 0;
  for (int t0 = 0; t0 < n; t0 += tile, par ^= 1) {
    const int len = min(n - t0, tile);
    const int cnt = min(max(len - lo, 0), kPer);
    float w[kPer][kStages];   // the allpasses' writes
    float s[kPer][kStages];   // their outputs
    float fbn[kPer][kLines];  // each sample's feedback

    // 1. every read of the tile, from samples earlier tiles wrote
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      if (i >= cnt) break;
      const int t = t0 + lo + i;
      float sig = x[t];
#pragma unroll
      for (int a = 0; a < kStages; ++a) {
        // position H + t - d, in slot (t - d - n) mod H
        const float dl = ap[a][(t - dap[a] - n) & ma];
        w[i][a] = sub(sig, mul(dl, 0.5f));
        sig = add(mul(w[i][a], 0.5f), dl);
        s[i][a] = sig;
      }
      const float bl = blend[t], rg = regen[t];
      const float one_bl = sub(1.0f, bl);
      const float tf = (float)t;
      float r[kLines];
#pragma unroll
      for (int l = 0; l < kLines; ++l) {
        const float vib = add(ph[l], mul(inc[l], tf));
        const float sn = (float)sin((double)add(vib, inc[l]));
        const float off = mul(add(sn, 1.0f), 7.0f);
        const float fl = floorf(off);
        const float fr = sub(off, fl);
        const int s1 = (t - dln[l] + (int)fl - n) & ml;
        const float v1 = ln[l][s1], v2 = ln[l][(s1 + 1) & ml];
        r[l] = add(mul(one_bl, add(mul(v1, sub(1.0f, fr)), mul(v2, fr))),
                   mul(v1, bl));
      }
      const float g1 = add(add(add(r[0], r[1]), r[2]), r[3]);
      const float g2 = add(add(add(r[4], r[5]), r[6]), r[7]);
#pragma unroll
      for (int l = 0; l < kLines; ++l)
        fbn[i][l] = mul(sub(mul(2.0f, r[l]), l < 4 ? g1 : g2), rg);
      io.wet[xrow + t] =
          __fdiv_rn(add(add(add(add(g1, r[4]), r[5]), r[6]), r[7]), 8.0f);
    }
    // this thread's last sample's feedback, for the next thread (and the
    // next tile, from the thread that holds the tile's last sample)
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      if (i != cnt - 1) continue;
#pragma unroll
      for (int l = 0; l < kLines; ++l) {
        last_fb[tid][l] = fbn[i][l];
        if (tid == (len - 1) / kPer) carry[par ^ 1][l] = fbn[i][l];
      }
    }
    __syncthreads();

    // 2. the tile's writes: the allpasses' w, each line's input plus the
    // feedback of the sample before
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      if (i >= cnt) break;
      const int t = t0 + lo + i;
#pragma unroll
      for (int a = 0; a < kStages; ++a) ap[a][(t - n) & ma] = w[i][a];
#pragma unroll
      for (int l = 0; l < kLines; ++l) {
        const float prev = i > 0 ? fbn[i - 1][l]
                           : tid == 0 ? carry[par][l] : last_fb[tid - 1][l];
        ln[l][(t - n) & ml] = add(s[i][line_stage(l)], prev);
      }
    }
    __syncthreads();  // the tile's writes before the next tile's reads
  }
  if (tid < kLines)
    io.fb_out[((long long)g * kLines + tid) * 2 + c] = carry[par][tid];
}

}  // namespace

// One block of the reverb's delay network for `lanes` lanes of `n`
// samples over allpass windows of `ha` and line windows of `hl` samples
// (powers of two).  Every allpass delay must lie in [1, ha] and every line
// delay in [16, hl - 1]; the tiles are at most the smallest allpass delay
// and the smallest line delay less 15, so each read's source was written
// by an earlier tile.
extern "C" int phonic_reverb(int device, const float* x, const int64_t* ap_d,
                             const int64_t* ln_d, const float* blend,
                             const float* regen, const float* phase,
                             const float* inc, const float* ap_hist,
                             const float* ln_hist, const float* fb,
                             float* wet, float* ap, float* ln, float* fb_out,
                             int lanes, int n, int ha, int hl, void* stream) {
  if (lanes < 1 || n < 1 || ha < 2 || hl < 2 || (ha & (ha - 1)) ||
      (hl & (hl - 1)))
    return (int)cudaErrorInvalidValue;
  DeviceGuard on(device);
  if (on.err != cudaSuccess) return (int)on.err;
  const Io io = {x,  ap_d,    ln_d,    blend, regen, phase, inc,
                 ap_hist, ln_hist, fb, wet, ap, ln, fb_out};
  reverb_net_kernel<<<lanes * 2, kThreads, 0, (cudaStream_t)stream>>>(
      io, n, ha, hl);
  return (int)cudaGetLastError();
}

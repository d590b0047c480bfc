// sub3's voice render around iir2: kernels 10 (synth_voice) and 11
// (synth_mix).
//
// A SynthGenerator playing a SynthDef that describes its voice
// (ops/synthvoice.py SubtractiveVoice: sub3) renders every voice row r of a
// block (lane-major, R = L * V) in three launches:
//
//   kernel 10: for each sample i of row r
//     note      the last trigger slot that started at or before i, else the
//               continuing note: age, note, velocity, pan, release, active;
//               frequency = 440 * 2^((note' - 69) / 12) * spd / 2^((note -
//               60) / 12), note' glided from the note before, velocity, pan
//               and spd from per-note automation where the block has it
//     sources   each modulation source (LFO: the row's own waveform of
//               age * rate; AHDSR; velocity; note / 127); the matrix's
//               shape and cutoff offsets, summed in source order
//     sub3      3 phases (freq, freq * det, freq / det) summed in float64
//               and rounded once; 3 morphing oscillators with polyBLEP;
//               mix / 3; amp AHDSR env; cutoff * (0.2 + 0.8 env), clamped;
//               the lowpass SVF's a1, a2, a3
//     writes    iir2's operands 2a1 - 1, -2a2, 2a2, 1 - 2a3, 2a2 x, 2a3 x
//               and the gain of each output channel, env * volume *
//               velocity * active * the pan law's factor
//   kernel 2, iir2 (csrc/scan.cu): s[i] = A[i] s[i - 1] + b[i] per row
//   kernel 11: y = (s2[i] + s2[i - 1]) / 2 (the lowpass tap) times each
//              gain, summed over the V voices of each lane in voice order;
//              the new SVF state
//
// This replaces no TPU kernel: the JAX package's synth render is plain jnp
// (phonic_tpu/generators/synth.py, phonic_tpu/synths/__init__.py).  The
// plain version, ops/synthvoice.py render_plain, takes the generic path's
// steps in its order: ~1,040 PyTorch operations per block at the synth
// cell's shape (R = 512, n = 131072), each one pass over a 268 MB stream.
//
// What bounds it here: arithmetic, for kernel 10.  It reads a few bytes per
// sample (6 parameter rows per lane, shared by the lane's V voices) and
// writes 6 + G floats per row and sample (2.15 GB at the cell's shape,
// 0.64 ms at 3.35 TB/s), but a sample takes three morphing oscillators
// (polyBLEP divisions, a sine where the morph needs one), two closed-form
// AHDSRs, the LFO, a tangent and a division for the SVF, ~500-1000
// instructions, and one row is one block's sequential walk (the phases
// carry across it).  Its design: one block of 128 threads per row, at most
// 128 registers a thread so that 4 blocks share an SM and the cell's 512
// rows run in one wave, walking the row in tiles of 512 samples, 4
// consecutive samples a thread, in registers but for the block scan of the
// phases.  A thread takes its 4
// samples stage by stage (the matrix, each oscillator, the envelope and the
// SVF's coefficients), in straight-line code without data-dependent
// branches where it can (a polyBLEP residual selects its numerator), so the
// compiler interleaves 4 independent chains; every float64 exp2 (note to
// Hz, the note's speed, the detune) is taken again only where its argument
// changes.  Kernel 11 is bound by bytes (the states and gains of the rows,
// read once: 0.8 GB at the cell's shape with G = 2); a thread per output
// sample reads its lane's V rows.
//
// Arithmetic: every elementwise step in the plain version's order with no
// FMA contraction (__fmul_rn / __fadd_rn / __fdiv_rn, as kernels 6-9), the
// same CUDA math functions PyTorch's kernels call (sinf, tanf, sqrtf, exp2
// in float64), and a division by a host scalar taken as the product with
// its reciprocal, as PyTorch's CUDA division does.  So the kernels round as
// the plain version does on the card but for the order of the float64 phase
// sums (whose partial sums of float32 steps are exact at audio increments),
// the voice sum's order, and the gain's (one factor per channel here).

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "device_guard.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kPer = 4;  // consecutive samples per thread
// at most 128 registers a thread, so 4 rows' blocks share an SM and the
// synth cell's 512 rows run in one wave (at the 142 the compiler takes
// unbounded, 3 a SM: 4.7 ms a block against 3.0; at 96 it spills: 3.4)
constexpr int kBlocksPerSm = 4;
constexpr int kTile = kThreads * kPer;
constexpr int kWarps = kThreads / 32;
constexpr int kOsc = 3;
constexpr int kMaxSources = 8;
constexpr int kMaxGains = 3;
constexpr int kMixThreads = 256;

constexpr double kPi = 3.141592653589793;
constexpr float kEps = 1.1920928955078125e-07f;  // float32 epsilon

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }
// a Python float constant as PyTorch hands it to a float32 kernel
__device__ __forceinline__ constexpr float f32(double x) { return (float)x; }

// the AHDSR's rates (ops/ahdsr.py AhdsrParams, linear curves)
struct Env {
  float attack_rate, hold, decay_rate, sustain, release_rate;
};

struct Source {
  int kind;        // 0 LFO, 1 envelope, 2 velocity, 3 keytracking
  int bipolar;     // the source's polarity
  int wave;        // LFO waveform id, clamped to 0..6
  unsigned seed;   // LFO hash seed: the voice's seed + the salt, mod 2^32
  float inc;       // LFO phase increment per sample
  Env env;         // envelope rates
  float amt[2];    // routing amounts to the shape and cutoff targets
  int routed[2];   // bipolar routings
};

struct Cfg {
  int n, k, nv, lanes, gains, sources, targets, t_shape, t_cut, has_auto,
      glide;
  int kind[kMaxSources];
  unsigned salt[kMaxSources];
  int bipolar[kMaxSources];
  float rsr;      // float32 1 / sample rate
  float rglide;   // float32 1 / max(glide seconds * sample rate, 1)
  float nyquist;  // sample rate / 2
  Env amp;
};

struct VoiceIo {
  const int* trig_time;   // [R, K]
  const float* trig;      // [5, R, K] note, vol, pan, spd, rel
  const int* age0;        // [R]
  const float* cont;      // [6, R] active, note, vol, pan, spd, rel
  const float* automation;  // [3, R, K + 1, n] vol, pan, spd, or null
  const float* par[6];    // [L, n] shape, detune, cutoff, resonance,
                          // volume, panning
  const float* src_f;     // [L, S, 5]
  const int* src_i;       // [L, S]
  const float* amounts;   // [L, S, T]
  const float* routed;    // [L, S, T]
  const float* phase0;    // [R, 3]
  float* operands;        // [6, R, n]
  float* gains;           // [G, R, n]
  float* phase_end;       // [R, 3]
};

// ---- the AHDSR in closed form (ops/ahdsr.py) ------------------------------

// the terms of _raw_value / _display_value that depend on the rates and the
// note's level alone
struct EnvNote {
  float volume, vol, n_attack, n_hold, n_decay, sustain_level, step, rng,
      toward;
  bool above;
};

__device__ EnvNote env_note(const Env& p, float volume) {
  EnvNote e;
  e.volume = volume;
  const bool skip_attack = isinf(p.attack_rate);
  e.n_attack = skip_attack ? 0.0f : ceilf(dvd(volume, p.attack_rate));
  e.n_hold = ceilf(p.hold);
  const bool skip_decay = isinf(p.decay_rate);
  e.sustain_level = (skip_decay && e.n_hold > 0.0f) ? volume : p.sustain;
  const float dist = fabsf(sub(volume, e.sustain_level));
  e.n_decay = skip_decay ? (dist > 0.0f ? 1.0f : 0.0f)
                         : ceilf(dvd(dist, p.decay_rate));
  e.above = volume > e.sustain_level;
  e.toward = e.above ? -1.0f : 1.0f;
  e.step = skip_decay ? dist : p.decay_rate;
  e.vol = fmaxf(volume, kEps);
  e.rng = fmaxf(fabsf(sub(e.vol, p.sustain)), kEps);
  return e;
}

// _display_value: the envelope after c held runs (c >= 1)
__device__ float env_display(const Env& p, const EnvNote& e, float c) {
  const float attack_val = fminf(mul(c, p.attack_rate), e.volume);
  const float c_decay = sub(sub(c, e.n_attack), e.n_hold);
  float decay_val = add(e.volume, mul(mul(e.toward, c_decay), e.step));
  decay_val = e.above ? fmaxf(decay_val, e.sustain_level)
                      : fminf(decay_val, e.sustain_level);
  const bool in_attack = c <= e.n_attack;
  const bool in_hold = !in_attack && c <= add(e.n_attack, e.n_hold);
  const bool in_decay = !in_attack && !in_hold && c_decay <= e.n_decay;
  const float raw = in_attack ? attack_val
                    : in_hold ? e.volume
                    : in_decay ? decay_val : e.sustain_level;
  const int stage = c < e.n_attack ? 0
                    : (in_hold || (in_attack && e.n_hold > 0.0f)) ? 1
                    : in_decay ? 2 : 3;
  if (stage == 0) return mul(dvd(raw, e.vol), e.vol);
  if (stage == 2) {
    const float prog = mul(dvd(fabsf(sub(e.vol, raw)), e.rng), e.rng);
    return e.vol > p.sustain ? sub(e.vol, prog) : add(e.vol, prog);
  }
  return raw;
}

// release_level: the level the release decays from
__device__ float env_release_level(const Env& p, const EnvNote& e,
                                   float release_at) {
  const float level = env_display(p, e, fmaxf(release_at, 1.0f));
  return release_at < 1.0f ? 0.0f : level;
}

// _envelope at c = age + 1 runs
__device__ float env_value(const Env& p, const EnvNote& e, float c,
                           float release_at, float rel_level) {
  const float held = env_display(p, e, fmaxf(c, 1.0f));
  const float r = sub(c, release_at);
  const bool cut = isinf(p.release_rate);
  float rel = mul(rel_level, sub(1.0f, mul(r, cut ? 1.0f : p.release_rate)));
  rel = (cut || rel <= f32(0.001)) ? 0.0f : rel;
  rel = rel_level <= kEps ? 0.0f : rel;
  return r > 0.0f ? rel : (c >= 1.0f ? held : 0.0f);
}

// the LFO's and the oscillators' triangle
__device__ __forceinline__ float triangle(float ph) {
  return ph < 0.25f ? mul(ph, 4.0f)
         : ph < 0.75f ? sub(2.0f, mul(ph, 4.0f)) : sub(mul(ph, 4.0f), 4.0f);
}

// ---- the LFO (modulation/matrix.py _waveform_at, ops/lfo.py) --------------

__device__ float sine_approx(float x) {
  const float b = f32(4.0 / kPi), c = f32(-4.0 / (kPi * kPi)), p = f32(0.225);
  const float y = add(mul(b, x), mul(mul(c, x), fabsf(x)));
  return add(mul(p, sub(mul(y, fabsf(y)), y)), y);
}

__device__ float hash_random(unsigned seed, unsigned k) {
  unsigned x = (k * 0x9E3779B9u) ^ seed;
  x = (x ^ (x >> 16)) * 0x85EBCA6Bu;
  x = (x ^ (x >> 13)) * 0xC2B2AE35u;
  x ^= x >> 16;
  return sub(mul(mul(__uint2float_rn(x), 2.3283064365386963e-10f), 2.0f),
             1.0f);
}

// the LFO at each of a thread's samples: one switch on the row's waveform
__device__ __forceinline__ void lfo4(const Source& s, const float agef[kPer],
                                     float val[kPer]) {
  float ph[kPer];
  int w[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const float raw = mul(agef[j], s.inc);
    const float wraps = floorf(raw);
    ph[j] = sub(raw, wraps);
    w[j] = (int)wraps;
  }
  switch (s.wave) {
    case 0:
#pragma unroll
      for (int j = 0; j < kPer; ++j)
        val[j] = sine_approx(ph[j] < 0.5f
                                 ? mul(ph[j], f32(2.0 * kPi))
                                 : mul(sub(ph[j], 1.0f), f32(2.0 * kPi)));
      break;
    case 1:
#pragma unroll
      for (int j = 0; j < kPer; ++j) val[j] = triangle(ph[j]);
      break;
    case 2:
#pragma unroll
      for (int j = 0; j < kPer; ++j) val[j] = sub(mul(ph[j], 2.0f), 1.0f);
      break;
    case 3:
#pragma unroll
      for (int j = 0; j < kPer; ++j) val[j] = sub(1.0f, mul(ph[j], 2.0f));
      break;
    case 4:
#pragma unroll
      for (int j = 0; j < kPer; ++j) val[j] = ph[j] < 0.5f ? 1.0f : -1.0f;
      break;
    case 5:
#pragma unroll
      for (int j = 0; j < kPer; ++j)
        val[j] = hash_random(s.seed, (unsigned)w[j]);
      break;
    default:
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const float rnd = hash_random(s.seed, (unsigned)w[j]);
        const float t = mul(
            sub(1.0f, sine_approx(sub(f32(kPi / 2.0), mul(ph[j], f32(kPi))))),
            0.5f);
        const float target =
            hash_random(s.seed, (unsigned)((long long)w[j] + 1));
        val[j] = add(rnd, mul(t, sub(target, rnd)));
      }
  }
}

// ---- sub3's oscillators (ops/osc.py) ---------------------------------------

// the 2-sample polyBLEP residual, without a branch: (t / dt) after a
// discontinuity, ((t - 1) / dt) before one, the same division either way
__device__ __forceinline__ float blep(float t, float dt) {
  dt = fmaxf(dt, f32(1e-9));
  const bool up = t < dt;
  const bool down = t > sub(1.0f, dt);
  const float q = dvd(up ? t : sub(t, 1.0f), dt);
  const float u = sub(sub(mul(2.0f, q), mul(q, q)), 1.0f);
  const float d = add(add(mul(q, q), mul(2.0f, q)), 1.0f);
  return up ? u : (down ? d : 0.0f);
}

__device__ __forceinline__ float saw(float ph, float dt) {
  return sub(sub(mul(2.0f, ph), 1.0f), blep(ph, dt));
}

__device__ __forceinline__ float square(float ph, float dt) {
  const float naive = ph < 0.5f ? 1.0f : -1.0f;
  // remainder(ph - 0.5, 1) for ph in [0, 1)
  float t2 = sub(ph, 0.5f);
  if (t2 < 0.0f) t2 = add(t2, 1.0f);
  return sub(add(naive, blep(ph, dt)), blep(t2, dt));
}

__device__ float wave(int w, float ph, float dt) {
  switch (w) {
    case 0:
      return sinf(mul(f32(2.0 * kPi), ph));
    case 1:
      return triangle(ph);
    case 2:
      return saw(ph, dt);
    default:
      return square(ph, dt);
  }
}

// mix[j] += the morphing oscillator at each of a thread's samples: the two
// waves the morph picks and their crossfade.  Where the samples pick the
// same pair (nearly always: the shape moves slowly), each wave runs over
// all of them in turn, straight-line code the compiler interleaves.
__device__ __forceinline__ void morph4(const float ph[kPer],
                                       const float shape[kPer],
                                       const float dt[kPer], float mix[kPer]) {
  float frac[kPer], wa[kPer], wb[kPer];
  int lo[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const float s = fminf(fmaxf(shape[j], 0.0f), 3.0f);
    lo[j] = min(max((int)s, 0), 2);
    frac[j] = sub(s, (float)lo[j]);
  }
  bool same = true;
#pragma unroll
  for (int j = 1; j < kPer; ++j) same = same && lo[j] == lo[0];
  if (same && lo[0] == 2) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) wa[j] = saw(ph[j], dt[j]);
#pragma unroll
    for (int j = 0; j < kPer; ++j) wb[j] = square(ph[j], dt[j]);
  } else if (same && lo[0] == 1) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) wa[j] = triangle(ph[j]);
#pragma unroll
    for (int j = 0; j < kPer; ++j) wb[j] = saw(ph[j], dt[j]);
  } else {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      wa[j] = wave(lo[j], ph[j], dt[j]);
      wb[j] = wave(lo[j] + 1, ph[j], dt[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j)
    mix[j] = add(mix[j], add(mul(wa[j], sub(1.0f, frac[j])),
                             mul(wb[j], frac[j])));
}

// a float64 phase's fractional part in float32, in [0, 1)
__device__ float wrap(double x) {
  const float frac = __double2float_rn(__dsub_rn(x, floor(x)));
  return frac >= 1.0f ? sub(frac, 1.0f) : frac;
}

__device__ float note_to_hz(float note) {
  return mul(440.0f, __double2float_rn(exp2(
                         (double)mul(sub(note, 69.0f), 1.0f / 12.0f))));
}

__device__ float note_speed(float note) {
  return __double2float_rn(
      exp2(__dmul_rn(__dsub_rn((double)note, 60.0), 1.0 / 12.0)));
}

// one sample's note (the slot's values, automation applied)
struct Sample {
  float agef;   // float32 age
  float note, vel, pan, rel, freq, det;
  bool active;
};

// a block scan of each thread's 3 float64 sums: the exclusive prefix of
// this thread and the block's total
__device__ void scan3(const double v[kOsc], double excl[kOsc],
                      double total[kOsc], double (*sums)[kOsc]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kOsc; ++k) {
    double x = v[k];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x = __dadd_rn(x, y);
    }
    if (lane == 31) sums[warp][k] = x;
    excl[k] = __dsub_rn(x, v[k]);
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kOsc; ++k) {
    double before = 0.0, all = 0.0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) before = __dadd_rn(before, sums[w][k]);
      all = __dadd_rn(all, sums[w][k]);
    }
    excl[k] = __dadd_rn(before, excl[k]);
    total[k] = all;
  }
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    synth_voice_kernel(VoiceIo io, Cfg cfg) {
  __shared__ double sums[2][kWarps][kOsc];  // by tile parity
  __shared__ Source src[kMaxSources];
  const int r = blockIdx.x;
  const int lane = r / cfg.nv, v = r % cfg.nv;
  const int tid = threadIdx.x;
  const int n = cfg.n, K = cfg.k;
  const long long R = (long long)cfg.lanes * cfg.nv;
  const long long rn = (long long)r * n, ln = (long long)lane * n;

  if (tid < cfg.sources) {
    Source s;
    const int q = tid;
    const float* f = io.src_f + ((long long)lane * cfg.sources + q) * 5;
    s.kind = cfg.kind[q];
    s.bipolar = cfg.bipolar[q];
    s.wave = min(max(io.src_i[lane * cfg.sources + q], 0), 6);
    // the voice's seed, SEED ^ (0x9E37 * voice number), plus the salt
    const long long seed = (0x7157LL ^ (0x9E37LL * (v + 1))) + cfg.salt[q];
    s.seed = (unsigned)(seed & 0xFFFFFFFFLL);
    s.inc = f[0];
    s.env = Env{f[0], f[1], f[2], f[3], f[4]};
    const int ts[2] = {cfg.t_shape, cfg.t_cut};
    for (int j = 0; j < 2; ++j) {
      const long long at =
          ((long long)lane * cfg.sources + q) * cfg.targets + max(ts[j], 0);
      s.amt[j] = ts[j] >= 0 ? io.amounts[at] : 0.0f;
      s.routed[j] = ts[j] >= 0 && io.routed[at] > 0.5f;
    }
    src[q] = s;
  }
  __syncthreads();

  const int* ttime = io.trig_time + (long long)r * K;
  const float* tr[5];
#pragma unroll
  for (int j = 0; j < 5; ++j) tr[j] = io.trig + ((long long)j * R + r) * K;
  float cv[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) cv[j] = io.cont[(long long)j * R + r];
  const bool c_on = cv[0] > 0.5f;
  const long long age0 = io.age0[r];
  const float* par[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) par[j] = io.par[j] + ln;
  const float* au[3] = {nullptr, nullptr, nullptr};
  if (cfg.has_auto)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      au[j] = io.automation + ((long long)j * R + r) * (K + 1) * n;
  const EnvNote amp = env_note(cfg.amp, 1.0f);

  double p0[kOsc], carry[kOsc] = {0.0, 0.0, 0.0};
#pragma unroll
  for (int k = 0; k < kOsc; ++k) p0[k] = (double)io.phase0[r * 3 + k];

  // the thread's current slot (monotone in the sample) and its values
  int s = 0;
  int next_t = K > 0 ? ttime[0] : INT_MAX;
  long long base = age0;  // age = sample + base
  float nt = cv[1], vol = cv[2], pn = cv[3], spd = cv[4], rl = cv[5];
  float prev_note = cv[1];
  // memos of the float64 exp2s: argument -> value
  float hz_in = nanf(""), hz_out = 0.0f, sp_in = nanf(""), sp_out = 1.0f;
  float dt_in = nanf(""), dt_out = 1.0f;
  float rel_in = nanf(""), rel_out = 0.0f;

  int par_ = 0;
  for (int t0 = 0; t0 < n; t0 += kTile, par_ ^= 1) {
    const int i0 = t0 + tid * kPer;
    Sample sm[kPer];
    double loc[kOsc] = {0.0, 0.0, 0.0};
    // pass A: each sample's note and frequencies, the phase steps' sums
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      // past the block's end the thread repeats its last sample, unwritten
      const int i = min(i0 + j, n - 1);
      if (next_t <= i) {
        do {
          ++s;
          next_t = s < K ? ttime[s] : INT_MAX;
        } while (next_t <= i);
        nt = tr[0][s - 1];
        vol = tr[1][s - 1];
        pn = tr[2][s - 1];
        spd = tr[3][s - 1];
        rl = tr[4][s - 1];
        base = -(long long)ttime[s - 1];
        prev_note = s >= 2 ? tr[0][s - 2] : cv[1];
      }
      Sample& x = sm[j];
      const long long age = (long long)i + base;
      x.agef = __ll2float_rn(age);
      x.note = nt;
      x.rel = rl;
      x.active = s > 0 || c_on;
      float sp = spd;
      x.vel = vol;
      x.pan = pn;
      if (cfg.has_auto) {
        const long long at = (long long)s * n + i;
        x.vel = au[0][at];
        x.pan = au[1][at];
        sp = au[2][at];
      }
      float fn = nt;
      if (cfg.glide && s > 0 && (c_on || s > 1)) {
        const float prog = fminf(fmaxf(mul(x.agef, cfg.rglide), 0.0f), 1.0f);
        fn = add(prev_note, mul(sub(nt, prev_note), prog));
      }
      if (fn != hz_in) {
        hz_in = fn;
        hz_out = note_to_hz(fn);
      }
      if (nt != sp_in) {
        sp_in = nt;
        sp_out = note_speed(nt);
      }
      x.freq = mul(hz_out, dvd(sp, sp_out));
      const float dc = par[1][i];
      if (dc != dt_in) {
        dt_in = dc;
        dt_out = __double2float_rn(exp2((double)mul(dc, 1.0f / 1200.0f)));
      }
      x.det = dt_out;
      const float f[kOsc] = {x.freq, mul(x.freq, x.det), dvd(x.freq, x.det)};
      if (i0 + j < n)
#pragma unroll
        for (int k = 0; k < kOsc; ++k)
          loc[k] = __dadd_rn(loc[k], (double)mul(f[k], cfg.rsr));
    }
    double excl[kOsc], total[kOsc];
    scan3(loc, excl, total, sums[par_]);

    // pass B, stage by stage over the thread's samples (independent chains
    // in straight-line code, which the compiler interleaves): the matrix,
    // the oscillators, the envelope, the SVF's coefficients, the writes
    int iv[kPer];
    float agef[kPer], c[kPer], shape[kPer], cut_p[kPer], mix[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      iv[j] = min(i0 + j, n - 1);
      agef[j] = fmaxf(sm[j].agef, 0.0f);
      c[j] = add(sm[j].agef, 1.0f);
      shape[j] = par[0][iv[j]];
      cut_p[j] = par[2][iv[j]];
      mix[j] = 0.0f;
    }
    // the modulation matrix's offsets to the shape and the cutoff
    float mod[2][kPer];
    for (int q = 0; q < cfg.sources; ++q) {
      const Source& so = src[q];
      float val[kPer];
      if (so.kind == 0) {
        lfo4(so, agef, val);
      } else if (so.kind == 1) {
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          const EnvNote e = env_note(so.env, sm[j].vel);
          val[j] = env_value(so.env, e, c[j], sm[j].rel,
                             env_release_level(so.env, e, sm[j].rel));
        }
      } else if (so.kind == 2) {
#pragma unroll
        for (int j = 0; j < kPer; ++j) val[j] = sm[j].vel;
      } else {
#pragma unroll
        for (int j = 0; j < kPer; ++j)
          val[j] = mul(sm[j].note, 1.0f / 127.0f);
      }
#pragma unroll
      for (int t = 0; t < 2; ++t) {
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          float u;
          if (so.bipolar)
            u = so.routed[t] ? val[j] : mul(add(val[j], 1.0f), 0.5f);
          else
            u = so.routed[t] ? mul(sub(val[j], 0.5f), 2.0f) : val[j];
          const float term = mul(u, so.amt[t]);
          mod[t][j] = q == 0 ? term : add(mod[t][j], term);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if (cfg.t_shape >= 0) shape[j] = add(shape[j], mod[0][j]);
      if (cfg.t_cut >= 0) cut_p[j] = mul(cut_p[j], add(1.0f, mod[1][j]));
    }
    // the oscillators: the phases from the scan, then the morphs
#pragma unroll
    for (int k = 0; k < kOsc; ++k) {
      float ph[kPer], dt[kPer];
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const Sample& x = sm[j];
        const float f = k == 0   ? x.freq
                        : k == 1 ? mul(x.freq, x.det)
                                 : dvd(x.freq, x.det);
        dt[j] = mul(f, cfg.rsr);
        excl[k] = __dadd_rn(excl[k], (double)dt[j]);
        const double csum = __dadd_rn(carry[k], excl[k]);
        ph[j] = wrap(__dadd_rn(p0[k], __dsub_rn(csum, (double)dt[j])));
      }
      morph4(ph, shape, dt, mix);
    }
    // the amp envelope, the SVF, the gains
    float out[6 + kMaxGains][kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const Sample& x = sm[j];
      if (x.rel != rel_in) {
        rel_in = x.rel;
        rel_out = env_release_level(cfg.amp, amp, x.rel);
      }
      const float env = env_value(cfg.amp, amp, c[j], x.rel, rel_out);
      const float m = mul(mix[j], 1.0f / 3.0f);
      const float cut = fminf(fmaxf(mul(cut_p[j], add(mul(env, f32(0.8)),
                                                      f32(0.2))),
                                    20.0f),
                              cfg.nyquist);
      const float g = tanf(mul(mul(f32(kPi), cut), cfg.rsr));
      const float kd = fmaxf(
          mul(2.0f, sub(1.0f, mul(par[3][iv[j]], f32(0.97)))), f32(0.03));
      const float a1 = dvd(1.0f, add(1.0f, mul(g, add(g, kd))));
      const float a2 = mul(g, a1);
      const float a3 = mul(g, a2);
      out[0][j] = sub(mul(2.0f, a1), 1.0f);
      out[1][j] = add(mul(a2, -2.0f), 0.0f);
      out[2][j] = add(mul(2.0f, a2), 0.0f);
      out[3][j] = sub(1.0f, mul(2.0f, a3));
      out[4][j] = mul(mul(2.0f, a2), m);
      out[5][j] = mul(mul(2.0f, a3), m);
      // env x volume x velocity x active, and the pan law's factors
      const float eg = mul(env, mul(mul(par[4][iv[j]], x.vel),
                                    x.active ? 1.0f : 0.0f));
      float pan = fminf(fmaxf(add(par[5][iv[j]], x.pan), -1.0f), 1.0f);
      pan = fminf(fmaxf(pan, -1.0f), 1.0f);
      const float nrm = mul(add(pan, 1.0f), 0.5f);
      out[6][j] = cfg.gains == 1 ? eg
                  : mul(eg, mul(sqrtf(sub(1.0f, nrm)),
                                f32(1.4142135623730951)));
      out[7][j] = mul(eg, mul(sqrtf(nrm), f32(1.4142135623730951)));
      out[8][j] = eg;
    }
    // the writes: 4 consecutive floats per thread and stream
    const int cnt = min(max(n - i0, 0), kPer);
#pragma unroll
    for (int o = 0; o < 6 + kMaxGains; ++o) {
      if (o >= 6 + cfg.gains) break;
      const long long at = (long long)(o < 6 ? o : o - 6) * R * n + rn + i0;
      float* dst = (o < 6 ? io.operands : io.gains) + at;
      if (cnt == kPer && (at & 3) == 0) {  // the buffers are 16-byte aligned
        *reinterpret_cast<float4*>(dst) =
            make_float4(out[o][0], out[o][1], out[o][2], out[o][3]);
      } else {
#pragma unroll
        for (int j = 0; j < kPer; ++j)
          if (j < cnt) dst[j] = out[o][j];
      }
    }
#pragma unroll
    for (int k = 0; k < kOsc; ++k) carry[k] = __dadd_rn(carry[k], total[k]);
  }
  if (tid == 0)
#pragma unroll
    for (int k = 0; k < kOsc; ++k)
      io.phase_end[r * 3 + k] = wrap(__dadd_rn(p0[k], carry[k]));
}

// kernel 11: the lowpass tap of each row times its gains, summed over each
// lane's voices; the new SVF state
__global__ void __launch_bounds__(kMixThreads)
    synth_mix_kernel(const float* s1, const float* s2, const float* ic1,
                     const float* ic2, const float* gains, float* out,
                     float* ic1_out, float* ic2_out, int nv, int n, int g,
                     int channels, long long rows) {
  const int lane = blockIdx.y;
  const int i = blockIdx.x * kMixThreads + threadIdx.x;
  if (i >= n) return;
  float acc[kMaxGains] = {0.0f, 0.0f, 0.0f};
  for (int v = 0; v < nv; ++v) {
    const long long r = (long long)lane * nv + v;
    const long long at = r * n + i;
    const float prev = i > 0 ? s2[at - 1] : ic2[r];
    const float y = mul(0.5f, add(s2[at], prev));
    for (int k = 0; k < g; ++k)
      acc[k] = add(acc[k], mul(y, gains[(long long)k * rows * n + at]));
    if (i == n - 1) {
      ic1_out[r] = s1[at];
      ic2_out[r] = s2[at];
    }
  }
  for (int c = 0; c < channels; ++c)
    out[((long long)lane * channels + c) * n + i] =
        acc[g == 1 ? 0 : min(c, g - 1)];
}

}  // namespace

// Kernel 10 over R = lanes * nv voice rows of n samples.  cfg_i and cfg_f
// are host arrays (ops/synthvoice.py voice_kernel lays them out); every
// other pointer is a device array.
extern "C" int phonic_synth_voice(
    int device, const int* cfg_i, const float* cfg_f, const int* trig_time,
    const float* trig, const int* age0, const float* cont,
    const float* automation, const float* shape, const float* detune,
    const float* cutoff, const float* resonance, const float* volume,
    const float* panning, const float* src_f, const int* src_i,
    const float* amounts, const float* routed, const float* phase0,
    float* operands, float* gains, float* phase_end, void* stream) {
  Cfg cfg;
  cfg.n = cfg_i[0];
  cfg.k = cfg_i[1];
  cfg.nv = cfg_i[2];
  cfg.lanes = cfg_i[3];
  cfg.gains = cfg_i[4];
  cfg.sources = cfg_i[5];
  cfg.targets = cfg_i[6];
  cfg.t_shape = cfg_i[7];
  cfg.t_cut = cfg_i[8];
  cfg.has_auto = cfg_i[9];
  cfg.glide = cfg_i[10];
  for (int q = 0; q < kMaxSources; ++q) {
    cfg.kind[q] = cfg_i[11 + q];
    cfg.salt[q] = (unsigned)cfg_i[11 + kMaxSources + q];
    cfg.bipolar[q] = cfg_i[11 + 2 * kMaxSources + q];
  }
  cfg.rsr = cfg_f[0];
  cfg.rglide = cfg_f[1];
  cfg.nyquist = cfg_f[2];
  cfg.amp = Env{cfg_f[3], cfg_f[4], cfg_f[5], cfg_f[6], cfg_f[7]};
  const long long rows = (long long)cfg.lanes * cfg.nv;
  if (cfg.n < 1 || cfg.k < 1 || cfg.nv < 1 || cfg.lanes < 1 ||
      cfg.gains < 1 || cfg.gains > kMaxGains || cfg.sources < 0 ||
      cfg.sources > kMaxSources || rows > 0x7FFFFFFFLL ||
      (cfg.sources > 0 && (cfg.targets < 1 || cfg.t_shape >= cfg.targets ||
                           cfg.t_cut >= cfg.targets)) ||
      (cfg.has_auto && automation == nullptr))
    return (int)cudaErrorInvalidValue;
  DeviceGuard on(device);
  if (on.err != cudaSuccess) return (int)on.err;
  VoiceIo io;
  io.trig_time = trig_time;
  io.trig = trig;
  io.age0 = age0;
  io.cont = cont;
  io.automation = automation;
  io.par[0] = shape;
  io.par[1] = detune;
  io.par[2] = cutoff;
  io.par[3] = resonance;
  io.par[4] = volume;
  io.par[5] = panning;
  io.src_f = src_f;
  io.src_i = src_i;
  io.amounts = amounts;
  io.routed = routed;
  io.phase0 = phase0;
  io.operands = operands;
  io.gains = gains;
  io.phase_end = phase_end;
  synth_voice_kernel<<<(unsigned)rows, kThreads, 0, (cudaStream_t)stream>>>(
      io, cfg);
  return (int)cudaGetLastError();
}

// Kernel 11 over lanes * nv rows of n samples and g gain streams into
// [lanes, channels, n].
extern "C" int phonic_synth_mix(int device, const float* s1, const float* s2,
                                const float* ic1, const float* ic2,
                                const float* gains, float* out,
                                float* ic1_out, float* ic2_out, int lanes,
                                int nv, int n, int g, int channels,
                                void* stream) {
  if (lanes < 1 || lanes > 65535 || nv < 1 || n < 1 || g < 1 ||
      g > kMaxGains || channels < 1)
    return (int)cudaErrorInvalidValue;
  DeviceGuard on(device);
  if (on.err != cudaSuccess) return (int)on.err;
  const dim3 grid((n + kMixThreads - 1) / kMixThreads, lanes);
  synth_mix_kernel<<<grid, kMixThreads, 0, (cudaStream_t)stream>>>(
      s1, s2, ic1, ic2, gains, out, ic1_out, ic2_out, nv, n, g, channels,
      (long long)lanes * nv);
  return (int)cudaGetLastError();
}

// Per-sample dynamics recurrences (kernels 4, 5).
//
//   follower:  a = in > env ? attack : release;  env += a * (in - env)
//   gate:      the follower, then the open / hold / closed machine
//              (open when env >= threshold; the hold counter reloads while
//              open and counts down after; the target gain is 0 dB while
//              open or holding, else the range), then the gain in dB
//              follows its target with the same attack / release pair
//
// over [R, n] row-major streams (rows x time), with the state carried per
// row: env [R] for the follower, (env, hold, gain_db) [R, 3] for the gate.
//
// Replaces the TPU kernels phonic_tpu/ops/follower.py:_follower_kernel and
// _gate_kernel (entered via asym_follower / gate_machine), which ran the same
// loop on the TPU's scalar core over a sequential (row, chunk) grid, with
// each chunk's inputs staged in SMEM and the state carried across chunks in
// SMEM scratch.
//
// What bounds it here: the recurrence branches on its own state, so it is
// no associative scan; each row is one dependent chain.  The bytes (3 or 6
// input floats and one output float per sample) would stream in well under
// a microsecond per 131072 samples, so the longest loop-carried path sets
// the time: 4 dependent operations per sample (compare, select, multiply,
// add; the subtract runs beside the compare) at ~4 cycles each.
//
// Follower design: one block per row.  Its 256 threads stage each tile of
// kTile samples of the row's input streams from device memory into shared
// memory with coalesced 4-byte cp.async copies, double-buffered so the next
// tile loads while this one runs; thread 0 runs the recurrence out of shared
// memory into a shared output tile, which the block then stores coalesced.
// So the serial thread never waits on device memory, only on its own chain.
//
// The gate carries three values, each depending only on its own previous
// value and this sample's inputs: the envelope env (compare, select,
// multiply, add: 4 deep), the hold counter (subtract, max, select: 3 deep)
// and the gain gain_db (4 deep, reading target[i], which comes from env[i]
// and hold[i-1] outside the gain's loop).  Its longest loop-carried path is
// 4 operations, as the follower's, but one thread issuing all ~15
// operations and 6 loads of a sample stays above the 16 cycles that path
// needs, and a store into the shared array it loads from keeps the next
// sample's loads behind it.  Gate design, one block per row:
//   - a producer thread (warp 0) runs env and hold and writes target[i]
//     into a ring of two tiles in shared memory; a consumer thread (warp 1,
//     another scheduler) runs the gain over target, attack and release one
//     tile behind, into an output tile of its own.  Both evaluate the
//     follower step with its compare and select last (follow_late), so the
//     select, not the compare, sits on the loop-carried path.  The
//     producer issues about 16 instructions per sample, the consumer about
//     9 (cuobjdump -sass), against one warp's one instruction per cycle;
//   - both read their inputs as float4, one 16-byte load per stream per 4
//     samples, loaded one group ahead into registers, and store targets
//     and gains 4 at a time into arrays they never load from, so no shared
//     load waits on the dependent floating-point path;
//   - the other six warps stage tile t + 1 (4-byte cp.async, any row length
//     and alignment) into a ring of four tile buffers and store the gains
//     of tile t - 2 to device memory.  The block meets once per tile of
//     kGateTile samples (one barrier), never per sample.
//
// Arithmetic: each step is written with __fsub_rn / __fmul_rn / __fadd_rn,
// so nvcc cannot contract env + a * (in - env) into a fused multiply-add;
// every operation rounds to float32 once, as in the plain PyTorch version
// (ops/follower.py) and the JAX package's XLA scan, and the kernels agree
// with the plain versions bit for bit.  Splitting the gate's chains over
// two threads keeps every operation and its order, so no rounding changes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 2048;

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most one committed group (the newest) is still in flight
__device__ __forceinline__ void cp_async_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ float follow(float env, float in, float attack,
                                        float release) {
  const float a = in > env ? attack : release;
  return __fadd_rn(env, __fmul_rn(a, __fsub_rn(in, env)));
}

// v: input_db, attack, release.  st: env.
struct Follower {
  static constexpr int kStreams = 3;
  static constexpr int kState = 1;
  __device__ __forceinline__ static float step(float* st, const float* v) {
    st[0] = follow(st[0], v[0], v[1], v[2]);
    return st[0];
  }
};

template <int K>
struct Streams {
  const float* p[K];
};

template <class M>
constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * M::kStreams + 1) * kTile;
}

// Copy samples [t0, t0 + len) of each stream of this row into
// stage[k * stride + .], threads first, first + step, ... of the block.
template <int K>
__device__ __forceinline__ void stage_tile(float* stage, int stride,
                                           const Streams<K>& rows, long long t0,
                                           int len, int first, int step) {
#pragma unroll
  for (int k = 0; k < K; ++k)
    for (int i = first; i < len; i += step)
      cp_async4(stage + k * stride + i, rows.p[k] + t0 + i);
}
template <int K>
__device__ __forceinline__ void stage_tile(float* stage, const Streams<K>& rows,
                                           long long t0, int len) {
  stage_tile<K>(stage, kTile, rows, t0, len, threadIdx.x, blockDim.x);
}

template <class M>
__global__ void __launch_bounds__(kThreads)
    dynamics_kernel(Streams<M::kStreams> in, const float* __restrict__ st0,
                    float* __restrict__ out, float* __restrict__ st_out,
                    long long n) {
  constexpr int K = M::kStreams;
  extern __shared__ float smem[];  // [2][K][kTile] staged inputs, [kTile] output
  float* out_tile = smem + 2 * K * kTile;
  const size_t row = blockIdx.x;
  Streams<K> rows;
#pragma unroll
  for (int k = 0; k < K; ++k) rows.p[k] = in.p[k] + row * n;
  float* orow = out + row * n;
  float st[M::kState];
#pragma unroll
  for (int j = 0; j < M::kState; ++j) st[j] = st0[row * M::kState + j];

  const long long tiles = (n + kTile - 1) / kTile;
  auto tile_len = [n](long long t) {
    const long long rest = n - t * kTile;
    return (int)(rest < kTile ? rest : kTile);
  };
  if (tiles > 0) stage_tile<K>(smem, rows, 0, tile_len(0));
  cp_async_commit();
  for (long long t = 0; t < tiles; ++t) {
    const int len = tile_len(t);
    // the buffer refilled here was last read in iteration t - 1, before
    // its closing barrier
    if (t + 1 < tiles)
      stage_tile<K>(smem + ((t + 1) & 1) * K * kTile, rows, (t + 1) * kTile,
                    tile_len(t + 1));
    cp_async_commit();
    cp_async_wait_all_but_one();
    __syncthreads();
    if (threadIdx.x == 0) {
      const float* cur = smem + (t & 1) * K * kTile;
#pragma unroll 4
      for (int i = 0; i < len; ++i) {
        float v[K];
#pragma unroll
        for (int k = 0; k < K; ++k) v[k] = cur[k * kTile + i];
        out_tile[i] = M::step(st, v);
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < len; i += blockDim.x)
      orow[t * kTile + i] = out_tile[i];
  }
  if (threadIdx.x == 0) {
#pragma unroll
    for (int j = 0; j < M::kState; ++j) st_out[row * M::kState + j] = st[j];
  }
}

// ---------------------------------------------------------------- gate

constexpr int kGateTile = 1024;
// staged input tiles: the loaders stage tile t + 1 while the producer may
// still run tile t - 1 and the consumer tile t - 2, and tile t lands
constexpr int kGateStages = 4;
// one stream of a staged tile or of the target ring; 4 floats of slack let
// the producer and the consumer load the group after a tile's last one
// without a bounds check
constexpr int kGateStride = kGateTile + 4;
// input_db, attack, release, threshold, range_db, hold_samples
constexpr int kGateStreams = 6;
constexpr int kLoaderFirst = 64;  // warps 2.. stage and store

constexpr size_t gate_smem_bytes() {
  // staged tiles, the target ring [2][kGateStride], the gain tiles [2][tile]
  return sizeof(float) *
         ((kGateStages * kGateStreams + 2) * kGateStride + 2 * kGateTile);
}

// follow() with the same rounded operations in another order: both
// candidate envelopes first, the compare-and-select last.  The
// loop-carried path becomes subtract, multiply, add, select, with the
// compare beside the arithmetic.  On an H100 it ran the gate's two chains
// faster than follow() and the follower's single one slower (PERF.md).
__device__ __forceinline__ float follow_late(float env, float in, float attack,
                                             float release) {
  const float d = __fsub_rn(in, env);
  const float up = __fadd_rn(env, __fmul_rn(attack, d));
  const float down = __fadd_rn(env, __fmul_rn(release, d));
  return in > env ? up : down;
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float elem(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// env and hold one sample on; returns the target gain (0 dB or the range)
__device__ __forceinline__ float gate_target(float& env, float& hold, float in,
                                             float attack, float release,
                                             float threshold, float range,
                                             float hold_samples) {
  env = follow_late(env, in, attack, release);
  const bool is_open = env >= threshold;
  const float target = (is_open || hold > 0.0f) ? 0.0f : range;
  hold = is_open ? hold_samples : fmaxf(__fsub_rn(hold, 1.0f), 0.0f);
  return target;
}

// Producer: env and hold over one staged tile (streams at in + k *
// kGateStride), targets into tgt[0, len).
__device__ __forceinline__ void gate_produce(const float* in, float* tgt,
                                             int len, float& env, float& hold) {
  constexpr int S = kGateStride;
  float4 x = lds4(in), aa = lds4(in + S), ra = lds4(in + 2 * S),
         thr = lds4(in + 3 * S), rng = lds4(in + 4 * S), hs = lds4(in + 5 * S);
  int i = 0;
  for (; i + 4 <= len; i += 4) {
    const int j = i + 4;  // the next group, loaded before this one runs
    const float4 nx = lds4(in + j), naa = lds4(in + S + j),
                 nra = lds4(in + 2 * S + j), nthr = lds4(in + 3 * S + j),
                 nrng = lds4(in + 4 * S + j), nhs = lds4(in + 5 * S + j);
    float4 t;
    t.x = gate_target(env, hold, x.x, aa.x, ra.x, thr.x, rng.x, hs.x);
    t.y = gate_target(env, hold, x.y, aa.y, ra.y, thr.y, rng.y, hs.y);
    t.z = gate_target(env, hold, x.z, aa.z, ra.z, thr.z, rng.z, hs.z);
    t.w = gate_target(env, hold, x.w, aa.w, ra.w, thr.w, rng.w, hs.w);
    *reinterpret_cast<float4*>(tgt + i) = t;
    x = nx, aa = naa, ra = nra, thr = nthr, rng = nrng, hs = nhs;
  }
  for (int j = 0; i < len; ++i, ++j)  // ragged end of the last tile
    tgt[i] = gate_target(env, hold, elem(x, j), elem(aa, j), elem(ra, j),
                         elem(thr, j), elem(rng, j), elem(hs, j));
}

// Consumer: the gain over one tile's targets, attack and release, into
// out[0, len).
__device__ __forceinline__ void gate_consume(const float* in, const float* tgt,
                                             float* out, int len, float& gain) {
  constexpr int S = kGateStride;
  float4 t = lds4(tgt), aa = lds4(in + S), ra = lds4(in + 2 * S);
  int i = 0;
  for (; i + 4 <= len; i += 4) {
    const int j = i + 4;
    const float4 nt = lds4(tgt + j), naa = lds4(in + S + j),
                 nra = lds4(in + 2 * S + j);
    float4 g;
    g.x = gain = follow_late(gain, t.x, aa.x, ra.x);
    g.y = gain = follow_late(gain, t.y, aa.y, ra.y);
    g.z = gain = follow_late(gain, t.z, aa.z, ra.z);
    g.w = gain = follow_late(gain, t.w, aa.w, ra.w);
    *reinterpret_cast<float4*>(out + i) = g;
    t = nt, aa = naa, ra = nra;
  }
  for (int j = 0; i < len; ++i, ++j)
    out[i] = gain = follow_late(gain, elem(t, j), elem(aa, j), elem(ra, j));
}

__global__ void __launch_bounds__(kThreads)
    gate_kernel(Streams<kGateStreams> in, const float* __restrict__ st0,
                float* __restrict__ out, float* __restrict__ st_out,
                long long n) {
  extern __shared__ float4 gate_smem4[];
  float* stage = reinterpret_cast<float*>(gate_smem4);  // [4][6][kGateStride]
  float* ring = stage + kGateStages * kGateStreams * kGateStride;
  float* gains = ring + 2 * kGateStride;
  const size_t row = blockIdx.x;
  Streams<kGateStreams> rows;
#pragma unroll
  for (int k = 0; k < kGateStreams; ++k) rows.p[k] = in.p[k] + row * n;
  float* orow = out + row * n;
  const bool producer = threadIdx.x == 0;
  const bool consumer = threadIdx.x == 32;
  const bool loader = threadIdx.x >= kLoaderFirst;
  float env = st0[row * 3], hold = st0[row * 3 + 1], gain = st0[row * 3 + 2];

  const long long tiles = (n + kGateTile - 1) / kGateTile;
  auto tile_len = [n](long long t) {
    const long long rest = n - t * kGateTile;
    return (int)(rest < kGateTile ? rest : kGateTile);
  };
  auto buf = [stage](long long t) {
    return stage + (t % kGateStages) * kGateStreams * kGateStride;
  };
  if (loader) {
    if (tiles > 0)
      stage_tile<kGateStreams>(buf(0), kGateStride, rows, 0, tile_len(0),
                               threadIdx.x - kLoaderFirst,
                               blockDim.x - kLoaderFirst);
    cp_async_commit();
  }
  // iteration t: the producer runs tile t, the consumer tile t - 1, the
  // loaders stage tile t + 1 and store the gains of tile t - 2
  for (long long t = 0; t < tiles + 2; ++t) {
    if (loader) {
      // buffer t + 1 last held tile t - 3, done before the last barrier
      if (t + 1 < tiles)
        stage_tile<kGateStreams>(buf(t + 1), kGateStride, rows,
                                 (t + 1) * kGateTile, tile_len(t + 1),
                                 threadIdx.x - kLoaderFirst,
                                 blockDim.x - kLoaderFirst);
      cp_async_commit();
      cp_async_wait_all_but_one();
    }
    __syncthreads();
    if (producer && t < tiles)
      gate_produce(buf(t), ring + (t & 1) * kGateStride, tile_len(t), env,
                   hold);
    if (consumer && t >= 1 && t <= tiles)
      gate_consume(buf(t - 1), ring + ((t - 1) & 1) * kGateStride,
                   gains + ((t - 1) & 1) * kGateTile, tile_len(t - 1), gain);
    if (loader && t >= 2) {
      const float* g = gains + (t & 1) * kGateTile;  // tile t - 2
      const int len = tile_len(t - 2);
      for (int i = threadIdx.x - kLoaderFirst; i < len;
           i += blockDim.x - kLoaderFirst)
        orow[(t - 2) * kGateTile + i] = g[i];
    }
  }
  if (producer) {
    st_out[row * 3] = env;
    st_out[row * 3 + 1] = hold;
  }
  if (consumer) st_out[row * 3 + 2] = gain;
}

template <class M>
int launch(int device, Streams<M::kStreams> in, const float* st0, float* out,
           float* st_out, int rows, long long n, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(dynamics_kernel<M>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_bytes<M>());
  if (err != cudaSuccess) return (int)err;
  dynamics_kernel<M><<<rows, kThreads, smem_bytes<M>(), (cudaStream_t)stream>>>(
      in, st0, out, st_out, n);
  return (int)cudaGetLastError();
}

}  // namespace

// env [rows, n] and env_end [rows] from input_db, attack, release [rows, n]
// and env0 [rows].
extern "C" int phonic_follower(int device, const float* in_db,
                               const float* attack, const float* release,
                               const float* env0, float* env, float* env_end,
                               int rows, long long n, void* stream) {
  return launch<Follower>(device, {{in_db, attack, release}}, env0, env,
                          env_end, rows, n, stream);
}

// gains_db [rows, n] and the final (env, hold, gain_db) [rows, 3] from six
// [rows, n] streams and the initial state [rows, 3].
extern "C" int phonic_gate(int device, const float* in_db, const float* attack,
                           const float* release, const float* threshold,
                           const float* range_db, const float* hold_samples,
                           const float* state0, float* gains_db, float* state,
                           int rows, long long n, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(gate_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)gate_smem_bytes());
  if (err != cudaSuccess) return (int)err;
  gate_kernel<<<rows, kThreads, gate_smem_bytes(), (cudaStream_t)stream>>>(
      {{in_db, attack, release, threshold, range_db, hold_samples}}, state0,
      gains_db, state, n);
  return (int)cudaGetLastError();
}

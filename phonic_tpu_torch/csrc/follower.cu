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
// no associative scan; each row is one dependent chain, about 4 operations
// per sample for the follower (compare, select, subtract, multiply-add as
// two rounded operations) and about 10 for the gate.  On one thread that
// chain, not memory, sets the time: the bytes (3 or 6 input floats and one
// output float per sample) would stream in well under a microsecond per
// 131072 samples.
//
// Design: one block per row.  Its 256 threads stage each tile of kTile
// samples of the row's input streams from device memory into shared memory
// with coalesced 4-byte cp.async copies, double-buffered so the next tile
// loads while this one runs; thread 0 runs the recurrence out of shared
// memory into a shared output tile, which the block then stores coalesced.
// So the serial thread never waits on device memory, only on its own chain.
//
// Arithmetic: each step is written with __fsub_rn / __fmul_rn / __fadd_rn,
// so nvcc cannot contract env + a * (in - env) into a fused multiply-add;
// every operation rounds to float32 once, as in the plain PyTorch version
// (ops/follower.py) and the JAX package's XLA scan, and the kernel agrees
// with the plain version bit for bit.

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

// v: input_db, attack, release, threshold, range_db, hold_samples.
// st: env, hold, gain_db.  Returns the gain in dB.
struct Gate {
  static constexpr int kStreams = 6;
  static constexpr int kState = 3;
  __device__ __forceinline__ static float step(float* st, const float* v) {
    const float env = follow(st[0], v[0], v[1], v[2]);
    const float hold = st[1];
    const bool is_open = env >= v[3];
    const float target = (is_open || hold > 0.0f) ? 0.0f : v[4];
    st[1] = is_open ? v[5] : fmaxf(__fsub_rn(hold, 1.0f), 0.0f);
    const float a = target > st[2] ? v[1] : v[2];
    st[2] = __fadd_rn(st[2], __fmul_rn(a, __fsub_rn(target, st[2])));
    st[0] = env;
    return st[2];
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

// Copy samples [t0, t0 + len) of each stream of this row into stage[k][.].
template <int K>
__device__ __forceinline__ void stage_tile(float* stage, const Streams<K>& rows,
                                           long long t0, int len) {
#pragma unroll
  for (int k = 0; k < K; ++k)
    for (int i = threadIdx.x; i < len; i += blockDim.x)
      cp_async4(stage + k * kTile + i, rows.p[k] + t0 + i);
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
  return launch<Gate>(
      device, {{in_db, attack, release, threshold, range_db, hold_samples}},
      state0, gains_db, state, rows, n, stream);
}

"""Per-sample nonlinear dynamics recurrences: the asymmetric envelope
follower and the gate state machine (port of ``phonic_tpu/ops/follower.py``).

Behavioural spec: reference src/effect/compressor.rs (dB-domain
attack/release follower, :283-301) and src/effect/gate.rs (envelope ->
open/hold/closed machine -> gain smoothing, :147-195).

Both recurrences branch on their carried state (attack or release is chosen
by comparing the input with the running envelope), so neither is an
associative scan: each row is one sequential chain.  Rows run batched:
streams ``[G, n]``, states ``[G]``.

Routing is by the device of the tensors:

- CUDA tensors run the hand-written kernels in ``csrc/follower.cu``
  (:func:`follower` / :func:`gate`), always, or raise;
- CPU tensors run the plain PyTorch versions :func:`follower_plain` /
  :func:`gate_plain`: a loop over time, vectorised over rows, one rounded
  float32 operation at a time (no fused multiply-add), which the kernels
  match bit for bit.
"""

from __future__ import annotations

import torch

from .. import kernels, tracing


def follower_plain(in_db, attack_a, release_a, env0):
    """Plain version of :func:`follower`: streams [G, n], env0 [G].
    Returns (env_end [G], envelope [G, n])."""
    env = env0.clone()
    xs, aas, ras = in_db.unbind(-1), attack_a.unbind(-1), release_a.unbind(-1)
    out = []
    for x, aa, ra in zip(xs, aas, ras):
        a = torch.where(x > env, aa, ra)
        env = env + a * (x - env)
        out.append(env)
    if not out:
        return env, in_db.new_empty(in_db.shape)
    return env, torch.stack(out, dim=-1)


def gate_plain(in_db, attack_a, release_a, threshold, range_db, hold_samples,
               env0, hold0, gain0):
    """Plain version of :func:`gate`: six streams [G, n], states [G].
    Returns ((env, hold, gain_db) [G] each, gains_db [G, n])."""
    env, hold, gain = env0.clone(), hold0.clone(), gain0.clone()
    streams = zip(*(s.unbind(-1) for s in (in_db, attack_a, release_a,
                                             threshold, range_db, hold_samples)))
    zero = torch.zeros_like(env)
    out = []
    for x, aa, ra, thr, rng, hs in streams:
        a = torch.where(x > env, aa, ra)
        env = env + a * (x - env)
        is_open = env >= thr
        target = torch.where(is_open | (hold > 0.0), zero, rng)
        hold = torch.where(is_open, hs, torch.clamp(hold - 1.0, min=0.0))
        a2 = torch.where(target > gain, aa, ra)
        gain = gain + a2 * (target - gain)
        out.append(gain)
    if not out:
        return (env, hold, gain), in_db.new_empty(in_db.shape)
    return (env, hold, gain), torch.stack(out, dim=-1)


def _check_streams(streams, names, what):
    """Validate [G, n] kernel streams; returns (G, n)."""
    ref = streams[0]
    for x, name in zip(streams, names):
        kernels.require(x, f"{what} {name}", ndim=2, device=ref.device)
        if x.shape != ref.shape:
            raise ValueError(f"{what} {name}: shape {tuple(x.shape)}, "
                             f"expected {tuple(ref.shape)}")
    g, n = ref.shape
    if not 0 < g <= 2**31 - 1:
        raise ValueError(f"{what}: {g} rows (1..2**31-1 supported)")
    return g, n


def follower(in_db, attack_a, release_a, env0):
    """Kernel 4 (``csrc/follower.cu``): the asymmetric follower over
    contiguous float32 CUDA streams [G, n] from env0 [G].
    Returns (env_end [G], envelope [G, n])."""
    g, n = _check_streams((in_db, attack_a, release_a),
                          ("in_db", "attack_a", "release_a"), "follower")
    kernels.require(env0, "follower env0", ndim=1, device=in_db.device)
    if env0.shape[0] != g:
        raise ValueError(f"follower env0: {env0.shape[0]} rows, expected {g}")
    env = torch.empty_like(in_db)
    env_end = torch.empty_like(env0)
    err = kernels.library().phonic_follower(
        in_db.device.index, in_db.data_ptr(), attack_a.data_ptr(),
        release_a.data_ptr(), env0.data_ptr(), env.data_ptr(),
        env_end.data_ptr(), g, n, kernels.stream_handle(in_db))
    kernels.check(err, "follower")
    tracing.count("kernel.follower")
    return env_end, env


def gate(in_db, attack_a, release_a, threshold, range_db, hold_samples,
         state0):
    """Kernel 5 (``csrc/follower.cu``): the gate machine over six contiguous
    float32 CUDA streams [G, n] from state0 [G, 3] = (env, hold, gain_db).
    Returns (state [G, 3], gains_db [G, n])."""
    streams = (in_db, attack_a, release_a, threshold, range_db, hold_samples)
    g, n = _check_streams(streams, ("in_db", "attack_a", "release_a",
                                    "threshold", "range_db", "hold_samples"),
                          "gate")
    kernels.require(state0, "gate state0", ndim=2, device=in_db.device)
    if tuple(state0.shape) != (g, 3):
        raise ValueError(f"gate state0: shape {tuple(state0.shape)}, "
                         f"expected {(g, 3)}")
    gains = torch.empty_like(in_db)
    state = torch.empty_like(state0)
    err = kernels.library().phonic_gate(
        in_db.device.index, *(x.data_ptr() for x in streams),
        state0.data_ptr(), gains.data_ptr(), state.data_ptr(), g, n,
        kernels.stream_handle(in_db))
    kernels.check(err, "gate")
    tracing.count("kernel.gate")
    return state, gains


def _rows(x, shape):
    return x.expand(shape).contiguous()


def asym_follower(in_db, attack_a, release_a, env0):
    """dB-domain attack/release follower over one block.

    in_db [G, n]; attack_a / release_a broadcast against it; env0 [G].
    Returns (env_end [G], envelope [G, n])."""
    shape = in_db.shape
    args = [_rows(x, shape) for x in (in_db, attack_a, release_a)]
    if in_db.is_cuda:
        return follower(*args, env0.contiguous())
    return follower_plain(*args, env0)


def gate_machine(in_db, attack_a, release_a, threshold, range_db,
                 hold_samples, env0, hold0, gain0):
    """The gate recurrence over one block: streams broadcast against
    in_db [G, n], states [G].  Returns ((env, hold, gain_db), gains_db)."""
    shape = in_db.shape
    args = [_rows(x, shape) for x in (in_db, attack_a, release_a, threshold,
                                      range_db, hold_samples)]
    if in_db.is_cuda:
        state, gains = gate(*args, torch.stack([env0, hold0, gain0], dim=-1))
        return tuple(state.unbind(-1)), gains
    return gate_plain(*args, env0, hold0, gain0)

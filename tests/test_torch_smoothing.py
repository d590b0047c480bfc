"""phonic_tpu_torch/ops/smoothing.py against the JAX package.

The port runs each smoother over a group of rows at once; the JAX package
vmaps a one-row smoother.  Both get the same rows of scheduled events
(including duplicate times, events at sample 0 and empty slots) over two
blocks with the state carried across, and must agree: the linear smoother
and the stepped targets to float32 rounding of the same operations, the
exponential smoother to 1e-6 of the value range (its exp evaluations differ
by an ulp between the libraries).  The spring's closed form subtracts two
nearly equal eigen-terms (a critically damped spring has l1 ~ l2, and the
terms scale with 1/(l1 - l2)), which amplifies those ulps; it is held to
the engine-wide -90 dB of the value range.

The engine's entry, ``smooth_group``, is checked on the CPU: CPU tensors
take the plain version and never the kernel, a group's rows widen
lane-major as the engine carries lanes, and the kernel's host constants
round as PyTorch rounds the plain version's scalars (the kernel itself is
checked on the card, tests/test_torch_smoothing_cuda.py).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from phonic_tpu.ops import smoothing as js
from phonic_tpu_torch import tracing
from phonic_tpu_torch.ops import smoothing as ps

N = 1024
K = 6
SR = 48000


def _events(seed):
    """[P, K] times / values / ramps: sorted times, unused slots at N."""
    rng = np.random.default_rng(seed)
    p = 5
    times = np.full((p, K), N, np.int32)
    counts = [0, 1, 3, K, 2]
    for r, c in enumerate(counts):
        times[r, :c] = np.sort(rng.integers(0, N, c))
    times[3, 1] = times[3, 0]  # duplicate event times
    times[2, 0] = 0  # an event at the first sample
    values = rng.uniform(-2.0, 3.0, (p, K)).astype(np.float32)
    ramps = (rng.uniform(size=(p, K)) < 0.5).astype(np.float32)
    return times, values, ramps


def _initial():
    return np.asarray([0.5, -1.0, 2.0, 0.0, 1.5], np.float32)


def _run(jax_block, port_block, jax_init, port_init, bound):
    jstate, pstate = jax_init, port_init
    for block in range(2):
        t, v, r = _events(block)
        jev = js.SegmentEvents(jnp.asarray(t), jnp.asarray(v))
        jstate, jvals = jax_block(jstate, jev, jnp.asarray(r))
        pstate, pvals = port_block(pstate, ps.segment_events(t, v, N, "cpu"),
                                   torch.as_tensor(r))
        want = np.asarray(jvals)
        err = np.abs(pvals.numpy() - want).max()
        assert err <= bound * max(1.0, np.abs(want).max()), (block, err)
        ports = [pstate] if isinstance(pstate, torch.Tensor) else list(pstate)
        for a, b in zip(jax.tree.leaves(jstate), ports):
            err = np.abs(np.asarray(a) - b.numpy()).max()
            assert err <= bound * max(1.0, np.abs(np.asarray(a)).max()), (
                block, err)


def test_exponential():
    alpha = js.exp_alpha(1.0 / 256.0, SR)
    _run(jax.vmap(lambda s, e, r: js.exp_smoother_block(s, e, N, alpha)),
         lambda s, e, r: ps.exp_smoother_block(s, e, N, alpha),
         js.exp_smoother_init(jnp.asarray(_initial())),
         ps.exp_smoother_init(torch.as_tensor(_initial())), 1e-6)


def test_linear():
    _run(jax.vmap(lambda s, e, r: js.lin_smoother_block(s, e, N)),
         lambda s, e, r: ps.lin_smoother_block(s, e, N),
         js.lin_smoother_init(jnp.asarray(_initial()), 0.01, SR),
         ps.lin_smoother_init(torch.as_tensor(_initial()), 0.01, SR), 1e-6)


@pytest.mark.parametrize("duration", [4410.0, 300.0])
def test_spring(duration):
    omega = js.spring_omega(duration)
    _run(jax.vmap(lambda s, e, r: js.spring_smoother_block(s, e, N, omega, SR)),
         lambda s, e, r: ps.spring_smoother_block(s, e, N, omega, SR),
         js.spring_smoother_init(jnp.asarray(_initial())),
         ps.spring_smoother_init(torch.as_tensor(_initial())),
         10.0 ** (-90.0 / 20.0))


def test_step_targets():
    _run(jax.vmap(lambda s, e, r: js.step_targets(s, e, r, N)),
         lambda s, e, r: ps.step_targets(s, e, r, N),
         jnp.asarray(_initial()), torch.as_tensor(_initial()), 1e-6)


def test_live_segments_skip_only_empty_tails():
    """``live`` counts the segments that start inside the block: rows
    without events evaluate one segment, a full row all K+1."""
    t, v, _ = _events(0)
    assert ps.segment_events(t, v, N, "cpu").live == K + 1
    assert ps.segment_events(t[:1], v[:1], N, "cpu").live == 1


# ---------------------------------------------------------------------------
# smooth_group: the engine's entry, routed by device
# ---------------------------------------------------------------------------

GROUPS = (("exponential", 1.0 / 256.0), ("linear", 0.01), ("spring", 300.0),
          ("step", 0.0))


def _group_state(kind, arg, rows):
    v = torch.as_tensor(np.linspace(-1.0, 2.0, rows, dtype=np.float32))
    if kind == "exponential":
        return ps.exp_smoother_init(v)
    if kind == "linear":
        return ps.lin_smoother_init(v, arg, SR)
    if kind == "spring":
        return ps.spring_smoother_init(v)
    return v


def _group_events(rows, seed):
    t, v, r = _events(seed)
    reps = -(-rows // t.shape[0])
    t, v, r = (np.tile(x, (reps, 1))[:rows] for x in (t, v, r))
    return ps.segment_events(t, v, N, "cpu"), torch.as_tensor(r)


def _leaves(res):
    state, vals = res
    state = [state] if isinstance(state, torch.Tensor) else list(state)
    return state + [vals]


def test_cpu_tensors_take_the_plain_version():
    """CPU tensors never reach kernel 6: the launch counter stays 0, the
    result is the kind's plain function, and the kernel's wrapper refuses
    CPU tensors."""
    tracing.reset()
    tracing.enable()
    try:
        for kind, arg in GROUPS:
            st = _group_state(kind, arg, 5)
            ev, r = _group_events(5, 0)
            got = ps.smooth_group(kind, arg, SR, st, ev, N, r)
            want = ps.smooth_group_plain(kind, arg, SR, st, ev, N, r)
            for a, b in zip(_leaves(got), _leaves(want)):
                assert torch.equal(a, b), kind
        assert tracing.counters().get("kernel.smooth", 0) == 0
    finally:
        tracing.disable()
    for kind, arg in GROUPS:
        st = _group_state(kind, arg, 5)
        ev, r = _group_events(5, 0)
        with pytest.raises(ValueError, match="CUDA"):
            ps.smooth_kernel(kind, arg, SR, st, ev, N, r)


@pytest.mark.parametrize("kind,arg", GROUPS)
@pytest.mark.parametrize("widen", ["per-lane events", "shared events"])
def test_smooth_group_widens_rows_lane_major(kind, arg, widen):
    """A group whose events are per lane over a shared state carries every
    lane on from that state; shared events over per-lane states reach every
    lane: both equal the kind's function on rows tiled lane-major."""
    lanes, rows = 3, 5
    if widen == "per-lane events":
        st = _group_state(kind, arg, rows)
        ev, r = _group_events(lanes * rows, 1)
        tiled_st = (st.repeat(lanes) if kind == "step"
                    else type(st)(*(a.repeat(lanes) for a in st)))
        tiled_ev, tiled_r = ev, r
    else:
        st = _group_state(kind, arg, lanes * rows)
        ev, r = _group_events(rows, 1)
        tiled_st = st
        tiled_ev = ps.SegmentEvents(ev.times.repeat(lanes, 1),
                                    ev.values.repeat(lanes, 1), ev.live)
        tiled_r = r.repeat(lanes, 1)
    got = ps.smooth_group(kind, arg, SR, st, ev, N, r)
    want = ps.smooth_group_plain(kind, arg, SR, tiled_st, tiled_ev, N, tiled_r)
    for a, b in zip(_leaves(got), _leaves(want)):
        assert a.shape[0] == lanes * rows
        assert torch.equal(a, b)


def test_smooth_group_rows_must_tile():
    ev, r = _group_events(3, 0)
    with pytest.raises(ValueError, match="tile"):
        ps.smooth_group("step", 0.0, SR, _group_state("step", 0.0, 5), ev, N,
                        r)


def test_kernel_constants_round_as_pytorch_does():
    """The kernel's host constants are the float32 values PyTorch gives the
    plain version's Python scalars and constant tensors."""
    alpha = ps.exp_alpha(1.0 / 256.0, SR)
    got = list(ps._kernel_params("exponential", 1.0 / 256.0, SR))
    assert got[:3] == [float(torch.tensor(x, dtype=torch.float32)) for x in
                       (alpha, ps.SMOOTHER_EPSILON, 1e-38)]
    m11, m12, m21, m22, l1, l2, inv_dl = ps._spring_matrix(
        ps.spring_omega(300.0), SR)
    want = [l1, l2, inv_dl, m11 - l2, m12, m21, m22 - l2, m11 - l1, m22 - l1]
    got = list(ps._kernel_params("spring", 300.0, SR))
    assert got[:9] == [float(torch.tensor(x, dtype=torch.float32))
                       for x in want]
    assert got[11] == 1.0 and got[10] > 0.0

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
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from phonic_tpu.ops import smoothing as js
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

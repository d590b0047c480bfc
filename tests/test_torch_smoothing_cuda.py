"""Kernel 6 (``phonic_tpu_torch/csrc/smooth.cu``) against its plain version
on the card, bit for bit: values and every field of the new state.

Needs a CUDA card and ``nvcc``; without them every test skips.  On the
card: ``python -m pytest --noconftest -m cuda
tests/test_torch_smoothing_cuda.py -q``.  The cases are
``chip_smoke.py``'s (:func:`chip_smoke.smooth_cases`): every kind, events
at sample 0, at n - 1 and masked, a row with all 16 slots valid,
exponential ramps past their freeze point, linear counts that run out
inside a segment, springs settling, stepped rows with glides, both of the
lanes' widening cases, at n = 8192 and 131072.
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from phonic_tpu_torch import tracing
from phonic_tpu_torch.ops import smoothing

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("n", [cs.PLAYER_BLOCK, cs.BLOCK])
@pytest.mark.parametrize("kind,arg", cs.SMOOTH_KINDS)
def test_kernel_equals_plain_bit_for_bit(dev, n, kind, arg):
    rng = np.random.default_rng(n)
    seen = 0
    for label, k, a, state, ev, ramps in cs.smooth_cases(dev, n, rng):
        if (k, a) != (kind, arg):
            continue
        got = smoothing.smooth_kernel(k, a, cs.SR, state, ev, n, ramps)
        want = smoothing.smooth_group_plain(k, a, cs.SR, state, ev, n, ramps)
        assert cs.smooth_differences(label, got, want) == [0] * len(
            cs.smooth_outputs(want)), label
        seen += 1
    assert seen == 4


def test_engine_launches_one_kernel_per_group(dev):
    """A card program's step launches kernel 6 once per smoother group."""
    from phonic_tpu_torch.mastering import mastering_program
    prog = mastering_program(block_frames=8192, device=dev)
    groups = len(prog._param_groups)
    st = prog.init_state()
    tracing.reset()
    tracing.enable()
    try:
        st, _ = prog.step(st, prog.block_inputs(0))
        torch.cuda.synchronize()
        assert tracing.counters().get("kernel.smooth", 0) == groups
    finally:
        tracing.disable()

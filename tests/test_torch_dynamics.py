"""The mastering chain's effects against the JAX package, one effect at a
time: gate, compressor, limiter, delay (Stereo and PingPong, with and
without LFO modulation) and distortion (all five shapers).

Each effect runs two lanes over two 4096-frame blocks with its state carried
across and per-sample parameter ramps (``test_torch_effects._run``);
outputs must agree to within -90 dB of their peak.  The delay reads its line
at LFO-modulated positions: the LFO rate here makes every phase increment
2**-13, so both packages' running phase sums are exact and the positions
agree; the input tones stay below 500 Hz, so a one-ulp difference in a
read position moves the output by far less than the bound.
"""

import numpy as np
import pytest

from phonic_tpu.effects import compressor as jcomp, delay as jdelay
from phonic_tpu.effects import distortion as jdist, gate as jgate
from phonic_tpu_torch.effects import compressor, delay, distortion, gate
from test_torch_effects import LANES, N, _ramp, _run

LFO_RATE = 48000.0 * 2.0 ** -13  # Hz: an exact float32 phase increment


def _full(v):
    return np.full(N, v, np.float32)


def test_gate():
    """Threshold ramps across the envelope so that each lane opens, closes,
    holds and releases; lane 1 closes to a -60 dB range (gains snap to 0)."""
    def params(block, lane):
        return {"thrs": _ramp(-30.0 + 20.0 * block, -2.0 - 25.0 * block),
                "attk": _full(0.002 + 0.003 * lane),
                "hold": _full(0.005 + 0.01 * lane),
                "rels": _ramp(0.02, 0.05 + 0.05 * lane),
                "rnge": _full(-40.0 - 20.0 * lane)}
    _run([jgate.GateEffect() for _ in range(LANES)],
         [gate.GateEffect() for _ in range(LANES)], params)


def test_compressor():
    """Soft knee, makeup ramp; lane 1's ratio ramps past 20, where the
    detector becomes the lookahead window's peak."""
    def params(block, lane):
        return {"thrs": _ramp(-18.0, -12.0 + 2.0 * lane),
                "rato": _ramp(4.0, 4.0 + 20.0 * lane),
                "knee": _full(6.0 * (1 - lane) + 1.0),
                "attk": _full(0.005), "rels": _ramp(0.1, 0.3 + 0.1 * block),
                "gain": _ramp(3.0 * lane, 2.0), "look": _full(0.04)}
    _run([jcomp.CompressorEffect(threshold=-18.0, ratio=4.0) for _ in range(LANES)],
         [compressor.CompressorEffect(threshold=-18.0, ratio=4.0)
          for _ in range(LANES)], params)


def test_limiter():
    def params(block, lane):
        return {"thrs": _ramp(-6.0 - 3.0 * lane, -0.01), "rato": _full(20.0),
                "knee": _full(0.0), "attk": _full(0.02), "rels": _full(0.2),
                "gain": _full(0.0), "look": _full(0.02)}
    _run([jcomp.CompressorEffect.limiter() for _ in range(LANES)],
         [compressor.CompressorEffect.limiter() for _ in range(LANES)], params)


@pytest.mark.parametrize("shapes,lfo_depth", [
    ((0, 0), 0.0), ((0, 1), 0.4), ((2, 3), 0.4), ((4, 5), 0.4), ((6, 6), 0.4)])
def test_delay(shapes, lfo_depth):
    """Lane 0 runs Stereo with a lowpass, lane 1 PingPong with a highpass
    and drive; ``shapes`` are the lanes' LFO waveforms, ``lfo_depth`` the
    LFO's depth on time, feedback and cutoff (0: no modulation)."""
    def params(block, lane):
        return {"mode": _full(lane), "dlay": _ramp(45.0 + 5.0 * block, 55.0),
                "fdbk": _ramp(0.5, 0.6 - 0.2 * lane), "ftyp": _full(lane),
                "cuto": _ramp(3000.0, 5000.0 - 2000.0 * lane),
                "driv": _ramp(0.0, 0.5 * lane), "wet_": _full(0.5),
                "wdth": _ramp(0.5, 0.8), "lfor": _full(LFO_RATE),
                "lfos": _full(shapes[lane]),
                "lfdt": _full(lfo_depth), "ldfb": _full(-lfo_depth),
                "lfdf": _full(lfo_depth)}
    _run([jdelay.DelayEffect() for _ in range(LANES)],
         [delay.DelayEffect() for _ in range(LANES)], params,
         band=(80.0, 500.0))


@pytest.mark.parametrize("kinds", [(0, 1), (2, 3), (4, 2)])
def test_distortion(kinds):
    def params(block, lane):
        return {"type": _full(kinds[lane]),
                "driv": _ramp(0.5 * block, 3.5 - lane),
                "mix ": _ramp(1.0, 0.4 + 0.3 * lane)}
    _run([jdist.DistortionEffect() for _ in range(LANES)],
         [distortion.DistortionEffect() for _ in range(LANES)], params)


def test_compensation_luts_match_jax():
    assert np.array_equal(distortion._build_luts(), jdist.compensation_luts())

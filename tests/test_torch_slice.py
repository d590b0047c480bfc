"""The headline mixer graph through both packages on the CPU.

16 file sources at speeds 0.5..2.0 -> 4 sub-mixers running EQ5 -> chorus
(one batched chain in both packages) -> master reverb -> gain, built as the
JAX package's benchmark builds it (bench.py ``config_mixer_graph``) but at
4096-frame blocks.  Block 0 is the graph as the benchmark renders it; block
1 adds scheduled events on every smoother kind (exponential volume, linear
bandwidth and room size, stepped speed and DC-filter mode).

* The port's render matches JAX ``RenderProgram.render`` to -90 dB of peak.
* The JAX state after block 0, carried over with ``state_from_jax``,
  renders block 1 in the port as the JAX program renders it.
* A CUDA program cannot be built without a card.
"""

import numpy as np
import jax
import pytest
import torch

from phonic_tpu import (AudioFileBuffer as JBuffer, EngineConfig as JConfig,
                        FilePlaybackOptions as JOptions, FileSource as JSource,
                        Mixer as JMixer, RenderProgram as JProgram)
from phonic_tpu.effects.chorus import ChorusEffect as JChorus
from phonic_tpu.effects.eq5 import Eq5Effect as JEq5
from phonic_tpu.effects.gain import GainEffect as JGain
from phonic_tpu.effects.reverb import ReverbEffect as JReverb
from phonic_tpu_torch import EngineConfig, RenderProgram
from phonic_tpu_torch.convert import state_from_jax
from phonic_tpu_torch.headline import mixer_graph, mixer_graph_program

BLOCK = 4096
DB90 = 10.0 ** (-90.0 / 20.0)


def _jax_mixer_graph():
    """bench.py's config_mixer_graph with the port headline's node names."""
    def tone(frames, freq, sr=48000, decay=2.0):
        t = np.arange(frames) / sr
        x = (0.5 * np.sin(2 * np.pi * freq * t) * np.exp(-t * decay)).astype(np.float32)
        return JBuffer.from_array(x[None, :], sr)

    rng = np.random.default_rng(0)
    main = JMixer("main")
    subs = [main.add_mixer(JMixer(f"sub{i}")) for i in range(4)]
    for i in range(16):
        buf = tone(12000 + 977 * i, float(rng.uniform(80, 660)))
        subs[i % 4].add_source(JSource(buf, JOptions(
            volume=float(rng.uniform(0.2, 0.6)),
            panning=float(rng.uniform(-0.8, 0.8)),
            speed=float(rng.uniform(0.5, 2.0)), repeat=None), name=f"src{i}"))
    for s in subs:
        s.add_effect(JEq5(gains=list(rng.uniform(-6, 6, 5)), name="eq"))
        s.add_effect(JChorus(rate=float(rng.uniform(0.3, 2.0)), name="chorus"))
    main.add_effect(JReverb(room_size=0.6, wet=0.2, min_room_size=0.55,
                            name="reverb"))
    main.add_effect(JGain(gain=0.8, name="gain"))
    return main


def _schedule(prog):
    """Events inside block 1 on each smoother kind (same calls on either
    package's program)."""
    prog.set_parameter("main/sub1/src5", "VOLU", 0.9, at_frame=BLOCK + 1000)
    prog.set_parameter("main/sub2/src6", "SPED", 1.5, at_frame=BLOCK + 300)
    prog.set_parameter("main/sub3/eq", "bw_3", 2.0, at_frame=BLOCK + 2000)
    prog.set_parameter("main/reverb", "room", 0.7, at_frame=BLOCK + 100)
    prog.set_parameter("main/gain", "DCFL", 2, at_frame=BLOCK)


def _port_program():
    prog = mixer_graph_program(block_frames=BLOCK, device="cpu")
    _schedule(prog)
    return prog


@pytest.fixture(scope="module")
def jax_run():
    """The JAX render of two blocks, and its state after block 0 (both from
    the same compiled step)."""
    prog = JProgram(_jax_mixer_graph(),
                    JConfig(sample_rate=48000, block_frames=BLOCK))
    _schedule(prog)
    audio = prog.render(2 * BLOCK, mode="loop")
    state1, _ = prog.step_packed(prog.init_state(), prog.packed_block_inputs(0))
    return audio, jax.device_get(state1)


def _close(got, want):
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    peak = np.abs(want).max()
    assert peak > 0.1
    assert np.abs(got - want).max() <= DB90 * peak


def test_render_matches_jax(jax_run):
    want, _ = jax_run
    got = _port_program().render(2 * BLOCK)
    for block in range(2):
        sl = slice(block * BLOCK, (block + 1) * BLOCK)
        _close(got[:, sl], want[:, sl])


def test_unbatched_chains_match_jax(jax_run):
    """With batch_effects off every sub-mixer runs its own one-lane chain;
    the result is the same render."""
    want, _ = jax_run
    prog = RenderProgram(mixer_graph(), EngineConfig(
        block_frames=BLOCK, batch_effects=False, device="cpu"))
    assert all(len(c["mixers"]) == 1 for c in prog.chains)
    _schedule(prog)
    _close(prog.render(2 * BLOCK), want)


def test_state_carried_from_jax(jax_run):
    want, state1 = jax_run
    prog = _port_program()
    state = state_from_jax(state1, prog)
    _, y = prog.step(state, prog.block_inputs(1))
    _close(y.numpy(), want[:, BLOCK:])


def test_state_from_jax_needs_matching_paths(jax_run):
    _, state1 = jax_run
    main = mixer_graph()
    main.effects[-1].name = "master_gain"  # a path the JAX state lacks
    prog = RenderProgram(main, EngineConfig(block_frames=BLOCK, device="cpu"))
    with pytest.raises(KeyError, match="master_gain"):
        state_from_jax(state1, prog)


def test_cuda_program_needs_a_card():
    """The entry points target the card by default and never fall back to
    the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; chip_smoke.py covers this path")
    assert EngineConfig().device == "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        mixer_graph_program(block_frames=BLOCK, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        mixer_graph_program(block_frames=BLOCK)
    with pytest.raises(RuntimeError, match="cuda"):
        RenderProgram(mixer_graph(), EngineConfig(device="cuda"))
    with pytest.raises(RuntimeError, match="cuda"):
        RenderProgram(mixer_graph())

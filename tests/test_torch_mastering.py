"""The mastering chain through both packages on the CPU.

4 looping mono file sources -> one master bus running gate -> compressor ->
delay (300 ms, feedback 0.4) -> diode distortion -> limiter, built as the
JAX package's benchmark builds it (bench.py ``config_mastering``) but at
short blocks: six 4096-frame blocks, so that the 300 ms echo (14,400
frames) comes back inside the render, and four 8192-frame blocks, where
the delay's feedback sub-block is 8192 as at the benchmark's 131072-frame
blocks.

* The port's render matches JAX ``RenderProgram.render`` to -90 dB of the
  block's peak.
* The JAX state after block 2, carried over with ``state_from_jax``,
  renders block 3 in the port as the JAX program renders it.
* A CUDA program cannot be built without a card.
"""

import numpy as np
import jax
import pytest
import torch

from phonic_tpu import (AudioFileBuffer as JBuffer, EngineConfig as JConfig,
                        FilePlaybackOptions as JOptions, FileSource as JSource,
                        Mixer as JMixer, RenderProgram as JProgram)
from phonic_tpu.effects.compressor import CompressorEffect as JCompressor
from phonic_tpu.effects.delay import DelayEffect as JDelay
from phonic_tpu.effects.distortion import DistortionEffect as JDistortion
from phonic_tpu.effects.gate import GateEffect as JGate
from phonic_tpu_torch import mastering_chain, mastering_program
from phonic_tpu_torch.convert import state_from_jax

DB90 = 10.0 ** (-90.0 / 20.0)
BLOCKS = {4096: 6, 8192: 4}


def _jax_mastering_chain():
    """bench.py's config_mastering with the port's node names."""
    def tone(frames, freq, sr=48000, decay=2.0):
        t = np.arange(frames) / sr
        x = (0.5 * np.sin(2 * np.pi * freq * t) * np.exp(-t * decay)).astype(np.float32)
        return JBuffer.from_array(x[None, :], sr)

    rng = np.random.default_rng(0)
    main = JMixer("main")
    for i in range(4):
        main.add_source(JSource(tone(48000, float(rng.uniform(100, 500))),
                                JOptions(volume=0.4, repeat=None), name=f"src{i}"))
    main.add_effect(JGate(threshold=-40.0, name="gate"))
    main.add_effect(JCompressor(threshold=-12.0, ratio=4.0, name="comp"))
    main.add_effect(JDelay(delay_ms=300.0, feedback=0.4, wet=0.3,
                           min_delay_ms=250.0, max_delay_capacity_ms=1000.0,
                           name="delay"))
    main.add_effect(JDistortion("Diode", drive=1.0, mix=0.3, name="dist"))
    main.add_effect(JCompressor.limiter(name="limiter"))
    return main


@pytest.fixture(scope="module", params=sorted(BLOCKS))
def jax_run(request):
    """The JAX render at one block size, and its state after block 2."""
    block = request.param
    prog = JProgram(_jax_mastering_chain(),
                    JConfig(sample_rate=48000, block_frames=block))
    audio = prog.render(BLOCKS[block] * block, mode="loop")
    state = prog.init_state()
    for b in range(3):
        state, _ = prog.step_packed(state, prog.packed_block_inputs(b))
    return block, audio, jax.device_get(state)


def _close(got, want):
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    peak = np.abs(want).max()
    assert peak > 0.1
    assert np.abs(got - want).max() <= DB90 * peak


def test_render_matches_jax(jax_run):
    block, want, _ = jax_run
    prog = mastering_program(block_frames=block, device="cpu")
    got = prog.render(BLOCKS[block] * block)
    for b in range(BLOCKS[block]):
        sl = slice(b * block, (b + 1) * block)
        _close(got[:, sl], want[:, sl])


def test_state_carried_from_jax(jax_run):
    block, want, state3 = jax_run
    prog = mastering_program(block_frames=block, device="cpu")
    state = state_from_jax(state3, prog)
    _, y = prog.step(state, prog.block_inputs(3))
    _close(y.numpy(), want[:, 3 * block:4 * block])


def test_graph_and_paths_match_jax():
    prog = mastering_program(block_frames=4096, device="cpu")
    jprog = JProgram(_jax_mastering_chain(), JConfig(block_frames=4096))
    assert sorted(prog.nodes) == sorted(jprog.nodes)
    assert [e.name for e in mastering_chain().effects] == [
        "gate", "comp", "delay", "dist", "limiter"]
    delay = prog.nodes["main/delay"]
    assert delay._subblock(prog.ctx) == 4096
    assert delay._subblock(mastering_program(131072, "cpu").ctx) == 8192


def test_cuda_mastering_program_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; chip_smoke.py covers this path")
    with pytest.raises(RuntimeError, match="cuda"):
        mastering_program(block_frames=4096)

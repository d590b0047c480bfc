"""Note parts through the port's granular sampler
(phonic_tpu_torch/generators/granular.py, the granular part of
generators/sampler.py, graph/batching.LeafBatch) on the CPU: 4 voices of
100-grain pools, 4096-frame blocks (two 2048-frame allocation chunks),
grains of about 20-50 ms, the stock modulation matrix of the benchmark's
``granular_1k`` configuration.

* Seeded dense notes in 2 lanes against the benchmark's plain reference
  (``portbench/reference/granular.py``), block by block; voices are stolen
  and start several notes in a block.
* A voice that starts 4 notes in one block, two of them inside one
  allocation chunk, renders all 4.
* A voice with no start renders bit for bit as through a lowering of one
  trigger per voice and block.
* Lanes whose lowerings hold different numbers of trigger slots fold into
  one bank.
* The render's spans and counters under ``tracing.enable()``.
"""

import sys
from pathlib import Path

import numpy as np
import torch

import phonic_tpu_torch as pt
from phonic_tpu_torch import tracing
from phonic_tpu_torch.generators import sampler as psampler
from phonic_tpu_torch.parallel.mesh import BatchedRenderProgram

PORTBENCH = Path(__file__).resolve().parents[1] / "portbench"
sys.path.insert(0, str(PORTBENCH))
from reference.granular import GranularReference  # noqa: E402
from one_trigger import one_trigger  # noqa: E402

SR = 48000
IN_SR = 44100
BLOCK = 4096
VOICES = 4
ENV = (0.004, 0.0, 0.0, 1.0, 0.01)  # attack, hold, decay, sustain, release
GRANULAR = dict(size_ms=35.0, density_hz=100.0, position=0.3, variation=0.5,
                spray=0.3, pan_spread=0.8, step=0.5)
ROUTINGS = [["LFO1", "GPOS", 0.3, True], ["LFO2", "GSIZ", 0.4, True],
            ["VELM", "GDEN", 0.5, False], ["KEYM", "GPAN", 0.6, True]]


def _table(frames=IN_SR):
    t = np.arange(frames) / IN_SR
    return np.stack([
        0.4 * np.sin(2 * np.pi * 220 * t) + 0.2 * np.sin(2 * np.pi * 577 * t + 1),
        0.4 * np.sin(2 * np.pi * 331 * t + 2) + 0.2 * np.sin(2 * np.pi * 97 * t),
    ]).astype(np.float32)


def _program(voices=VOICES):
    s = pt.Sampler(pt.AudioFileBuffer.from_array(_table(), IN_SR),
                   pt.GeneratorPlaybackOptions(voices=voices),
                   envelope=pt.AhdsrConfig(*ENV), name="s")
    s.with_granular_playback(pt.GranularConfig(**GRANULAR))
    for source, target, amount, bipolar in ROUTINGS:
        s.set_modulation(source, target, amount, bipolar=bipolar)
    main = pt.Mixer("main")
    main.add_source(s)
    return pt.RenderProgram(main, pt.EngineConfig(
        sample_rate=SR, block_frames=BLOCK, device="cpu")), s


def _reference(lanes, voices=VOICES, dtype=torch.float64):
    return GranularReference(_table(), IN_SR, SR, lanes, BLOCK, voices, ENV,
                             GRANULAR, ROUTINGS, "cpu", dtype)


def _err_db(got, want):
    """Each lane's RMS of the difference in dB of its RMS: [lanes]."""
    d = np.sqrt(np.mean((got - want) ** 2, axis=(-2, -1)))
    r = np.sqrt(np.mean(want ** 2, axis=(-2, -1)))
    return 20 * np.log10(np.maximum(d, 1e-300) / r)


# the reference follows the engine's float32 read positions and discrete
# decisions (reference/granular.py), so only the float32 rounding of the
# read, the windows, the volumes and the sums stays: -123..-138 dB; the
# same reference in bfloat16 sits near -40 dB
TOLERANCE_DB = -100.0


def test_dense_notes_match_reference():
    """3 blocks of 8 notes per lane on 4 voices, 2 lanes of one
    ``BatchedRenderProgram`` with each lane's own notes and knob turns
    (SVOL, GPOS, GSIZ, GDEN): every block and lane within TOLERANCE_DB of
    the reference; the reference computed in bfloat16 misses it.  Voices
    are stolen, and some voice starts 3 or more notes in a block."""
    lanes, blocks = 2, 3
    template, _ = _program()
    batched = BatchedRenderProgram(template, lanes=lanes)
    states = batched.init_states()
    progs = [_program() for _ in range(lanes)]
    refs = [_reference(lanes), _reference(lanes, dtype=torch.bfloat16)]
    rng = np.random.default_rng(22)
    knobs = (("SVOL", 0.25, 0.75), ("GPOS", 0.1, 0.9), ("GSIZ", 20.0, 50.0),
             ("GDEN", 20.0, 100.0))
    most = 0
    for b in range(blocks):
        for lane, (prog, s) in enumerate(progs):
            for t in np.sort(rng.integers(0, BLOCK, 8)):
                start = b * BLOCK + int(t)
                note, vel = int(rng.integers(36, 73)), float(rng.uniform(0.3, 1))
                off = start + int(rng.integers(300, 6000))
                s.note_off(s.note_on(note, vel, time=start), time=off)
                for ref in refs:
                    ref.order += 1
                    ref.note(lane, ref.order, start, note, vel, off)
            pid, lo, hi = knobs[int(rng.integers(0, len(knobs)))]
            frame = b * BLOCK + int(rng.integers(0, BLOCK))
            value = float(rng.uniform(lo, hi))
            prog.set_parameter(s, pid, value, at_frame=frame)
            for ref in refs:
                ref.set(lane, pid, frame, value)
        ins = [p.block_inputs(b) for p, _ in progs]
        most = max(most, max(int((i["extra"]["main/s"]["_trig_time"]
                                  < BLOCK).sum(axis=1).max()) for i in ins))
        states, audio = batched.step(states, ins)
        want = refs[0].step().double().numpy()
        assert (_err_db(audio.numpy(), want) <= TOLERANCE_DB).all(), b
        control = refs[1].step().double().numpy()
        assert (_err_db(control, want) > TOLERANCE_DB).all(), b
    assert most >= 3


STARTS = (100, 1100, 2100, 3100)  # two in each 2048-frame chunk


def _four_starts():
    prog, s = _program(voices=1)
    for t in STARTS:
        s.note_off(s.note_on(60, 0.8, time=t), time=t + 300)
    return prog.render(BLOCK), s


def test_voice_renders_every_start(monkeypatch):
    """One voice starts 4 notes in one block, two in each allocation
    chunk (each released after 300 frames, its voice free again before
    the next note): each note sounds from its own onset, as the reference
    renders it; a lowering of one trigger per voice renders the last
    only."""
    got, s = _four_starts()
    assert s.lower_block_inputs(0, BLOCK)["_trig_time"][0].tolist() == \
        list(STARTS)
    ref = _reference(1, voices=1)
    for k, t in enumerate(STARTS):
        ref.note(0, k + 1, t, 60, 0.8, t + 300)
    assert _err_db(got, ref.step()[0].numpy()) <= TOLERANCE_DB
    for t in STARTS:
        assert np.sqrt(np.mean(got[:, t:t + 300] ** 2)) > 1e-3
    assert not got[:, :STARTS[0]].any()
    one_trigger(monkeypatch, psampler.Sampler)
    last, _ = _four_starts()
    assert not last[:, :STARTS[-1]].any()
    assert np.sqrt(np.mean(last[:, STARTS[-1]:STARTS[-1] + 300] ** 2)) > 1e-3


def test_voice_without_starts_renders_as_with_one_trigger(monkeypatch):
    """4 voices over 2 blocks: voice 0 starts one long note in block 0 and
    none in block 1, voice 1 two short notes in each block, voices 2-3
    none.  The grain mix of every voice but voice 1 is bit for bit that of
    a lowering of one trigger per voice and block; voice 1's differs."""
    def render():
        rows = []
        mix = psampler.grain_mix

        def spy(*a):
            out = mix(*a)
            rows.append(out.clone())
            return out
        monkeypatch.setattr(psampler, "grain_mix", spy)
        prog, s = _program()
        s.note_off(s.note_on(57, 0.9, time=100), time=6100)
        for t in (200, 1500, BLOCK + 200, BLOCK + 1500):
            s.note_off(s.note_on(64, 0.6, time=t), time=t + 300)
        prog.set_parameter(s, "GPOS", 0.7, at_frame=BLOCK + 2000)
        prog.render(2 * BLOCK)
        return rows

    slots = render()
    one_trigger(monkeypatch, psampler.Sampler)
    one = render()
    for b in range(2):
        for v in (0, 2, 3):
            assert torch.equal(slots[b][v], one[b][v]), (b, v)
        assert not torch.equal(slots[b][1], one[b][1])
    assert slots[1][0].abs().max() > 0.01


def test_lanes_with_different_slots_fold():
    """Two lanes of one ``BatchedRenderProgram``: a voice of lane 0 starts
    4 notes in the block, every voice of lane 1 one at most, so their
    lowerings hold 4 and 1 trigger slots; the sampler renders as one bank
    of both lanes, each lane bit for bit as its own program renders it."""
    template, _ = _program()
    batched = BatchedRenderProgram(template, lanes=2)
    progs = [_program() for _ in range(2)]
    for t in (100, 1100, 2100, 3100):
        progs[0][1].note_off(progs[0][1].note_on(60, 0.8, time=t),
                             time=t + 300)
    for k, t in enumerate((500, 900, 1300)):
        progs[1][1].note_on(48 + 7 * k, 0.7, time=t)
    ins = [p.block_inputs(0) for p, _ in progs]
    assert [i["extra"]["main/s"]["_trig_time"].shape[1] for i in ins] == \
        [4, 1]
    (shard,) = batched.shards
    assert len(shard.pools) == 1 and shard.lanes == 2
    _, audio = batched.step(batched.init_states(), ins)
    for lane, (prog, _) in enumerate(progs):
        _, alone = prog.step(prog.init_state(), ins[lane])
        np.testing.assert_array_equal(audio[lane].numpy(), alone.numpy())
    assert np.abs(audio.numpy()).max() > 0.01


def test_spans_and_counters():
    """Under ``tracing.enable()`` a block of the granular sampler records
    ``granular.notes``, ``granular.alloc`` and ``granular.mix`` inside its
    ``source.pool`` and counts its trigger slots (V x K) and allocation
    steps (chunks x candidates); with tracing off, none of them."""
    prog, s = _program()
    for t in (100, 1100, 2100):
        s.note_on(60, 0.8, time=t)
    state = prog.init_state()
    tracing.reset()
    state, _ = prog.step(state, prog.block_inputs(0))
    assert not any(sp.name.startswith("granular.") for sp in tracing.spans())
    tracing.enable()
    try:
        prog.step(state, prog.block_inputs(1))
        prog.step(state, prog.block_inputs(1))
        sp = tracing.spans()
        counts = tracing.counters()
    finally:
        tracing.disable()
        tracing.reset()
    pools = [i for i, x in enumerate(sp) if x.name == "source.pool"]
    assert len(pools) == 2
    assert [x.name for x in sp if x.parent == pools[0]] == [
        "granular.notes", "granular.alloc", "granular.mix"]
    # block 1: no start, K = 1; two chunks of ceil(100 Hz x 2048) + 2
    assert counts["granular.trigger_slots"] == 2 * VOICES * 1
    assert counts["granular.alloc_steps"] == 2 * 2 * 7

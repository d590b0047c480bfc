"""Dense notes through the port's synth generator (phonic_tpu_torch/
generators/synth.py over the voice plan of generators/plan.py) on the CPU:
sub3 with a modulation matrix (an LFO and the velocity on the cutoff, an
envelope on the shape), the cutoff automated.

* Seeded dense notes on 8 voices in 2 lanes against the benchmark's plain
  reference (``portbench/reference/synth.py``), block by block; a voice
  starts 3 or more notes in one block, and held notes and releasing notes
  are both stolen.
* A voice that starts 4 notes in one block renders each from its onset.
* A voice that starts no note in a block renders bit for bit as it does
  through a lowering of one trigger per voice and block, where every voice
  starts at most one note per block.
* A note that starts at velocity 0 takes its voice and silences it from
  its onset, as a one-trigger lowering does.
* Lanes whose voices start different numbers of notes fold into one bank.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import phonic_tpu_torch as pt
from phonic_tpu_torch.generators import synth as psynth
from phonic_tpu_torch.generators.plan import VoicePlan
from phonic_tpu_torch.parallel.mesh import BatchedRenderProgram

PORTBENCH = Path(__file__).resolve().parents[1] / "portbench"
sys.path.insert(0, str(PORTBENCH))
from reference.synth import SynthReference  # noqa: E402

SR = 48000
BLOCK = 8192
VOICES = 8
RELEASE = 0.02  # seconds a voice stays busy after its note-off
PATCH = {"shape": 2.0, "detune_cents": 7.0, "cutoff": 2500.0,
         "resonance": 0.4, "envelope": [0.01, 0.0, 0.3, 0.6, 0.15]}
MODULATION = {
    "sources": [{"kind": "lfo", "id": "LFO1", "rate": 2.0},
                {"kind": "envelope", "id": "ENV2", "attack": 0.005,
                 "hold": 0.0, "decay": 0.4, "sustain": 0.2, "release": 0.3},
                {"kind": "velocity", "id": "VELM"}],
    "targets": ["CUTF", "SHAP"],
    "routings": [["LFO1", "CUTF", 0.3, True], ["VELM", "CUTF", 0.4, False],
                 ["ENV2", "SHAP", 0.5, False]]}

# the port's float32 oscillators, envelopes and filter sit at -120..-140
# dB of the float64 reference (the phases are equal by construction, both
# summing the same float32 steps); the same reference in bfloat16 sits
# near -20 dB
TOLERANCE_DB = -100.0


def _generator(voices=VOICES, synth=None, release=RELEASE):
    gen = pt.SynthGenerator(synth or pt.synths.sub3(),
                            pt.GeneratorPlaybackOptions(voices=voices,
                                                        volume=0.5),
                            release_secs=release, name="synth")
    gen.with_modulation(pt.ModulationConfig(
        sources=(pt.LfoSource("LFO1", rate=2.0),
                 pt.EnvelopeSource("ENV2", attack=0.005, decay=0.4,
                                   sustain=0.2, release=0.3),
                 pt.VelocitySource()),
        targets=("CUTF", "SHAP")))
    for source, target, amount, bipolar in MODULATION["routings"]:
        gen.set_modulation(source, target, amount, bipolar)
    return gen


def _program(voices=VOICES, synth=None, block=BLOCK, release=RELEASE):
    gen = _generator(voices, synth, release)
    main = pt.Mixer("main")
    main.add_source(gen)
    return pt.RenderProgram(main, pt.EngineConfig(
        sample_rate=SR, block_frames=block, device="cpu")), gen


def _reference(lanes, voices=VOICES, dtype=torch.float64, release=RELEASE):
    return SynthReference(lanes, SR, BLOCK, voices, PATCH, MODULATION, "cpu",
                          dtype, volume=0.5, release_secs=release)


def _notes(rng, block, count=12):
    """``count`` notes in ``block``: onsets uniform in it, held 5-300 ms."""
    out = []
    for t in np.sort(rng.integers(0, BLOCK, count)):
        start = block * BLOCK + int(t)
        out.append((start, int(rng.integers(36, 85)),
                    float(rng.uniform(0.3, 1.0)),
                    start + int(rng.integers(240, 14400))))
    return out


def _err_db(got, want):
    """Each lane's RMS of the difference in dB of its RMS: [lanes]."""
    d = np.sqrt(np.mean((got - want) ** 2, axis=(-2, -1)))
    r = np.sqrt(np.mean(want ** 2, axis=(-2, -1)))
    return 20 * np.log10(np.maximum(d, 1e-300) / r)


def test_dense_notes_match_reference(monkeypatch):
    """6 blocks of 12 notes per lane on 8 voices, 2 lanes of one
    ``BatchedRenderProgram`` with each lane's own notes and cutoff turns:
    every block and lane within TOLERANCE_DB of the reference; the
    reference computed in bfloat16 misses it."""
    kinds = []
    place = VoicePlan._place

    def spy(self, ev, t, key, applied):
        if all(segs and self._free_at(segs[-1]) > t for segs in self.voices):
            oldest = min(self.voices, key=lambda segs: segs[-1].note_id)[-1]
            kinds.append("releasing" if oldest.release <= t else "held")
        return place(self, ev, t, key, applied)
    monkeypatch.setattr(VoicePlan, "_place", spy)

    lanes, blocks = 2, 6
    template, _ = _program()
    batched = BatchedRenderProgram(template, lanes=lanes)
    states = batched.init_states()
    progs = [_program() for _ in range(lanes)]
    refs = [_reference(lanes), _reference(lanes, dtype=torch.bfloat16)]
    rng = np.random.default_rng(23)
    most = 0
    for b in range(blocks):
        for lane, (prog, gen) in enumerate(progs):
            for start, note, vel, off in _notes(rng, b):
                nid = gen.note_on(note, vel, time=start)
                gen.note_off(nid, time=off)
                for ref in refs:
                    ref.note(lane, nid, start, note, vel, off)
            frame = b * BLOCK + int(rng.integers(0, BLOCK))
            cutoff = float(rng.uniform(300.0, 8000.0))
            prog.set_parameter(gen, "CUTF", cutoff, at_frame=frame)
            for ref in refs:
                ref.set(lane, "CUTF", frame, cutoff)
        ins = [p.block_inputs(b) for p, _ in progs]
        most = max(most, max(int((i["extra"]["main/synth"]["_trig_time"]
                                  < BLOCK).sum(axis=1).max()) for i in ins))
        states, audio = batched.step(states, ins)
        want = refs[0].step().double().numpy()
        assert (_err_db(audio.numpy(), want) <= TOLERANCE_DB).all(), b
        control = refs[1].step().double().numpy()
        assert (_err_db(control, want) > TOLERANCE_DB).all(), b
    assert most >= 3
    assert {"releasing", "held"} <= set(kinds)


def _one_trigger(monkeypatch):
    """Lower as the JAX package does: each voice's last trigger of a block
    only, given to ``render_lanes`` as one trigger slot."""
    lower = psynth.SynthGenerator.lower_block_inputs

    def lowered(self, block_start, block_len):
        out = lower(self, block_start, block_len)
        return {k: a[:, None] if k.startswith(("_trig_", "_ta_")) else a
                for k, a in out.items()}
    monkeypatch.setattr(psynth.SynthGenerator, "_trigger_slots",
                        lambda s: False)
    monkeypatch.setattr(psynth.SynthGenerator, "lower_block_inputs", lowered)


def test_voice_renders_every_start(monkeypatch):
    """One voice starts 4 notes in one block (each released after 300
    frames, its voice free again before the next note, which cuts the
    release): each note sounds from its own onset, as the reference renders
    it; a lowering of one trigger per voice renders the last only."""
    starts = (100, 1100, 2100, 3100)

    def render():
        prog, gen = _program(voices=1, release=0.003)
        for t in starts:
            nid = gen.note_on(60, 0.8, time=t)
            gen.note_off(nid, time=t + 300)
        return prog.render(BLOCK), gen

    got, gen = render()
    assert gen.lower_block_inputs(0, BLOCK)["_trig_time"][0].tolist() == \
        list(starts)
    ref = _reference(1, voices=1, release=0.003)
    for k, t in enumerate(starts):
        ref.note(0, k + 1, t, 60, 0.8, t + 300)
    assert _err_db(got, ref.step()[0].numpy()) <= TOLERANCE_DB
    for t in starts:
        assert np.sqrt(np.mean(got[:, t:t + 300] ** 2)) > 0.01
    assert not got[:, :starts[0]].any()
    _one_trigger(monkeypatch)
    last, _ = render()
    assert not last[:, :starts[-1]].any()
    assert np.sqrt(np.mean(last[:, starts[-1]:starts[-1] + 300] ** 2)) > 0.01


def test_silent_start_takes_its_voice(monkeypatch):
    """One voice holds a note from frame 100 of block 0; a note at velocity
    0 starts on it at frame 3000 of block 1, taking the voice as the voice
    plan placed it: the voice is silent from that onset on, as the
    reference renders it, and bit for bit as through a lowering of one
    trigger per voice, whose render skips a trigger at velocity 0 (the
    held note's own descriptors end it at the cut)."""
    onset = BLOCK + 3000

    def render():
        prog, gen = _program(voices=1)
        gen.note_on(57, 0.8, time=100)
        gen.note_on(64, 0.0, time=onset)
        return prog.render(2 * BLOCK)

    got = render()
    ref = _reference(1, voices=1)
    ref.note(0, 1, 100, 57, 0.8, 10 ** 9)
    ref.note(0, 2, onset, 64, 0.0, 10 ** 9)
    want = np.concatenate([ref.step()[0].numpy() for _ in range(2)], axis=1)
    assert not want[:, onset:].any()
    assert _err_db(got[:, :onset], want[:, :onset]) <= TOLERANCE_DB
    assert not got[:, onset:].any()
    assert np.abs(got[:, BLOCK:onset]).max() > 0.01
    _one_trigger(monkeypatch)
    np.testing.assert_array_equal(render(), got)


def test_voice_without_starts_renders_as_with_one_trigger(monkeypatch):
    """4 voices over 2 blocks of 4096: voice 0 starts one long note in
    block 0 and none in block 1, voice 1 starts two short notes in each
    block, voices 2-3 none.  The SynthDef's output of every voice but
    voice 1 is bit for bit that of a lowering of one trigger per voice
    and block; voice 1's differs."""
    n = 4096

    def render():
        rows = []
        inner = pt.synths.sub3()

        def spy(state, ctx):
            state, y = inner.render(state, ctx)
            rows.append(y.clone())
            return state, y
        prog, gen = _program(voices=4, block=n, release=0.01,
                             synth=dataclasses.replace(inner, render=spy))
        gen.note_off(gen.note_on(57, 0.9, time=100), time=6100)
        for t in (200, 1500, n + 200, n + 1500):
            gen.note_off(gen.note_on(64, 0.6, time=t), time=t + 300)
        prog.set_parameter(gen, "CUTF", 900.0, at_frame=n + 2000)
        prog.render(2 * n)
        return rows

    slots = render()
    _one_trigger(monkeypatch)
    one = render()
    for b in range(2):
        for v in (0, 2, 3):
            assert torch.equal(slots[b][v], one[b][v]), (b, v)
        assert not torch.equal(slots[b][1], one[b][1])


def test_lanes_with_different_slots_fold():
    """Two lanes of one ``BatchedRenderProgram``: a voice of lane 0 starts
    4 notes in the block, every voice of lane 1 one at most, so their
    lowerings hold 4 and 1 trigger slots; the generator renders as one bank
    of both lanes, each lane bit for bit as its own program renders
    it."""
    template, _ = _program()
    batched = BatchedRenderProgram(template, lanes=2)
    progs = [_program() for _ in range(2)]
    for t in (100, 2100, 4100, 6100):
        progs[0][1].note_off(progs[0][1].note_on(60, 0.8, time=t),
                             time=t + 300)
    for k, t in enumerate((500, 900, 1300)):
        progs[1][1].note_on(48 + 7 * k, 0.7, time=t)
    ins = [p.block_inputs(0) for p, _ in progs]
    assert [i["extra"]["main/synth"]["_trig_time"].shape[1] for i in ins] == \
        [4, 1]
    (shard,) = batched.shards
    assert len(shard.pools) == 1 and shard.lanes == 2
    _, audio = batched.step(batched.init_states(), ins)
    for lane, (prog, _) in enumerate(progs):
        _, alone = prog.step(prog.init_state(), ins[lane])
        np.testing.assert_array_equal(audio[lane].numpy(), alone.numpy())


@pytest.mark.parametrize("waveform", ["Sine", "Square"])
def test_modulation_lfo_waveform_builds(waveform):
    """A synth generator with an LFO source builds a program: the LFO's
    waveform parameter starts at its default's index."""
    gen = pt.SynthGenerator(pt.synths.sub3(), name="synth").with_modulation(
        pt.ModulationConfig(sources=(pt.LfoSource("LFO1", waveform=waveform),),
                            targets=("CUTF",)))
    assert gen.param_initials()["ML1W"] == \
        pt.modulation.config.LFO_WAVEFORMS.index(waveform)
    main = pt.Mixer("main")
    main.add_source(gen)
    gen.note_on(60, time=0)
    out = pt.RenderProgram(main, pt.EngineConfig(
        sample_rate=SR, block_frames=1024, device="cpu")).render(1024)
    assert np.isfinite(out).all() and np.abs(out).max() > 0.0

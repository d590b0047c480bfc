"""Dense notes through the port's sampler (phonic_tpu_torch/generators/plan.py,
generators/sampler.py, graph/batching.LeafBatch) on the CPU.

* Seeded dense notes on 8 voices in 2 lanes against the benchmark's plain
  reference (``portbench/reference/sampler.py``), block by block; some voice
  starts 3 or more notes in one block and both kinds of steal happen.
* A voice that starts 4 notes in one block renders all 4.
* The voice plan's work per block stays flat over a steady note part.
* The voice plan places notes as a full replay of every event does.
* The benchmark's note mix (``portbench/harness/notes.py``) draws its
  notes from the seed.
"""

import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import phonic_tpu_torch as pt
from phonic_tpu_torch import tracing
from phonic_tpu_torch.events import ParamTimeline
from phonic_tpu_torch.generators.plan import NoteSegment, VoicePlan
from phonic_tpu_torch.parallel.mesh import BatchedRenderProgram

PORTBENCH = Path(__file__).resolve().parents[1] / "portbench"
sys.path.insert(0, str(PORTBENCH))
from harness.notes import note_events  # noqa: E402
from reference.sampler import SamplerReference  # noqa: E402

SR = 48000
IN_SR = 44100
BLOCK = 4096
VOICES = 8
ENV = (0.004, 0.0, 0.02, 0.6, 0.03)  # attack, hold, decay, sustain, release


def _table(frames=20000):
    t = np.arange(frames) / IN_SR
    return np.stack([
        0.5 * np.sin(2 * np.pi * 220 * t) * np.exp(-2 * t),
        0.4 * np.sin(2 * np.pi * 331 * t + 1.0) * np.exp(-3 * t)]).astype(
            np.float32)


def _program(voices=VOICES, env=ENV, block=BLOCK):
    s = pt.Sampler(pt.AudioFileBuffer.from_array(_table(), IN_SR),
                   pt.GeneratorPlaybackOptions(voices=voices),
                   envelope=None if env is None else pt.AhdsrConfig(*env),
                   name="s")
    main = pt.Mixer("main")
    main.add_source(s)
    return pt.RenderProgram(main, pt.EngineConfig(
        sample_rate=SR, block_frames=block, device="cpu")), s


def _reference(lanes, voices=VOICES, env=ENV, dtype=torch.float64):
    return SamplerReference(_table(), IN_SR, SR, lanes, BLOCK, voices, env,
                            "cpu", dtype)


def _notes(rng, block, count=14):
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


# the port's float32 envelope and sums sit near -140 dB of the float64
# reference; the same reference in bfloat16 sits near -45 dB
TOLERANCE_DB = -100.0


def test_dense_notes_match_reference(monkeypatch):
    """6 blocks of 14 notes per lane on 8 voices, 2 lanes of one
    ``BatchedRenderProgram`` with each lane's own notes: every block and
    lane within TOLERANCE_DB of the reference; the reference computed in
    bfloat16 misses it."""
    kinds = []
    place = VoicePlan._place

    def spy(self, ev, t, key, applied):
        voices = self.voices
        if all(segs and self._free_at(segs[-1]) > t for segs in voices):
            kinds.append("releasing" if any(
                segs[-1].release_key < applied for segs in voices)
                else "oldest")
        return place(self, ev, t, key, applied)
    monkeypatch.setattr(VoicePlan, "_place", spy)

    lanes, blocks = 2, 6
    template, _ = _program()
    batched = BatchedRenderProgram(template, lanes=lanes)
    states = batched.init_states()
    progs = [_program() for _ in range(lanes)]
    refs = [_reference(lanes), _reference(lanes, dtype=torch.bfloat16)]
    rng = np.random.default_rng(21)
    most = 0
    for b in range(blocks):
        for lane, (prog, s) in enumerate(progs):
            for start, note, vel, off in _notes(rng, b):
                nid = s.note_on(note, vel, time=start)
                s.note_off(nid, time=off)
                for ref in refs:
                    ref.note(lane, nid, start, note, vel, off)
        ins = [p.block_inputs(b) for p, _ in progs]
        most = max(most, max(int((i["extra"]["main/s"]["_trig_time"] < BLOCK)
                                 .sum(axis=1).max()) for i in ins))
        states, audio = batched.step(states, ins)
        want = refs[0].step().double().numpy()
        assert (_err_db(audio.numpy(), want) <= TOLERANCE_DB).all(), b
        if b < 2:  # the control, slow in bfloat16 on the CPU
            control = refs[1].step().double().numpy()
            assert (_err_db(control, want) > TOLERANCE_DB).all(), b
    assert most >= 3
    assert {"releasing", "oldest"} <= set(kinds)


def test_voice_renders_every_start():
    """One voice starts 4 notes in one block (each released after 500
    frames and free again before the next): each note sounds in its own
    stretch, as the reference renders it."""
    prog, s = _program(voices=1)
    ref = _reference(1, voices=1)
    starts = (100, 1100, 2100, 3100)
    for t in starts:
        nid = s.note_on(60, 0.8, time=t)
        s.note_off(nid, time=t + 500)
        ref.note(0, nid, t, 60, 0.8, t + 500)
    lowered = s.lower_block_inputs(0, BLOCK)
    assert lowered["_trig_time"][0].tolist() == list(starts)
    got = prog.render(BLOCK)
    want = ref.step()[0].numpy()
    for t in starts:
        sl = slice(t, t + 500)
        assert np.sqrt(np.mean(got[:, sl] ** 2)) > 0.05
    assert _err_db(got, want) <= TOLERANCE_DB


def test_plan_stays_flat_over_a_steady_part():
    """The same 14 notes in every block (held up to 3 blocks): after 200
    blocks the plan takes as many events per block and keeps as many notes
    as after 20, and every kept note can still sound.  Lowering an earlier
    block again (a second program over the same node) makes a new plan from
    the scheduled events, which lowers it as the first plan did."""
    prog, s = _program()
    lowered = {}
    rng = np.random.default_rng(5)
    pattern = [(start, note, vel, off) for start, note, vel, off in
               _notes(rng, 0)]
    seen = {}
    tracing.reset()
    tracing.enable()
    try:
        for b in range(201):
            for start, note, vel, off in pattern:
                nid = s.note_on(note, vel, time=b * BLOCK + start)
                s.note_off(nid, time=b * BLOCK + off)
            tracing.reset()
            lowered[b] = s.lower_block_inputs(b * BLOCK, BLOCK)
            if b in (20, 200):
                kept = [seg for segs in s._plan.voices for seg in segs]
                seen[b] = (tracing.counters()["generator.plan_events"],
                           len(kept), len(s._plan.notes))
                assert all(seg.start >= b * BLOCK or seg is segs[0]
                           for segs in s._plan.voices for seg in segs)
    finally:
        tracing.disable()
        tracing.reset()
    assert seen[20] == seen[200]
    assert seen[200][0] == 2 * len(pattern)
    plan = s._plan
    again = s.lower_block_inputs(20 * BLOCK, BLOCK)
    assert s._plan is not plan and sorted(again) == sorted(lowered[20])
    for k, a in lowered[20].items():
        np.testing.assert_array_equal(again[k], a, err_msg=k)


def _replay(gen, events, sample_rate):
    """The full replay the plan replaces (the JAX package's allocator): every
    event since the start, sorted, into per-voice note lists."""
    voices = [[] for _ in range(gen.options.voices)]
    by_id = {}
    for ev in sorted(events, key=lambda e: (e.time, e.note_id)):
        t = ev.time
        if ev.kind == "on":
            idx = next((v for v, segs in enumerate(voices) if not segs or
                        gen._voice_end(segs[-1], sample_rate) <= t), None)
            if idx is None:
                releasing = [(segs[-1].release, v) for v, segs in
                             enumerate(voices) if segs[-1].release <= t
                             ] if gen.envelope is not None else []
                idx = (min(releasing)[1] if releasing else
                       min(range(len(voices)),
                           key=lambda v: voices[v][-1].note_id))
            last = voices[idx][-1] if voices[idx] else None
            if last is not None and gen._voice_end(last, sample_rate) > t:
                last.cut = min(last.cut, t)
            seg = NoteSegment(t, ev.note, ev.note_id, ev.volume, ev.panning)
            voices[idx].append(seg)
            by_id[ev.note_id] = seg
        elif ev.kind == "off":
            seg = by_id.get(ev.note_id)
            if seg is not None and seg.release is math.inf:
                seg.release = float(max(t, seg.start))
        elif ev.kind == "all_off":
            for segs in voices:
                for seg in segs:
                    if seg.start <= t and seg.release is math.inf:
                        seg.release = float(t)
        elif ev.kind == "set_vol":
            seg = by_id.get(ev.note_id)
            if seg is not None and t >= seg.start:
                if seg.vol_tl is None:
                    seg.vol_tl = ParamTimeline(initial=seg.volume)
                seg.vol_tl.set_at(t, ev.value)
    return voices


@pytest.mark.parametrize("envelope", [True, False])
def test_plan_equals_replay(envelope):
    """Events scheduled a block ahead of the lowering (notes, note-offs at
    or after their notes, all-notes-offs, per-note volume) on 4 voices, 30
    blocks: each lowered block's continuing note and triggered notes (start,
    id, release, cut inside the block, volume automation) are those of a
    full replay of every event so far.  Where a voice's last note before
    the block was stolen at the block's first frame, the replay names an
    earlier, ended note as continuing, which no sample renders; the plan
    names none."""
    n, blocks = 1024, 30
    rng = np.random.default_rng(9 if envelope else 10)
    env = (0.001, 0.0, 0.002, 0.5, 0.005) if envelope else None
    _, s = _program(voices=4, env=env, block=n)
    events = []
    steals = 0
    for b in range(blocks + 1):
        before = len(s.events)
        for _ in range(int(rng.integers(0, 7))):
            t = b * n + int(rng.integers(0, n))
            nid = s.note_on(int(rng.integers(40, 80)), 0.5, time=t)
            if rng.random() < 0.9:
                s.note_off(nid, time=t + int(rng.integers(0, 3 * n)))
            if rng.random() < 0.2:
                s.set_note_volume(nid, 0.25, time=t + int(rng.integers(0, n)))
            if rng.random() < 0.05:
                s.all_notes_off(time=t + int(rng.integers(0, n)))
        events += s.events[before:]
        if b == 0:
            continue
        bs = (b - 1) * n
        lowered = s.lower_block_inputs(bs, n)
        voices = _replay(s, events, SR)
        for vi, segs in enumerate(voices):
            prior = [seg for seg in segs if seg.start < bs]
            cont = next((seg for seg in reversed(prior)
                         if max(seg.cut, seg.start) > bs), None)
            if prior and prior[-1].cut <= bs:
                cont = None
            trigs = [seg for seg in segs if bs <= seg.start < bs + n]
            plan_segs = s._plan.voices[vi]
            plan_cont = plan_segs[0] if plan_segs and (
                plan_segs[0].start < bs) and plan_segs[0].cut > bs else None
            plan_trigs = [seg for seg in plan_segs if seg.start >= bs]

            def key(seg):
                return None if seg is None else (
                    seg.start, seg.note_id, seg.release,
                    seg.cut if seg.cut < bs + n else math.inf,
                    [n] * 4 if seg.vol_tl is None else seg.vol_tl.lower_block(
                        bs, n, 4)[0].tolist())
            assert key(plan_cont) == key(cont), (b, vi)
            assert [key(x) for x in plan_trigs] == [key(x) for x in trigs]
            got = lowered["_trig_time"][vi]
            assert got[got < n].tolist() == [x.start - bs for x in trigs]
        steals = sum(seg.cut < b * n for segs in voices for seg in segs)
    assert steals >= 10 and s._plan.steals == steals


def test_note_mix_draws_from_the_seed():
    """The benchmark's note mix: one seed gives the same notes, another
    others; the count per block is the mix's rate and each note-off comes
    after its note within the mix's hold range."""
    mix = json.loads((PORTBENCH / "traffic" / "notes_dense.json").read_text())
    n = mix["block_frames"]

    def draw(seed):
        return [[note_events(mix, seed, lane, b, SR, "sampler")
                 for lane in range(2)] for b in range(3)]
    a, b, c = draw(2 ** 31 + 77), draw(2 ** 31 + 77), draw(12345)
    assert a == b and a != c and a[0][0] != a[0][1] and a[0][0] != a[1][0]
    per_block = mix["note_ons_per_audio_s"] * n / SR
    lo, hi = (x * SR for x in mix["note_seconds"])
    for blk, lanes in enumerate(a):
        for notes in lanes:
            assert abs(len(notes) - per_block) < 1
            for kind, key, note, onset, vel, off in notes:
                assert kind == "note" and key == "sampler"
                assert blk * n <= onset < (blk + 1) * n
                assert mix["notes"][0] <= note <= mix["notes"][1]
                assert mix["velocity"][0] <= vel <= mix["velocity"][1]
                assert lo - 1 <= off - onset <= hi + 1

"""The sampler path (phonic_tpu_torch/generators/sampler.py, ops/ahdsr.py,
ops/resample.loop_fold, graph/batching.LeafBatch) against the JAX package on
the CPU.

* The closed-form AHDSR against the JAX functions, to 1e-6.
* ``loop_fold`` against ``phonic_tpu.ops.resample.loop_fold``, exactly.
* The host lowering (voice allocation, steals, per-note automation knots)
  array by array, exactly.
* Renders of small graphs (2 blocks of 4096 frames) against the JAX render:
  dyadic notes (steps that sum exactly in float32) to -120 dB of peak, the
  rest to -90 dB.  The JAX sampler reads through its one-hot matmul form on
  the CPU, so even the dyadic case differs by the read's rounding.  Every
  case starts two notes on one voice in a block, and the JAX package keeps
  only the last of them, so these renders lower as it does (one trigger per
  voice and block); the renders of every note are held to the benchmark's
  plain reference (``portbench/reference/sampler.py``) where it has the
  case's features.
* The loop cases rendered with one stream per note (a test-local renderer,
  the JAX package's two streams per voice widened to every trigger) equal
  the port's one merged stream exactly.
* Two samplers in one pool equal the same two rendered apart, exactly.
* A JAX state carried over with ``state_from_jax`` renders the next block
  as the JAX program does, for a lone and a pooled sampler.
* BASELINE config 2 (bench.py ``config_sampler_64``, 64 voices) at
  4096-frame blocks against ``sampler_program``.
"""

import math
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import bench
import phonic_tpu as jp
import phonic_tpu_torch as pt
from phonic_tpu.generators.base import GeneratorPlaybackOptions as JOptions
from phonic_tpu.ops import ahdsr as jahdsr
from phonic_tpu.ops import resample as jresample
from phonic_tpu_torch.convert import state_from_jax
from phonic_tpu_torch.generators import sampler as psampler
from phonic_tpu_torch.ops import ahdsr as pahdsr
from phonic_tpu_torch.ops import convert as pconvert
from phonic_tpu_torch.ops import resample as presample

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "portbench"))
from reference.sampler import SamplerReference  # noqa: E402
from one_trigger import one_trigger  # noqa: E402

BLOCK = 4096
SR = 48000
DB90 = 10.0 ** (-90.0 / 20.0)
DB100 = 10.0 ** (-100.0 / 20.0)
DB120 = 10.0 ** (-120.0 / 20.0)


def _options(pkg):
    return JOptions if pkg is jp else pt.GeneratorPlaybackOptions


def _tone(pkg, frames, freq=150.0, sr=SR, ch=1, loop=None, mode="forward",
          taper=0):
    """A decaying sine per channel; ``taper`` frames fade it to 0 at its end
    (a one-shot that plays to the end then ends without a step, which
    would turn the packages' different float32 position rounding into
    error times the step)."""
    t = np.arange(frames) / sr
    f = freq * (1.0 + 0.5 * np.arange(ch))[:, None]
    x = 0.5 * np.sin(2 * np.pi * f * t) * np.exp(-t)
    if taper:
        x = x * np.clip((frames - np.arange(frames)) / taper, 0.0, 1.0)
    x = x.astype(np.float32)
    return pkg.AudioFileBuffer.from_array(x, sr, loop_range=loop, loop_mode=mode)


# ---------------------------------------------------------------------------
# 1. AHDSR
# ---------------------------------------------------------------------------

# (attack, hold, decay, sustain, release, attack scaling, decay scaling),
# seconds at 1 kHz so that every stage fits a 256-sample block
AHDSR_CASES = {
    "zero attack": (0.0, 0.0, 0.05, 0.5, 0.04, 0.0, 0.0),
    "hold": (0.02, 0.03, 0.05, 0.4, 0.04, 0.0, 0.0),
    "decay to 0": (0.01, 0.0, 0.06, 0.0, 0.03, 0.0, 0.0),
    "zero decay with hold": (0.01, 0.02, 0.0, 0.3, 0.0, 0.0, 0.0),
    "scaling +0.5": (0.04, 0.01, 0.08, 0.3, 0.05, 0.5, 0.5),
    "scaling -0.5": (0.04, 0.0, 0.08, 0.6, 0.05, -0.5, -0.5),
}


@pytest.mark.parametrize("case", sorted(AHDSR_CASES))
def test_ahdsr_matches_jax(case):
    """Four voices: held through the block, released mid-attack, mid-decay
    (mid-block), and one whose note starts inside the block; tolerance
    1e-6."""
    a, h, d, s, r, asc, dsc = AHDSR_CASES[case]
    sr, n = 1000, 256
    jp_ = jahdsr.ahdsr_params(sr, a, h, d, s, r, asc, dsc)
    pp = pahdsr.ahdsr_params(sr, a, h, d, s, r, asc, dsc)
    age0 = np.array([0, 0, 30, -40], np.int32)
    rel = np.array([np.inf, 7.0, 60.0, 100.0], np.float32)
    vol = 0.8
    want = np.stack([np.asarray(jahdsr.ahdsr_block(jp_, vol, a0, r0, n))
                     for a0, r0 in zip(age0, rel)])
    got = pahdsr.ahdsr_block(pp, vol, torch.as_tensor(age0)[:, None],
                             torch.as_tensor(rel)[:, None], n).numpy()
    assert want.max() > 0.2
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)

    ages = np.random.default_rng(1).integers(-5, 200, (4, n)).astype(np.int32)
    want = np.stack([np.asarray(jahdsr.ahdsr_values(jp_, vol, a_, r0))
                     for a_, r0 in zip(ages, rel)])
    got = pahdsr.ahdsr_values(pp, vol, torch.as_tensor(ages),
                              torch.as_tensor(rel)[:, None]).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)

    assert float(pahdsr.ahdsr_release_duration(pp)) == float(
        jahdsr.ahdsr_release_duration(jp_))


# ---------------------------------------------------------------------------
# 2. loop_fold
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["forward", "pingpong"])
def test_loop_fold_matches_jax(mode):
    """Positions before, inside and far past the loop (up to 300 loop
    lengths): bit for bit (``torch.remainder`` and ``jnp.mod`` are both the
    floored remainder of an exact fmod)."""
    rng = np.random.default_rng(2)
    pos = np.concatenate([rng.uniform(-10, 700, 4000),
                          rng.uniform(700, 2.0e5, 4000),
                          np.arange(0, 3000, 0.25)]).astype(np.float32)
    for start, end in ((300.0, 1000.0), (0.0, 1.0), (511.5, 700.25)):
        want = np.asarray(jresample.loop_fold(pos, start, end, mode))
        got = presample.loop_fold(torch.as_tensor(pos), start, end, mode).numpy()
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# 3. host lowering
# ---------------------------------------------------------------------------

LOWER_BLOCK = 1024


def _scripted(pkg, envelope: bool):
    """4 voices, 12 seeded notes over 3 blocks of 1024 (steals inside
    blocks), per-note volume / pan / speed events (one speed glide), and an
    all-notes-off."""
    rng = np.random.default_rng(7)
    env = pkg.AhdsrConfig(0.002, 0.001, 0.004, 0.5, 0.01) if envelope else None
    s = pkg.Sampler(_tone(pkg, 6000), _options(pkg)(voices=4, fade_out_secs=0.002),
                    envelope=env, name="s")
    ids = []
    for t in np.sort(rng.integers(0, 3 * LOWER_BLOCK - 200, 12)):
        nid = s.note_on(int(rng.integers(40, 80)), float(rng.uniform(0.3, 1.0)),
                        float(rng.uniform(-0.5, 0.5)), time=int(t))
        s.note_off(nid, time=int(t + rng.integers(600, 2500)))
        ids.append((nid, int(t)))
    s.set_note_volume(ids[1][0], 0.25, time=ids[1][1] + 100)
    s.set_note_panning(ids[2][0], -0.7, time=ids[2][1] + 40)
    s.set_note_speed(ids[3][0], 1.5, glide=48.0, time=ids[3][1] + 10)
    s.set_note_speed(ids[5][0], 0.75, time=ids[5][1] + 300)
    s.all_notes_off(time=2 * LOWER_BLOCK + 500)
    main = pkg.Mixer("main")
    main.add_source(s)
    return main, s


@pytest.mark.parametrize("envelope", [True, False])
def test_lowering_matches_jax(envelope):
    """Array by array, exactly.  The port gives every note that starts on a
    voice in a block a trigger slot (``_trig_*`` [V, K], ``_ta_*``
    [V, K, knots]); the JAX package keeps the last of them (``[V]``,
    ``[V, knots]``), so its arrays are compared with each voice's last used
    slot (slot 0 where none is used)."""
    jmain, js = _scripted(jp, envelope)
    pmain, ps = _scripted(pt, envelope)
    jp.RenderProgram(jmain, jp.EngineConfig(block_frames=LOWER_BLOCK))
    pt.RenderProgram(pmain, pt.EngineConfig(block_frames=LOWER_BLOCK,
                                            device="cpu"))
    for b in range(3):
        want = js.lower_block_inputs(b * LOWER_BLOCK, LOWER_BLOCK)
        got = ps.lower_block_inputs(b * LOWER_BLOCK, LOWER_BLOCK)
        tag = want.pop("_spd_tag")
        assert float(got.pop("_smax")) == 2.0 ** (len(tag) - 1)
        assert sorted(got) == sorted(want)
        used = (got["_trig_time"] < LOWER_BLOCK).sum(axis=1)
        last = np.maximum(used - 1, 0)
        for k in want:
            w, g = np.asarray(want[k]), np.asarray(got[k])
            if k.startswith(("_trig_", "_ta_")):
                g = g[np.arange(len(g)), last]
            assert g.dtype == w.dtype and g.shape == w.shape, k
            np.testing.assert_array_equal(g, w, err_msg=k)
    assert "_ca_spd_t" in got and ps._plan.steals >= 3


# ---------------------------------------------------------------------------
# 4. renders against the JAX package
# ---------------------------------------------------------------------------

def _case(pkg, case):
    """(mixer, schedule) of one render case; ``schedule(prog)`` adds the
    program-level events (the same calls on either package's program)."""
    rng = np.random.default_rng(11)
    opts = _options(pkg)
    env = pkg.AhdsrConfig(0.005, 0.01, 0.02, 0.5, 0.03)
    sched = []
    if case == "dyadic":
        s = pkg.Sampler(_tone(pkg, 30000), opts(voices=6), envelope=env, name="s")
        notes = [36, 48, 60, 72, 84]
    elif case == "nondyadic":
        # a 44.1 kHz stereo buffer, transpose / finetune automation
        s = pkg.Sampler(_tone(pkg, 30000, sr=44100, ch=2), opts(voices=6),
                        envelope=env, transpose=3, finetune=-20, name="s")
        notes = list(rng.integers(45, 75, 5))
        sched = [("STRN", -5, BLOCK + 700), ("SFTN", 35, BLOCK + 1900),
                 ("SVOL", 0.5, 900), ("SPAN", 0.4, BLOCK + 100)]
    elif case == "oneshot":
        s = pkg.Sampler(_tone(pkg, 3000, taper=500),
                        opts(voices=4, fade_out_secs=0.01), name="s")
        notes = list(rng.integers(50, 70, 5))
    elif case in ("loop forward", "loop pingpong"):
        mode = case.split()[1]
        s = pkg.Sampler(_tone(pkg, 5000, loop=(1000, 2500), mode=mode),
                        opts(voices=4), envelope=env, name="s")
        s.set_loop_range((400, 4100), time=BLOCK)
        notes = list(rng.integers(50, 75, 5))
    elif case == "note automation":
        s = pkg.Sampler(_tone(pkg, 20000), opts(voices=4), envelope=env,
                        name="s")
        notes = list(rng.integers(50, 70, 5))
    ids = []
    for k, note in enumerate(notes * 2):
        t = int(k * 750 + rng.integers(0, 200))
        nid = s.note_on(int(note), float(rng.uniform(0.4, 1.0)),
                        float(rng.uniform(-0.6, 0.6)), time=t)
        s.note_off(nid, time=t + int(rng.integers(400, 5000)))
        ids.append((nid, t))
    if case == "note automation":
        s.set_note_volume(ids[0][0], 0.3, time=ids[0][1] + 500)
        s.set_note_panning(ids[1][0], 0.9, time=ids[1][1] + 200)
        s.set_note_speed(ids[2][0], 1.8, glide=24.0, time=ids[2][1] + 100)
        s.set_note_speed(ids[6][0], 0.6, time=ids[6][1] + 1000)
    main = pkg.Mixer("main")
    main.add_source(s)

    def schedule(prog):
        for pid, value, at in sched:
            prog.set_parameter("main/s", pid, value, at_frame=at)
        # a sampler ignores stop / kill frames (as in the JAX package)
        prog.stop_source("main/s", at_frame=BLOCK + 300)
    return main, schedule


RENDER_CASES = ("dyadic", "nondyadic", "oneshot", "loop forward",
                "loop pingpong", "note automation")


def _program(pkg, case, **config):
    main, schedule = _case(pkg, case)
    if pkg is jp:
        prog = jp.RenderProgram(main, jp.EngineConfig(block_frames=BLOCK,
                                                      **config))
    else:
        prog = pt.RenderProgram(main, pt.EngineConfig(
            block_frames=BLOCK, device="cpu", **config))
    schedule(prog)
    return prog


def _close(got, want, bound):
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    peak = np.abs(want).max()
    assert peak > 0.1
    assert np.abs(got - want).max() <= bound * peak


def _starts_per_voice(case) -> int:
    """The most notes that start on one voice in one block of ``case``."""
    s = _program(pt, case).nodes["main/s"]
    return max(int((s.lower_block_inputs(b * BLOCK, BLOCK)["_trig_time"]
                    < BLOCK).sum(axis=1).max()) for b in range(2))


@pytest.mark.parametrize("case", RENDER_CASES)
def test_render_matches_jax(case, monkeypatch):
    """Every case starts two notes on a voice in block 0
    (``_starts_per_voice``), of which the JAX package renders the last
    only: the port renders here with the JAX package's lowering
    (``one_trigger``), and the render of every note is compared with the
    plain reference (``test_render_matches_reference``)."""
    assert _starts_per_voice(case) >= 2
    want = _program(jp, case).render(2 * BLOCK, mode="loop")
    one_trigger(monkeypatch, psampler.Sampler)
    got = _program(pt, case).render(2 * BLOCK)
    bound = DB120 if case == "dyadic" else DB90
    for b in range(2):
        sl = slice(b * BLOCK, (b + 1) * BLOCK)
        _close(got[:, sl], want[:, sl], bound)


def _reference_render(case, blocks: int) -> np.ndarray:
    """The plain reference's render of ``case``: the sampler's notes as
    scheduled and the program's SVOL / SPAN / STRN / SFTN events."""
    prog = _program(pt, case)
    s = prog.nodes["main/s"]
    offs = {e.note_id: e.time for e in s.events if e.kind == "off"}
    env = s.envelope
    ref = SamplerReference(
        np.asarray(s.buffer.data)[:, :-1], s.buffer.sample_rate, SR, 1,
        BLOCK, s.options.voices,
        None if env is None else (env.attack, env.hold, env.decay,
                                  env.sustain, env.release),
        "cpu", volume=s.options.volume, panning=s.options.panning,
        transpose=s.transpose, finetune=s.finetune,
        fade_out_secs=s.options.fade_out_secs)
    for e in s.events:
        if e.kind == "on":
            ref.note(0, e.note_id, e.time, e.note, e.volume,
                     offs.get(e.note_id, math.inf), e.panning)
    out = []
    for b in range(blocks):
        for pid in ("SVOL", "SPAN", "STRN", "SFTN"):
            tl = prog.timelines[("main/s", pid)]
            for t, v in zip(tl.times, tl.values):
                if b * BLOCK <= t < (b + 1) * BLOCK:
                    ref.set(0, pid, t, v)
        out.append(ref.step()[0])
    return torch.cat(out, dim=-1).numpy()


@pytest.mark.parametrize("case", ["dyadic", "nondyadic", "oneshot"])
def test_render_matches_reference(case):
    """Every note of the cases whose features the plain reference has
    (not the loops, not per-note automation), two on one voice in block 0,
    against the reference in float64 to -100 dB of peak: the port's float32
    envelope and sums sit near -140 dB; the reference computed in bfloat16
    misses by more than -60 dB."""
    assert _starts_per_voice(case) >= 2
    got = _program(pt, case).render(2 * BLOCK)
    want = _reference_render(case, 2)
    for b in range(2):
        sl = slice(b * BLOCK, (b + 1) * BLOCK)
        _close(got[:, sl], want[:, sl], DB100)


# ---------------------------------------------------------------------------
# 5. the merged read stream
# ---------------------------------------------------------------------------

def _two_stream_process(self, state, params, voices, smax, live, read, ctx):
    """The JAX package's two-lane form of the sampled path (sampler.py
    :766-861), widened to every trigger slot: the continuing note and each
    triggered note (live until the next trigger) get their own folded
    positions, read as (K+1)V streams, their own envelope, gains and pan,
    and the streams are summed."""
    n = ctx.block_frames
    g, v, k = voices["_trig_time"].shape
    ii = torch.arange(n, dtype=torch.int32)
    ratio = float(np.float32(self.buffer.sample_rate / ctx.sample_rate))
    pitch = torch.exp2(params["STRN"] / 12.0 + params["SFTN"] / 1200.0)[:, None]
    env_p = pahdsr.ahdsr_params(ctx.sample_rate, *(
        params[p][:, 0, None, None] for p in ("AATK", "AHLD", "ADCY", "ASTN",
                                               "AREL")))
    t_time = voices["_trig_time"]
    t_next = torch.cat([t_time[..., 1:], torch.full_like(t_time[..., :1], n)],
                       dim=-1)
    loop_on = voices["_loop_on"][:, None, None] > 0.5

    def lane(spd, mask, pos0):
        steps = torch.where(mask, torch.clamp(pitch * spd[..., None] * ratio,
                                              max=smax), 0.0)
        run = torch.cumsum(steps.double(), -1).float()
        pos = pos0[..., None] + torch.cat([torch.zeros_like(run[..., :1]),
                                           run[..., :-1]], -1)
        folded = presample.loop_fold(pos, voices["_loop_start"][:, None, None],
                                     voices["_loop_end"][:, None, None],
                                     self.buffer.loop_mode)
        live_ = loop_on | (pos < voices["_buf_frames"][:, None, None])
        return (torch.where(loop_on, folded, pos), mask & live_,
                pos[..., -1] + steps[..., -1], run[..., -1])

    def post(pos, mask, age0, rel, vol, pan):
        """One stream of every voice: [G, V, 2, n]."""
        audio = read(pos.reshape(g * v, n)).reshape(g, v, n)
        env = pahdsr.ahdsr_block(env_p, 1.0, age0[..., None], rel[..., None], n)
        gain = env * (params["SVOL"][:, None] * vol[..., None]) * mask.float()
        left, right = pconvert.panning_factors(torch.clamp(
            params["SPAN"][:, None] + pan[..., None], -1.0, 1.0))
        y = audio * gain
        return torch.stack([y * left, y * right], dim=2)

    mask_a = (voices["_cont_active"] > 0.5)[..., None] & (ii < t_time[..., :1])
    pa, ma, end, _ = lane(voices["_cont_spd"], mask_a,
                          state["base"].float() + state["frac"])
    out = post(pa, ma, voices["_cont_age0"], voices["_cont_rel"],
               voices["_cont_vol"], voices["_cont_pan"])
    for j in range(k):
        t = t_time[..., j]
        mask_j = (ii >= t[..., None]) & (ii < t_next[..., j, None])
        pj, mj, _, end_j = lane(voices["_trig_spd"][..., j], mask_j,
                                torch.zeros(g, v))
        out = out + post(pj, mj, -t, voices["_trig_rel"][..., j],
                         voices["_trig_vol"][..., j],
                         voices["_trig_pan"][..., j])
        end = torch.where(t < n, end_j, end)
    base = torch.floor(end)
    return {"base": base.int(), "frac": end - base}, out.sum(dim=1)


@pytest.mark.parametrize("case", ["loop forward", "loop pingpong"])
def test_merged_stream_equals_two_streams(case, monkeypatch):
    """Reading each voice's notes (two start on one voice in block 0) as one
    merged stream leaves the looped render unchanged, bit for bit."""
    assert _starts_per_voice(case) >= 2
    got = _program(pt, case).render(2 * BLOCK)
    monkeypatch.setattr(psampler.Sampler, "process", _two_stream_process)
    want = _program(pt, case).render(2 * BLOCK)
    assert np.abs(want).max() > 0.1
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# 6. pools
# ---------------------------------------------------------------------------

def _pair(pkg):
    """Two samplers with one pool key: buffers of different lengths, loops,
    their own notes and automation."""
    rng = np.random.default_rng(5)
    env = pkg.AhdsrConfig(0.004, 0.0, 0.03, 0.6, 0.02)
    main = pkg.Mixer("main")
    for i, frames in enumerate((7000, 11000)):
        s = pkg.Sampler(_tone(pkg, frames, freq=120.0 + 90 * i,
                              loop=(500, 3000 + 2000 * i)),
                        _options(pkg)(voices=5, volume=0.7 + 0.2 * i),
                        envelope=env, transpose=i, name=f"s{i}")
        for k in range(8):
            t = int(k * 900 + rng.integers(0, 300))
            nid = s.note_on(int(rng.integers(45, 75)), float(rng.uniform(0.4, 1.0)),
                            time=t)
            s.note_off(nid, time=t + int(rng.integers(500, 4000)))
        if i == 1:
            s.set_note_speed(nid, 1.3, time=t + 200)
            s.set_loop_range((200, 9000), time=BLOCK)
        main.add_source(s)
    return main


def test_pool_equals_unpooled():
    progs = [pt.RenderProgram(_pair(pt), pt.EngineConfig(
        block_frames=BLOCK, batch_sources=batch, device="cpu"))
        for batch in (True, False)]
    assert [len(p.pools) for p in progs] == [1, 2]
    got, want = (p.render(2 * BLOCK) for p in progs)
    assert np.abs(want).max() > 0.1
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# 7. state carried over from the JAX package
# ---------------------------------------------------------------------------

def _lone(pkg):
    main, _ = _case(pkg, "loop forward")
    return main


@pytest.mark.parametrize("graph", [_lone, _pair], ids=["lone", "pooled"])
def test_state_carried_from_jax(graph):
    jprog = jp.RenderProgram(graph(jp), jp.EngineConfig(block_frames=BLOCK))
    assert len(jprog.gen_batches) == (graph is _pair)
    want = jprog.render(2 * BLOCK, mode="loop")
    state1, _ = jprog.step_packed(jprog.init_state(),
                                  jprog.packed_block_inputs(0))
    prog = pt.RenderProgram(graph(pt), pt.EngineConfig(block_frames=BLOCK,
                                                       device="cpu"))
    state = state_from_jax(jax.device_get(state1), prog)
    assert state["pools"][0]["base"].abs().sum() > 0
    _, y = prog.step(state, prog.block_inputs(1))
    _close(y.numpy(), want[:, BLOCK:], DB90)


# ---------------------------------------------------------------------------
# 8. BASELINE config 2
# ---------------------------------------------------------------------------

def test_sampler64_matches_bench_config():
    """bench.py's 64-voice sampler rebuilt at 4096-frame blocks, 2 blocks,
    against ``sampler_program`` to -90 dB of each block's peak."""
    jprog = jp.RenderProgram(bench.config_sampler_64().root,
                             jp.EngineConfig(sample_rate=SR, block_frames=BLOCK))
    want = jprog.render(2 * BLOCK, mode="loop")
    prog = pt.sampler_program(block_frames=BLOCK, device="cpu")
    assert len(prog.pools) == 1 and prog.pools[0].smap.shape == (64,)
    got = prog.render(2 * BLOCK)
    for b in range(2):
        sl = slice(b * BLOCK, (b + 1) * BLOCK)
        _close(got[:, sl], want[:, sl], DB90)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def test_sampler_program_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; chip_smoke.py covers this path")
    with pytest.raises(RuntimeError, match="cuda"):
        pt.sampler_program(block_frames=BLOCK)
    with pytest.raises(RuntimeError, match="cuda"):
        pt.RenderProgram(pt.sampler_graph())


def test_unported_surface_raises():
    """What is still refused.  The granular calls, which raised before the
    granular slice, now work: modulation needs granular playback first (as
    in the JAX package), and routings take the config's source and target
    ids."""
    s = pt.Sampler(_tone(pt, 1000))
    with pytest.raises(ValueError, match="with_granular_playback"):
        s.with_modulation(pt.ModulationConfig(
            sources=(pt.VelocitySource(),), targets=psampler.TARGETS))
    assert s.with_granular_playback() is s and s.granular is not None
    assert s.with_modulation(pt.ModulationConfig(
        sources=(pt.LfoSource("LFO1"), pt.EnvelopeSource("ENV1")),
        targets=psampler.TARGETS)) is s
    s.set_modulation("ENV1", "GPOS", 0.5)
    assert s.modulation.amounts[1, 5] == 0.5
    s.clear_modulation("ENV1", "GPOS")
    assert not s.modulation.amounts.any()
    with pytest.raises(KeyError):
        s.set_modulation("LFO 1", "Position", 0.5)
    with pytest.raises(RuntimeError, match="prepare"):
        s.lower_block_inputs(0, BLOCK)

    class Other(pt.Generator):
        pass

    main = pt.Mixer("main")
    main.add_source(Other())
    with pytest.raises(NotImplementedError, match="Other"):
        pt.RenderProgram(main, pt.EngineConfig(device="cpu"))

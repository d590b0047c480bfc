"""The granular path (phonic_tpu_torch/generators/granular.py,
modulation/, the granular part of generators/sampler.py) against the JAX
package on the CPU, where it renders through its gather path.

* The window LUTs and their lerp lookup, all 8 windows: exact.
* The playhead with a loop range at dyadic steps over a power-of-two
  buffer (sums that are exact in float32): exact.
* Allocation (``granular_voice_alloc``) of three voices at once against the
  JAX function per voice: the slot state bit for bit but ``g_inc``, which
  carries the pitch draw's exp2, to one float32 ulp (XLA's float32 exp2 is
  correctly rounded for ~98.5 % of the draws' arguments, the port rounds a
  float64 exp2, so that the card and the CPU agree); weights to 1e-6,
  read positions to 2**-22 of the buffer (two float32 ulps of a normalized
  position: the port evaluates ``pos0 + local * inc`` as one fused
  multiply-add, as XLA's CPU code does inside a render, not in this
  function alone, and a loop fold keeps that error absolute); with free
  slots, a slot that expires exactly at the chunk start and one that
  expires a frame later.
* ``grain_mix`` to 1e-6 of peak, and the one-chunk composition
  ``granular_voice_block`` (the read of the circularly extended source at
  ``fidx + 1``) to -100 dB of peak: the positions' two ulps above times the
  tone's slope, where a wrong tap or wrap would be far larger.
* The modulation sources of a custom config (7 LFO waveforms, velocity,
  keytracking, an AHDSR envelope) and the matrix in all four polarity
  cases, to 1e-6.
* Renders of granular samplers to -90 dB of each block's peak: Cloud and
  Sequential, the three directions, a loop range set mid-render, a steal,
  an AHDSR envelope, routings set and cleared between blocks; and a JAX
  state carried over with ``state_from_jax``, for a lone granular sampler
  and for two granular samplers (pools of their own) beside a batched
  sampled pair.  Densities are 93.75 or 46.875 Hz, whose steps per sample
  at 48 kHz (2**-9, 2**-10) sum exactly in float32: at 100 Hz the packages'
  trigger sums differ in the last ulp and a grain may start one sample
  apart (scripts/torch_granular_parity.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import phonic_tpu as jp
import phonic_tpu_torch as pt
from phonic_tpu.generators import granular as jgran
from phonic_tpu.generators.base import GeneratorPlaybackOptions as JOptions
from phonic_tpu.modulation import matrix as jmatrix
from phonic_tpu_torch.convert import state_from_jax
from phonic_tpu_torch.generators import granular as pgran
from phonic_tpu_torch.generators import sampler as psampler
from phonic_tpu_torch.modulation import matrix as pmatrix
from one_trigger import one_trigger

SR = 48000
FRAMES = 8192  # a power of two: dyadic playhead steps stay exact
DB90 = 10.0 ** (-90.0 / 20.0)
F32 = np.float32


def _options(pkg):
    return JOptions if pkg is jp else pt.GeneratorPlaybackOptions


def _tone(pkg, frames=FRAMES):
    t = np.arange(frames) / SR
    x = (0.5 * np.sin(2 * np.pi * 150.0 * t) * np.exp(-t)).astype(F32)
    return pkg.AudioFileBuffer.from_array(x[None], SR)


# ---------------------------------------------------------------------------
# 1. windows and the playhead
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", range(8), ids=pgran.WINDOW_MODES)
def test_window_matches_jax(mode):
    """The LUT row and its lerp lookup at phases inside, at and past [0, 1]:
    bit for bit."""
    np.testing.assert_array_equal(pgran.grain_windows(),
                                  np.asarray(jgran.grain_windows()))
    phase = np.concatenate([np.random.default_rng(mode).uniform(-0.1, 1.1, 4000),
                            np.linspace(0.0, 1.0, 2049)]).astype(F32)
    modes = np.full(phase.shape, mode, np.int32)
    want = np.asarray(jgran.window_sample(jnp.asarray(modes), jnp.asarray(phase)))
    got = pgran.window_sample(torch.as_tensor(modes), torch.as_tensor(phase))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("loop_on", [1.0, 0.0])
def test_playhead_matches_jax(loop_on):
    """Three voices: one enters the loop mid-block, one starts inside it
    (latched), one moves backwards with masked samples; steps of 2**-12,
    2**-13 and -2**-11 per sample (exact sums): bit for bit."""
    n = 1024
    steps = np.stack([np.full(n, 2.0 ** -12), np.full(n, 2.0 ** -13),
                      np.where(np.arange(n) % 3 == 0, 0.0, -2.0 ** -11)]
                     ).astype(F32)
    ph0 = np.array([0.125, 0.5, 0.0625], F32)
    in0 = np.array([0.0, 1.0, 0.0], F32)
    loop = (F32(loop_on), F32(0.25), F32(0.75))
    for v in range(3):
        want = jgran.playhead_trajectory(ph0[v], in0[v], jnp.asarray(steps[v]),
                                         loop)
        got = pgran.playhead_trajectory(torch.as_tensor(ph0), torch.as_tensor(in0),
                                        torch.as_tensor(steps), loop)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g[v].numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# 2. allocation, the mix and the read
# ---------------------------------------------------------------------------

V, N, FRAME0 = 3, 1024, 2048


def _alloc_inputs(seed):
    """Per-sample inputs of three voices ([V, N], as the sampler gives
    them), note starts (a note before the chunk, one inside it, none) and
    an initial pool: free slots, slot 0 whose grain ended exactly at the
    chunk start (free), slot 1 whose grain ends a frame later (busy)."""
    rng = np.random.default_rng(seed)

    def per(lo, hi):
        return rng.uniform(lo, hi, (V, N)).astype(F32)

    inputs = dict(
        held=rng.random((V, N)) < 0.95, speed=per(0.5, 2.0),
        vol=per(0.2, 1.0), pan=per(-0.6, 0.6), size_ms=per(5.0, 40.0),
        density=np.full((V, N), 93.75, F32), variation=per(0.0, 1.0),
        spray=per(0.0, 0.5), pan_spread=per(0.0, 1.0),
        position=np.full((V, N), 0.4, F32), pos_mod=per(-0.1, 0.1),
        step=np.full((V, N), 2.0 ** -4, F32), speed_mod=np.zeros((V, N), F32),
        window_mode=np.tile(rng.integers(0, 8, N).astype(np.int32), (V, 1)),
        direction=np.tile(rng.integers(0, 3, N).astype(np.int32), (V, 1)))
    note_start = np.array([FRAME0 - 700, FRAME0 + 300, pgran.NEVER], np.int32)
    state = {k: np.asarray(x) for k, x in jgran.grain_state_init().items()}
    state = {k: np.stack([x] * V) for k, x in state.items()}
    busy = np.concatenate([[0, 1], 2 + rng.choice(98, 58, replace=False)])
    state["g_trig"][:, busy] = FRAME0 - 50
    state["g_dur"][:, busy] = 200
    state["g_trig"][:, :2] = FRAME0 - 300
    state["g_dur"][:, 0] = 300  # ends exactly at the chunk start
    state["g_dur"][:, 1] = 301  # one frame later
    state["g_pos0"][:, busy] = rng.uniform(0, 1, 60).astype(F32)
    state["g_inc"][:, busy] = rng.uniform(-1e-4, 1e-4, 60).astype(F32)
    state["g_winc"][:, busy] = F32(1.0 / 300.0)
    state["g_vol"][:, busy] = F32(0.5)
    state["trigger_phase"][:] = F32(0.875)
    seeds = np.array([0x6A17 ^ (v + 1) * 0x51ED for v in range(V)], np.int32)
    return inputs, note_start, state, seeds


def _jax_alloc(state, inputs, note_start, seeds, overlap, loop, read=False):
    """The JAX package's one-voice function under vmap."""
    def one(st, inp, ns, sd):
        kw = dict(frame0=FRAME0, n=N, sr=SR, loop_range=loop, note_start=ns,
                  overlap_mode=overlap, seed=sd, max_triggers=5, **inp)
        if read:
            return jgran.granular_voice_block(st, mono_buf=jnp.asarray(
                _tone(jp).data[0, :-1]), **kw)
        return jgran.granular_voice_alloc(st, frames=FRAMES, **kw)
    return jax.vmap(one)(
        {k: jnp.asarray(x) for k, x in state.items()},
        {k: jnp.asarray(x) for k, x in inputs.items()},
        jnp.asarray(note_start), jnp.asarray(seeds))


def _port_args(state, inputs, note_start, seeds, overlap, loop):
    return dict(state={k: torch.as_tensor(x) for k, x in state.items()},
                frame0=FRAME0, n=N, sr=SR, frames=FRAMES, loop_range=loop,
                note_start=torch.as_tensor(note_start), overlap_mode=overlap,
                seed=torch.as_tensor(seeds), max_triggers=5,
                **{k: torch.as_tensor(x) for k, x in inputs.items()})


@pytest.mark.parametrize("overlap", [0, 1], ids=pgran.OVERLAP_MODES)
@pytest.mark.parametrize("loop_on", [1.0, 0.0], ids=["loop", "no loop"])
def test_alloc_matches_jax(overlap, loop_on):
    inputs, note_start, state, seeds = _alloc_inputs(overlap)
    loop = (F32(loop_on), F32(0.25), F32(0.75))
    want_state, want_fidx, want_g = _jax_alloc(state, inputs, note_start, seeds,
                                               overlap, loop)
    got_state, got_fidx, got_g = pgran.granular_voice_alloc(
        **_port_args(state, inputs, note_start, seeds, overlap, loop))
    assert sorted(got_state) == sorted(want_state)
    for k, w in want_state.items():
        w, g = np.asarray(w), got_state[k].numpy()
        assert g.dtype == w.dtype, k
        if k == "g_inc":
            np.testing.assert_allclose(g, w, rtol=2.0 ** -23, atol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)
    np.testing.assert_allclose(got_fidx.numpy(), np.asarray(want_fidx),
                               rtol=0, atol=2.0 ** -22 * FRAMES)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=0,
                               atol=1e-6)
    # grains landed; the voice without a note took none
    trig = got_state["g_trig"].numpy()
    new = (trig >= FRAME0) & (trig != pgran.NEVER)
    assert new[:2].sum() >= 2 and not new[2].any()
    assert (got_g.numpy() > 0).sum() > 1000
    # the slot that ended at the chunk start was reusable, the one a frame
    # later was not; new grains fill the free slots in index order
    if overlap == 0:
        assert new[0, 0] and not new[0, 1]
        free0 = np.flatnonzero((state["g_trig"][0] == pgran.NEVER)
                               | (state["g_trig"][0] + state["g_dur"][0]
                                  <= FRAME0))
        np.testing.assert_array_equal(np.flatnonzero(new[0]),
                                      free0[:new[0].sum()])


def test_grain_mix_matches_jax():
    rng = np.random.default_rng(4)
    s = rng.normal(size=(V, 100, 512)).astype(F32)
    g = rng.uniform(0, 1, (V, 100, 512)).astype(F32)
    pan = rng.uniform(-1, 1, (V, 100)).astype(F32)
    want = np.asarray(jax.vmap(jgran.grain_mix)(s, g, pan))
    got = pgran.grain_mix(torch.as_tensor(s), torch.as_tensor(g),
                          torch.as_tensor(pan)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())


def test_voice_block_matches_jax():
    """One chunk allocated, read from the circularly extended source (one
    ramp_read at fidx + 1) and mixed, against the JAX package's gather read
    with its circular tap wrap: to 1e-6 of peak."""
    inputs, note_start, state, seeds = _alloc_inputs(5)
    loop = (F32(0.0), F32(0.0), F32(1.0))
    _, want = _jax_alloc(state, inputs, note_start, seeds, 0, loop, read=True)
    table = torch.as_tensor(pgran.source_table(_tone(pt).data[0, :-1]))
    _, got = pgran.granular_voice_block(
        mono_table=table, **_port_args(state, inputs, note_start, seeds, 0, loop))
    want = np.asarray(want)
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


# ---------------------------------------------------------------------------
# 3. modulation
# ---------------------------------------------------------------------------

def _mod_config(pkg):
    return pkg.ModulationConfig(
        sources=(pkg.LfoSource("LFO1", rate=3.0), pkg.LfoSource("LFO2", rate=7.5),
                 pkg.VelocitySource(), pkg.KeytrackingSource(),
                 pkg.EnvelopeSource("ENV1", attack=0.002, hold=0.001,
                                    decay=0.004, sustain=0.4, release=0.003)),
        targets=pmatrix.TARGETS)


@pytest.mark.parametrize("wave", range(7), ids=lambda w: f"wave{w}")
def test_modulation_matches_jax(wave):
    """Sources of three voices (a retrigger mid-block, a release) and the
    matrix with random amounts and target polarities, so that every
    (source, target) polarity pair occurs: to 1e-6."""
    n = 2048
    rng = np.random.default_rng(wave)
    cfg = _mod_config(pt)
    params = {"ML1R": np.full(n, 3.0, F32), "ML1W": np.full(n, wave, F32),
              "ML2R": np.full(n, 7.5, F32), "ML2W": np.full(n, 6 - wave, F32),
              "ME1A": np.full(n, 0.002, F32), "ME1H": np.full(n, 0.001, F32),
              "ME1D": np.full(n, 0.004, F32), "ME1S": np.full(n, 0.4, F32),
              "ME1R": np.full(n, 0.003, F32)}
    i = np.arange(n)
    age = np.stack([i + 5000, np.where(i < 700, i + 20, i - 700), i - 100]
                   ).astype(np.int32)
    vel = np.stack([np.full(n, 0.8), np.where(i < 700, 0.3, 0.9),
                    np.full(n, 0.5)]).astype(F32)
    note = np.stack([np.full(n, 60), np.where(i < 700, 48, 72),
                     np.full(n, 100)]).astype(F32)
    rel = np.stack([np.full(n, np.inf), np.full(n, 600.0),
                    np.full(n, 300.0)]).astype(F32)
    seeds = np.array([0x6A17 ^ 0x9E37 * (v + 1) for v in range(3)])
    amounts = rng.uniform(-1, 1, (5, 7)).astype(F32)
    bipolar = (rng.random((5, 7)) < 0.5).astype(F32)
    src_bip = pmatrix.source_polarity(cfg)
    assert {(s, b) for s in src_bip for b in bipolar[src_bip == s].ravel()} == {
        (0.0, 0.0), (0.0, 1.0), (1.0, 0.0), (1.0, 1.0)}

    jspecs = jmatrix.build_source_specs(_mod_config(jp), {
        k: jnp.asarray(x) for k, x in params.items()}, SR)
    pspecs = pmatrix.build_source_specs(cfg, {
        k: torch.as_tensor(x) for k, x in params.items()}, SR)
    got_src = pmatrix.eval_sources(
        pspecs, torch.as_tensor(age), torch.as_tensor(vel),
        torch.as_tensor(note), torch.as_tensor(rel), n,
        seed=torch.as_tensor(seeds)[:, None])
    got = pmatrix.apply_matrix(got_src, torch.as_tensor(amounts),
                               torch.as_tensor(bipolar), src_bip)
    for v in range(3):
        want_src = jmatrix.eval_sources(jspecs, age[v], vel[v], note[v], rel[v],
                                        n, seed=int(seeds[v]))
        want = jmatrix.apply_matrix(want_src, amounts, bipolar, src_bip)
        np.testing.assert_allclose(got_src[v].numpy(), np.asarray(want_src),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(got[v].numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6)
    assert np.asarray(want_src)[4].max() > 0.1  # the envelope sounds


def test_stock_source_values_match_jax():
    """The stock layout's ``source_values`` (LFO1 ramp-up, LFO2 random):
    to 1e-6."""
    n = 1024
    age = np.arange(n, dtype=np.int32) - 10
    want = jmatrix.source_values(jnp.asarray(age), 0.7, 64.0, F32(5.0 / SR), 2,
                                 F32(11.0 / SR), 5, n, seed=3)
    got = pmatrix.source_values(torch.as_tensor(age), 0.7, 64.0,
                                torch.tensor(F32(5.0 / SR)), 2,
                                torch.tensor(F32(11.0 / SR)), 5, n, seed=3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# 4. renders against the JAX package
# ---------------------------------------------------------------------------

BLOCKS = {"cloud": 4096, "sequential": 1024, "loop": 4096}


def _graph(pkg, case):
    """(mixer, sampler) of one render case.  ``cloud``: 4096-frame blocks
    (two allocation chunks), forward grains, an AHDSR envelope, a steal (3
    voices, 4 notes), routings of the stock sources to position, pan
    spread and spray.  ``sequential``: 1024-frame blocks (one chunk),
    backward grains, Tukey windows.  ``loop``: random directions, a moving
    playhead (step 2**-15 per sample), a loop range set at the second
    block, a custom config with an envelope source."""
    cfg = dict(size_ms=40.0, density_hz=93.75, variation=0.5, spray=0.3,
               pan_spread=0.8)
    if case == "sequential":
        cfg.update(overlap_mode="Sequential", direction="Backward",
                   window="Tukey", density_hz=46.875)
    elif case == "loop":
        cfg.update(direction="Random", step=0.25, window="Blackman")
    s = pkg.Sampler(_tone(pkg), _options(pkg)(voices=3), name="s",
                    transpose=2).with_granular_playback(pkg.GranularConfig(**cfg))
    if case == "cloud":
        s.with_ahdsr(0.002, 0.001, 0.01, 0.6, 0.01)
        s.set_modulation("LFO1", "GPOS", 0.2)
        s.set_modulation("KEYM", "GPAN", 0.5, bipolar=False)
        s.set_modulation("VELM", "GSPY", 0.3)
    elif case == "loop":
        s.with_modulation(_mod_config(pkg))
        s.set_modulation("ENV1", "GPOS", 0.1, bipolar=False)
        s.set_loop_range((2048, 6144), time=BLOCKS[case])
    for k, (t, note) in enumerate(((0, 60), (37, 67), (300, 55), (2500, 72))):
        nid = s.note_on(note, volume=0.5 + 0.1 * k, panning=0.2 * k - 0.3,
                        time=t)
        s.note_off(nid, time=t + 3000)
    main = pkg.Mixer("main")
    main.add_source(s)
    return main, s


def _programs(case):
    n = BLOCKS[case]
    jmain, js = _graph(jp, case)
    pmain, ps = _graph(pt, case)
    return (jp.RenderProgram(jmain, jp.EngineConfig(block_frames=n)), js,
            pt.RenderProgram(pmain, pt.EngineConfig(block_frames=n,
                                                    device="cpu")), ps)


def _close(got, want, bound=DB90, min_peak=0.05):
    assert got.shape == want.shape and np.isfinite(got).all()
    peak = np.abs(want).max()
    assert peak > min_peak
    assert np.abs(got - want).max() <= bound * peak


def _starts_per_voice(case) -> int:
    """The most notes that start on one voice in one block of ``case``'s
    first two blocks."""
    _, _, _, ps = _programs(case)
    n = BLOCKS[case]
    return max(int((ps.lower_block_inputs(b * n, n)["_trig_time"] < n)
                   .sum(axis=1).max()) for b in range(2))


@pytest.mark.parametrize("case", sorted(BLOCKS))
def test_render_matches_jax(case, monkeypatch):
    """Two blocks stepped in both packages; the cloud case clears a routing
    between them (a change of the lowered matrix, no rebuild).  The cloud
    and loop cases start two notes on a voice in block 0
    (``_starts_per_voice``), of which the JAX package renders the last
    only: the port renders with the JAX package's lowering
    (``one_trigger``)."""
    assert _starts_per_voice(case) == (1 if case == "sequential" else 2)
    one_trigger(monkeypatch, psampler.Sampler)
    jprog, js, prog, ps = _programs(case)
    n = BLOCKS[case]
    jstate, state = jprog.init_state(), prog.init_state()
    assert len(prog.pools) == 1 and prog.pools[0].smap.shape == (300,)
    for b in range(2):
        if b == 1 and case == "cloud":
            for s in (js, ps):
                s.clear_modulation("LFO1", "GPOS")
        jstate, want = jprog.step_packed(jstate, jprog.packed_block_inputs(b))
        state, got = prog.step(state, prog.block_inputs(b))
        _close(got.numpy(), np.asarray(want))


def test_state_carried_from_jax(monkeypatch):
    """JAX renders block 0; the port takes its state (the grain pools
    included) and both render block 1, the port with the JAX package's
    lowering (``one_trigger``: block 0 starts two notes on a voice)."""
    one_trigger(monkeypatch, psampler.Sampler)
    jprog, _, prog, _ = _programs("cloud")
    state1, _ = jprog.step_packed(jprog.init_state(), jprog.packed_block_inputs(0))
    _, want = jprog.step_packed(state1, jprog.packed_block_inputs(1))
    state = state_from_jax(jax.device_get(state1), prog)
    grains = state["pools"][0]["grains"]
    assert (grains["g_trig"] < pgran.NEVER).sum() > 10
    _, got = prog.step(state, prog.block_inputs(1))
    _close(got.numpy(), np.asarray(want))


def _mixed(pkg):
    """Two granular samplers beside two sampled ones whose pool keys match:
    the JAX package batches the sampled pair (one ``gen_batches`` entry)
    and renders each granular sampler alone."""
    main = pkg.Mixer("main")
    for i in range(2):
        s = pkg.Sampler(_tone(pkg), _options(pkg)(voices=2), name=f"g{i}")
        s.with_granular_playback(pkg.GranularConfig(
            size_ms=30.0 + 10 * i, density_hz=93.75, spray=0.2, pan_spread=0.5))
        s.note_on(60 + 7 * i, volume=0.6, time=100 * i)
        main.add_source(s)
        s = pkg.Sampler(_tone(pkg), _options(pkg)(voices=2), name=f"s{i}")
        nid = s.note_on(60 + 12 * i, volume=0.5, time=50 * i)
        s.note_off(nid, time=3000)
        main.add_source(s)
    return main


def test_granular_pools_alone_and_state_carried():
    """Each granular sampler is a pool of its own, the sampled pair one
    pool; a JAX state taken after block 0 (its batched pair and its lone
    granular nodes) renders block 1 as the JAX program does."""
    n = 4096
    jprog = jp.RenderProgram(_mixed(jp), jp.EngineConfig(block_frames=n))
    assert len(jprog.gen_batches) == 1
    prog = pt.RenderProgram(_mixed(pt), pt.EngineConfig(block_frames=n,
                                                        device="cpu"))
    assert sorted(len(p.paths) for p in prog.pools) == [1, 1, 2]
    assert [p.smap.shape[0] for p in prog.pools if p.proto.granular] == [200, 200]
    state1, _ = jprog.step_packed(jprog.init_state(), jprog.packed_block_inputs(0))
    _, want = jprog.step_packed(state1, jprog.packed_block_inputs(1))
    _, got = prog.step(state_from_jax(jax.device_get(state1), prog),
                       prog.block_inputs(1))
    _close(got.numpy(), np.asarray(want))


def test_lowering_matches_jax():
    """The granular sampler's block inputs, array by array; the read-speed
    tag of the JAX package is ``_smax`` here.  The port gives each note
    that starts on a voice a trigger slot (``_trig_*`` [V, K]); the JAX
    package's ``[V]`` arrays hold each voice's last trigger, which is the
    port's last used slot (a voice without one has its first, unused)."""
    jprog, js, prog, ps = _programs("loop")
    n = BLOCKS["loop"]
    most = 0
    for b in range(2):
        want = js.lower_block_inputs(b * n, n)
        got = ps.lower_block_inputs(b * n, n)
        assert float(got.pop("_smax")) == 2.0 ** (len(want.pop("_spd_tag")) - 1)
        assert sorted(got) == sorted(want)
        used = (got["_trig_time"] < n).sum(axis=1)
        most = max(most, int(used.max()))
        last = np.maximum(used - 1, 0)
        for k in want:
            g = np.asarray(got[k])
            if k.startswith("_trig_"):
                g = g[np.arange(len(last)), last]
            np.testing.assert_array_equal(g, np.asarray(want[k]), err_msg=k)
    assert most == 2


def test_granular1k_matches_bench_config():
    """``granular_program`` is bench.py's config 4; at 4096-frame blocks
    and a dyadic density (93.75 Hz in both) it renders as the JAX package
    does, to -90 dB of each block's peak."""
    jroot = bench.config_granular_1k().root
    main = pt.granular_graph()
    js, ps = jroot.sources[0], main.sources[0]
    assert dataclasses.asdict(ps.granular) == dataclasses.asdict(js.granular)
    assert ps.options.voices == js.options.voices
    assert [(e.time, e.note, e.volume) for e in ps.events] == [
        (e.time, e.note, e.volume) for e in js.events]
    for s in (js, ps):
        s.granular.density_hz = 93.75
    n = 4096
    want = jp.RenderProgram(jroot, jp.EngineConfig(block_frames=n)).render(
        2 * n, mode="loop")
    got = pt.RenderProgram(main, pt.EngineConfig(block_frames=n,
                                                 device="cpu")).render(2 * n)
    for b in range(2):
        sl = slice(b * n, (b + 1) * n)
        # one-second Hann grains fade in: the first blocks are quiet
        _close(got[:, sl], want[:, sl], min_peak=1e-3)


def test_granular_program_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; chip_smoke.py covers this path")
    with pytest.raises(RuntimeError, match="cuda"):
        pt.granular_program(block_frames=4096)

"""Lane-batched rendering (phonic_tpu_torch/parallel/mesh.py) against the
JAX package's ``BatchedRenderProgram`` and the port's own single program,
on the CPU at 1024-frame blocks and 3 lanes.

* Per lane against JAX, to -90 dB of each lane's peak: the one-source
  graph of tests/test_parallel.py, a reduced headline graph (4 sources,
  2 sub-mixers with EQ5 and chorus, master reverb and gain; the JAX
  package's lane-batched compile of it takes about 2 minutes), a graph
  with a sampler pool and a synth generator, a granular sampler and two
  sources through the sinc read.  The lanes start from JAX states taken
  after 0, 1 and 2 blocks (``batched_state_from_jax``), so they differ and
  a lane mix-up shows.
* Every lane against the port's single program, to 1e-6: the same
  graphs.
* One block makes the single program's source reads and recurrences, each
  over 3 times the rows.
* ``mixdown`` against the sum of the lanes (1e-4 of 3 x the single
  render); ``render_scan`` equals ``render`` bit for bit; a mesh of two
  CPU entries equals one device; auto-bypass and metering fold.
* ``GraphShardedProgram`` on one device is the program, bit for bit, and
  raises on two.
"""

import importlib

import jax
import numpy as np
import pytest
import torch

import phonic_tpu as jp
import phonic_tpu_torch as pt
from phonic_tpu.effects.chorus import ChorusEffect as JChorus
from phonic_tpu.effects.delay import DelayEffect as JDelay
from phonic_tpu.effects.eq5 import Eq5Effect as JEq5
from phonic_tpu.effects.gain import GainEffect as JGain
from phonic_tpu.effects.reverb import ReverbEffect as JReverb
from phonic_tpu.parallel.mesh import BatchedRenderProgram as JBatched
from phonic_tpu_torch.convert import batched_state_from_jax
from phonic_tpu_torch.effects.chorus import ChorusEffect
from phonic_tpu_torch.effects.delay import DelayEffect
from phonic_tpu_torch.effects.eq5 import Eq5Effect
from phonic_tpu_torch.effects.gain import GainEffect
from phonic_tpu_torch.effects.reverb import ReverbEffect
from phonic_tpu_torch.ops import rampread, scan
from phonic_tpu_torch.parallel.mesh import (BatchedRenderProgram,
                                            GraphShardedProgram, data_mesh,
                                            graph_state_shardings)

SR = 48000
BLOCK = 1024
LANES = 3
DB90 = 10.0 ** (-90.0 / 20.0)


def _effects(pkg):
    if pkg is jp:
        return JEq5, JChorus, JReverb, JGain, JDelay
    return Eq5Effect, ChorusEffect, ReverbEffect, GainEffect, DelayEffect


def one_source(pkg):
    """tests/test_parallel.py's graph: one endless 220 Hz tone."""
    t = np.arange(SR // 2) / SR
    buf = pkg.AudioFileBuffer.from_array(
        (0.4 * np.sin(2 * np.pi * 220 * t)).astype(np.float32)[None, :], SR)
    m = pkg.Mixer("main")
    m.add_source(pkg.FileSource(buf, pkg.FilePlaybackOptions(
        repeat=None, fade_out_secs=0.0), name="src"))
    return m


def headline(pkg, sources=4, subs=2):
    """The headline graph cut to ``sources`` sources in ``subs``
    sub-mixers (headline.py's draws)."""
    Eq5, Chorus, Reverb, Gain, _ = _effects(pkg)
    rng = np.random.default_rng(0)
    main = pkg.Mixer("main")
    mixers = [main.add_mixer(pkg.Mixer(f"sub{i}")) for i in range(subs)]
    for i in range(sources):
        t = np.arange(12000 + 977 * i) / SR
        x = 0.5 * np.sin(2 * np.pi * float(rng.uniform(80, 660)) * t) \
            * np.exp(-2.0 * t)
        buf = pkg.AudioFileBuffer.from_array(x.astype(np.float32)[None], SR)
        mixers[i % subs].add_source(pkg.FileSource(buf, pkg.FilePlaybackOptions(
            volume=float(rng.uniform(0.2, 0.6)),
            panning=float(rng.uniform(-0.8, 0.8)),
            speed=float(rng.uniform(0.5, 2.0)), repeat=None), name=f"src{i}"))
    for s in mixers:
        s.add_effect(Eq5(gains=list(rng.uniform(-6, 6, 5)), name="eq"))
        s.add_effect(Chorus(rate=float(rng.uniform(0.3, 2.0)), name="chorus"))
    main.add_effect(Reverb(room_size=0.6, wet=0.2, min_room_size=0.55,
                           name="reverb"))
    main.add_effect(Gain(gain=0.8, name="gain"))
    return main


def pools(pkg=pt):
    """Two samplers in one pool, a synth generator, a file source and a
    delay on the master.  The synth is sub3 without detune: at a 65536 Hz
    engine rate its phase increments are dyadic, so the packages' phase
    sums agree (tests/test_torch_synth.py)."""
    *_, Gain, Delay = _effects(pkg)
    synths = importlib.import_module(pkg.__name__ + ".synths")
    t = np.arange(5000) / SR
    sbuf = pkg.AudioFileBuffer.from_array(
        (0.4 * np.sin(2 * np.pi * 330.0 * t)).astype(np.float32)[None], SR)
    main = pkg.Mixer("main")
    sub = main.add_mixer(pkg.Mixer("sub"))
    for k in range(2):
        smp = pkg.Sampler(sbuf, pkg.GeneratorPlaybackOptions(voices=4),
                          name=f"smp{k}")
        nid = smp.note_on(60 + 5 * k, volume=0.5, time=100 * k)
        smp.note_off(nid, time=2 * BLOCK + 300)
        sub.add_source(smp)
    gen = pkg.SynthGenerator(synths.sub3(detune_cents=0.0),
                             pkg.GeneratorPlaybackOptions(voices=3), name="gen")
    gen.note_off(gen.note_on(57, 0.7, time=200), time=3 * BLOCK)
    main.add_source(gen)
    main.add_source(pkg.FileSource(sbuf, pkg.FilePlaybackOptions(
        repeat=None, fade_out_secs=0.0, volume=0.3), name="file"))
    sub.add_effect(Gain(gain=0.9, name="gain"))
    main.add_effect(Delay(delay_ms=7.0, feedback=0.3, wet=0.2, name="delay"))
    return main


def granular(pkg=pt):
    t = np.arange(8192) / SR
    buf = pkg.AudioFileBuffer.from_array(
        (0.5 * np.sin(2 * np.pi * 187.5 * t)).astype(np.float32)[None], SR)
    smp = pkg.Sampler(buf, name="gran").with_granular_playback(
        pkg.GranularConfig(size_ms=30.0, density_hz=93.75, spray=0.1,
                           pan_spread=0.5))
    smp.note_on(60, volume=0.8, time=0)
    main = pkg.Mixer("main")
    main.add_source(smp)
    return main


def high_quality(pkg=pt):
    """Two sources through the polyphase sinc read, at a 44.1 kHz buffer
    rate."""
    t = np.arange(20000) / 44100
    buf = pkg.AudioFileBuffer.from_array(
        (0.5 * np.sin(2 * np.pi * 300 * t)).astype(np.float32)[None], 44100)
    main = pkg.Mixer("main")
    for k, speed in enumerate((1.3, 0.7)):
        main.add_source(pkg.FileSource(buf, pkg.FilePlaybackOptions(
            resampling_quality="high", speed=speed), name=f"src{k}"))
    return main


def _program(graph, pkg=pt, sample_rate=SR, **config):
    if pkg is jp:
        return jp.RenderProgram(graph(jp), jp.EngineConfig(
            sample_rate=sample_rate, block_frames=BLOCK))
    return pt.RenderProgram(graph(pt), pt.EngineConfig(
        sample_rate=sample_rate, block_frames=BLOCK, device="cpu", **config))


def _close_db(got, want, bound):
    assert got.shape == want.shape and np.isfinite(got).all()
    peak = np.abs(want).max()
    assert peak > 0.05
    err = np.abs(got - want).max()
    assert err <= bound * peak, f"{20 * np.log10(err / peak):.1f} dB"


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("graph,rate", [
    (one_source, SR), (headline, SR), (pools, 65536), (granular, SR),
    (high_quality, SR)],
    ids=["one_source", "headline", "pools", "granular", "high_quality"])
def test_lanes_match_jax(graph, rate):
    jb = JBatched(_program(graph, jp, rate), lanes=LANES)
    # lane k starts from the state after k blocks: the batched state after
    # 0, 1 and 2 blocks, lane 0 of each, stacked
    st = jb.init_states()
    taken = [st]
    for b in range(LANES - 1):
        st, _ = jb.step(st, jb.block_inputs(b))
        taken.append(st)
    start = jax.tree.map(lambda *xs: np.stack([np.asarray(x)[0] for x in xs]),
                         *taken)
    want, st = [], start
    for b in range(LANES - 1, LANES + 1):
        st, y = jb.step(st, jb.block_inputs(b))
        want.append(np.asarray(y))
    want = np.concatenate(want, axis=-1)

    pb = BatchedRenderProgram(_program(graph, pt, rate), lanes=LANES)
    states = batched_state_from_jax(start, pb)
    got = []
    for b in range(LANES - 1, LANES + 1):
        states, y = pb.step(states, pb.block_inputs(b))
        got.append(y.numpy())
    got = np.concatenate(got, axis=-1)
    assert got.shape == (LANES, 2, 2 * BLOCK)
    for lane in range(LANES):
        _close_db(got[lane], want[lane], DB90)
    # the lanes differ: a mix-up of lanes would show
    assert np.abs(want[0] - want[LANES - 1]).max() > 0.05


def test_batched_state_needs_equal_smoothers():
    jb = JBatched(_program(one_source, jp), lanes=2)
    st = jax.device_get(jb.init_states())
    key = next(iter(st["smoothers"]))
    st["smoothers"][key] = jax.tree.map(lambda a: a + np.arange(2).reshape(
        (2,) + (1,) * (a.ndim - 1)).astype(a.dtype), st["smoothers"][key])
    with pytest.raises(ValueError, match="smoother"):
        batched_state_from_jax(st, BatchedRenderProgram(_program(one_source),
                                                        lanes=2))


# ---------------------------------------------------------------------------
# against the port's single program
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("graph", [one_source, headline, pools, granular,
                                   high_quality],
                         ids=["one_source", "headline", "pools", "granular",
                              "high_quality"])
def test_lanes_match_single_program(graph):
    frames = 3 * BLOCK + 200
    single = _program(graph).render(frames)
    got = BatchedRenderProgram(_program(graph), lanes=LANES).render(frames)
    assert got.shape == (LANES,) + single.shape
    assert np.abs(single).max() > 0.05
    for lane in range(LANES):
        np.testing.assert_allclose(got[lane], single, rtol=0, atol=1e-6)


def _counting(monkeypatch):
    calls = {"ramp_read": [], "iir2": [], "iir1": []}

    def spy(name, module, attr, rows):
        fn = getattr(module, attr)

        def wrapped(*args):
            calls[name].append(rows(args))
            return fn(*args)
        monkeypatch.setattr(module, attr, wrapped)

    spy("ramp_read", rampread, "ramp_read", lambda a: a[2].shape[0])
    # the CPU counterparts of the iir2 and iir1 kernels' launches
    spy("iir2", scan, "chunked_second", lambda a: a[4][..., 0].numel())
    spy("iir1", scan, "chunked_first", lambda a: a[1][..., 0].numel())
    return calls


def test_one_block_makes_one_lanes_launches(monkeypatch):
    """A block of 3 lanes calls each kernel's wrapper as often as a block
    of one lane, each call over 3 times the rows."""
    calls = _counting(monkeypatch)
    prog = _program(headline)
    prog.step(prog.init_state(), prog.block_inputs(0))
    one = {k: list(v) for k, v in calls.items()}
    for v in calls.values():
        v.clear()
    pb = BatchedRenderProgram(_program(headline), lanes=LANES)
    pb.step(pb.init_states(), pb.block_inputs(0))
    assert len(one["ramp_read"]) == 1 and len(one["iir2"]) > 1
    for k in calls:
        assert calls[k] == [LANES * r for r in one[k]], k


def test_mixdown_sums_the_lanes():
    single = _program(one_source).render(BLOCK)
    pb = BatchedRenderProgram(_program(one_source), lanes=LANES, mixdown=True)
    _, audio = pb.step(pb.init_states(), pb.block_inputs(0))
    assert audio.shape == (1, 2, BLOCK)
    np.testing.assert_allclose(audio[0].numpy(), LANES * single, rtol=0,
                               atol=1e-4)


def test_render_scan_equals_render():
    frames = 4 * BLOCK - 24
    a_loop = BatchedRenderProgram(_program(headline), lanes=LANES).render(frames)
    pb = BatchedRenderProgram(_program(headline), lanes=LANES)
    a_scan = pb.render_scan(frames)
    np.testing.assert_array_equal(a_scan, a_loop)
    # stacked inputs are block_inputs, block by block
    stacked = pb.stacked_inputs(2, start_block=1)
    prog = pb.program
    for i in range(2):
        a, b = prog.block_of(stacked, i), prog.block_inputs(1 + i)
        assert a["frame0"] == b["frame0"] and a["stops"] == b["stops"]
        for k in b["params"]:
            for x, y in zip(a["params"][k], b["params"][k]):
                np.testing.assert_array_equal(x, y)


def test_two_device_mesh_equals_one():
    frames = 2 * BLOCK + 100
    mesh = data_mesh(2, device="cpu")
    assert mesh == [torch.device("cpu")] * 2
    one = BatchedRenderProgram(_program(headline), lanes=4).render(frames)
    pb = BatchedRenderProgram(_program(headline), lanes=4, mesh=mesh)
    assert [s.lanes for s in pb.shards] == [2, 2]
    np.testing.assert_array_equal(pb.render(frames), one)
    mix = BatchedRenderProgram(_program(headline), lanes=4, mesh=mesh,
                               mixdown=True)
    _, audio = mix.step(mix.init_states(), mix.block_inputs(0))
    np.testing.assert_allclose(audio[0].numpy(), one[..., :BLOCK].sum(0),
                               rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="evenly"):
        BatchedRenderProgram(_program(headline), lanes=3, mesh=mesh)


def test_bypass_and_metering_fold():
    """Auto-bypass ages and mixer levels of a folded program equal the
    single program's, lane by lane."""
    cfg = dict(auto_bypass=True, meter_mixers=True)
    prog = _program(headline, **cfg)
    pb = BatchedRenderProgram(_program(headline, **cfg), lanes=LANES)
    st, states = prog.init_state(), pb.init_states()
    for b in range(3):
        st, (y, levels) = prog.step(st, prog.block_inputs(b))
        states, (ys, lv) = pb.shards[0].step(states[0], pb.block_inputs(b))
        states = [states]
        for lane in range(LANES):
            np.testing.assert_allclose(ys[lane].numpy(), y.numpy(), atol=1e-6)
            for p, (peak, rms) in levels.items():
                np.testing.assert_allclose(lv[p][0][lane].numpy(),
                                           peak.numpy(), atol=1e-6)
                np.testing.assert_allclose(lv[p][1][lane].numpy(),
                                           rms.numpy(), atol=1e-6)
    for a, b in zip(st["bypass"], states[0]["bypass"]):
        assert torch.equal(b, a.repeat(1, LANES))


def test_graph_sharded_program():
    prog = _program(headline)
    sharded = GraphShardedProgram(prog, ["cpu"])
    st, outs = sharded.init_state(), []
    for b in range(3):
        st, y = sharded.step(st, sharded.block_inputs(b))
        outs.append(y.numpy())
    np.testing.assert_array_equal(np.concatenate(outs, axis=-1),
                                  _program(headline).render(3 * BLOCK))
    devices = graph_state_shardings(prog, ["cpu"])
    assert devices["file_batches"][0]["base"] == torch.device("cpu")
    with pytest.raises(NotImplementedError):
        GraphShardedProgram(prog, ["cpu", "cpu"])


def test_folded_program_refuses_adopt():
    prog = pt.RenderProgram(one_source(pt), pt.EngineConfig(
        block_frames=BLOCK, device="cpu"), lanes=2)
    with pytest.raises(NotImplementedError):
        prog.adopt(prog, prog.init_state())

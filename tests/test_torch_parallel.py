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
* ``GraphShardedProgram`` on one device and split over two is the
  program, bit for bit (tests/test_torch_graph_sharded.py holds the
  split).
* Lanes whose blocks start at different frames (lane k at block ``b +
  k``) against the JAX package's lanes over the same inputs, to -90 dB.
* Per-lane inputs (lanes that differ in automation, notes, stops and
  seeks; ``LANE_SCHEDULES``): each lane against the JAX package's lanes
  stepped by its ``BatchedRenderProgram`` over the stacked per-lane inputs
  (its vmap over ``[lanes, ...]`` inputs), to -90 dB of each lane's peak,
  also on a two-entry mesh and with ``mixdown``; each lane against its
  own single program, to 1e-6, also across shared -> per-lane -> shared
  blocks; one per-lane block makes one lane's launches; lanes with
  different pool step bounds; the lanes asserted to differ; the
  ``ValueError`` of lanes that do not fold (a lane at another
  ``frame0`` folds).  The JAX lanes use notes in
  one step bucket (its sampler step bound is a shape) and no per-note
  automation (its knot arrays' shapes follow the knot count), so that
  their inputs stack.
* The JAX package renders with the standard polyBLEP residual, the port's
  (``jax_polyblep.py``; the synth generator's sub3 takes one).
"""

import functools
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
from phonic_tpu_torch.io import wav as pwav
from phonic_tpu_torch.ops import rampread, scan
from phonic_tpu_torch.parallel.mesh import (BatchedRenderProgram,
                                            GraphShardedProgram, data_mesh,
                                            graph_state_shardings)
from jax_polyblep import standard_polyblep

SR = 48000
BLOCK = 1024
LANES = 3
DB90 = 10.0 ** (-90.0 / 20.0)


@pytest.fixture(scope="module", autouse=True)
def _standard_polyblep():
    """Every JAX program of the module traces the standard residual."""
    with standard_polyblep():
        yield


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


def pools(pkg=pt, lane=0):
    """Two samplers in one pool, a synth generator, a file source and a
    delay on the master.  The synth is sub3 without detune: at a 65536 Hz
    engine rate its phase increments are dyadic, so the packages' phase
    sums agree (tests/test_torch_synth.py).  ``lane`` > 0 moves the notes:
    an octave down, or later."""
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
        nid = smp.note_on(60 + 5 * k - 12 * (lane % 2), volume=0.5 - 0.1 * lane,
                          time=100 * k + 700 * (lane // 2))
        smp.note_off(nid, time=2 * BLOCK + 300 - 200 * lane)
        sub.add_source(smp)
    gen = pkg.SynthGenerator(synths.sub3(detune_cents=0.0),
                             pkg.GeneratorPlaybackOptions(voices=3), name="gen")
    gen.note_off(gen.note_on((57, 45, 69, 81)[lane], 0.7, time=200 + 100 * lane),
                 time=3 * BLOCK)
    main.add_source(gen)
    main.add_source(pkg.FileSource(sbuf, pkg.FilePlaybackOptions(
        repeat=None, fade_out_secs=0.0, volume=0.3), name="file"))
    sub.add_effect(Gain(gain=0.9, name="gain"))
    main.add_effect(Delay(delay_ms=7.0, feedback=0.3, wet=0.2, name="delay"))
    return main


def granular(pkg=pt, lane=0):
    """A granular sampler; ``lane`` > 0 plays a note a tone higher per lane
    (one step bucket), later and softer."""
    t = np.arange(8192) / SR
    buf = pkg.AudioFileBuffer.from_array(
        (0.5 * np.sin(2 * np.pi * 187.5 * t)).astype(np.float32)[None], SR)
    smp = pkg.Sampler(buf, name="gran").with_granular_playback(
        pkg.GranularConfig(size_ms=30.0, density_hz=93.75, spray=0.1,
                           pan_spread=0.5))
    smp.note_on(60 + 2 * lane, volume=0.8 - 0.2 * lane, time=300 * lane)
    main = pkg.Mixer("main")
    main.add_source(smp)
    return main


def synth(pkg=pt, lane=0):
    """A synth generator alone (sub3 without detune, dyadic at 65536 Hz),
    each lane its own notes: lane 1 later and louder, lane 2 a second note
    an octave higher."""
    synths = importlib.import_module(pkg.__name__ + ".synths")
    gen = pkg.SynthGenerator(synths.sub3(detune_cents=0.0),
                             pkg.GeneratorPlaybackOptions(voices=2), name="gen")
    late = 100 * (lane == 1)
    a = gen.note_on(57, 0.6 + 0.2 * (lane == 1), time=late)
    gen.note_on(81 if lane == 2 else 69, 0.4, time=BLOCK + late // 2)
    gen.note_off(a, time=2 * BLOCK - late)
    main = pkg.Mixer("main")
    main.add_source(gen)
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
    """On one device and split over two, the headline equals the program
    bit for bit (tests/test_torch_graph_sharded.py covers the split)."""
    prog = _program(headline)
    want = _program(headline).render(3 * BLOCK)
    for mesh in (["cpu"], ["cpu", "cpu"]):
        sharded = GraphShardedProgram(prog, mesh)
        st, outs = sharded.init_state(), []
        for b in range(3):
            st, y = sharded.step(st, sharded.block_inputs(b))
            outs.append(y.numpy())
        np.testing.assert_array_equal(np.concatenate(outs, axis=-1), want)
    devices = graph_state_shardings(prog, ["cpu"])
    assert devices["file_batches"][0]["base"] == torch.device("cpu")
    split = graph_state_shardings(prog, ["cpu", "cpu"])
    assert [d["base"] for d in split["file_batches"][0]] == \
        [torch.device("cpu")] * 2


def test_folded_program_refuses_adopt():
    prog = pt.RenderProgram(one_source(pt), pt.EngineConfig(
        block_frames=BLOCK, device="cpu"), lanes=2)
    with pytest.raises(NotImplementedError):
        prog.adopt(prog, prog.init_state())


# ---------------------------------------------------------------------------
# per-lane inputs
# ---------------------------------------------------------------------------

def _volume(prog, path, value, at):
    prog.set_parameter(path, "VOLU", value, at_frame=at)


def _sched_one_source(prog, k):
    _volume(prog, "main/src", 0.3 + 0.2 * k, 50 + 100 * k)
    if k == 1:
        prog.nodes["main/src"].seek(BLOCK + 10, 3000.0)
    if k == 2:
        prog.stop_source("main/src", at_frame=BLOCK + 300)


def _sched_headline(prog, k):
    """Every lane its own master gain and a volume event on a source of its
    own; lane 1 glides a speed (within its step bucket) and seeks, lane 2
    stops a source and changes an EQ band and the chorus depth."""
    srcs = prog.source_paths
    prog.set_parameter("main/gain", "GAIN", 0.5 + 0.15 * k, at_frame=200 * k)
    _volume(prog, srcs[k % len(srcs)], 0.1 + 0.2 * k, 300 + 10 * k)
    if k == 1:
        speed = prog.nodes[srcs[3]].options.speed
        top = 2.0 ** np.ceil(np.log2(speed))  # the top of its step bucket
        prog.set_parameter_glide(srcs[3], "SPED", min(speed * 1.1, top), 12.0,
                                 at_frame=400)
        prog.nodes[srcs[0]].seek(BLOCK + 20, 5000.0)
    if k == 2:
        prog.stop_source(srcs[2], at_frame=BLOCK + 500)
        prog.set_parameter("main/sub0/eq", "gan2", 9.0, at_frame=100)
        prog.set_parameter("main/sub1/chorus", "dpth", 0.9, at_frame=100)


def _sched_pools(prog, k):
    _volume(prog, "main/file", 0.2 + 0.2 * k, 100 * k)
    prog.set_parameter("main/delay", "fdbk", 0.2 + 0.2 * k, at_frame=50 * k)


def _sched_sampler_volume(prog, k):
    prog.set_parameter(prog.source_paths[0], "SVOL", 1.0 - 0.25 * k,
                       at_frame=BLOCK // 2 + 64 * k)


def _sched_high_quality(prog, k):
    _volume(prog, "main/src0", 0.4 + 0.2 * k, 30 * k)
    if k == 1:
        prog.nodes["main/src1"].seek(BLOCK + 5, 700.0)
    if k == 2:
        prog.stop_source("main/src1", at_frame=BLOCK + 200)


# graph -> each lane's schedule on its program (the notes are the graph's)
LANE_SCHEDULES = {one_source: _sched_one_source, headline: _sched_headline,
                  pools: _sched_pools, granular: _sched_sampler_volume,
                  synth: _sched_sampler_volume,
                  high_quality: _sched_high_quality}
DIVERGENT = [(one_source, SR), (headline, SR), (pools, 65536),
             (granular, SR), (synth, 65536), (high_quality, SR)]
DIVERGENT_IDS = ["one_source", "headline", "pools", "granular", "synth",
                 "high_quality"]


def _lane_graph(graph, k):
    if "lane" in graph.__code__.co_varnames:
        return functools.partial(graph, lane=k)
    return graph


def _lane_programs(graph, pkg, rate, lanes):
    """One program per lane, lane k's graph and schedule."""
    progs = []
    for k in range(lanes):
        prog = _program(_lane_graph(graph, k), pkg, rate)
        LANE_SCHEDULES[graph](prog, k)
        progs.append(prog)
    return progs


@functools.lru_cache(maxsize=None)
def _jax_batched(graph, rate, lanes):
    """The JAX package's BatchedRenderProgram of a graph, kept so that its
    step compiles once for the module: the JAX headline's compile takes
    most of a minute."""
    return JBatched(_program(graph, jp, rate), lanes=lanes)


@functools.lru_cache(maxsize=None)
def _jax_lanes(graph, rate, blocks, lanes=LANES, offsets=None):
    """The JAX package's lanes from its init state through ``blocks``
    blocks of per-lane inputs: its BatchedRenderProgram's step over the
    lane programs' inputs, packed as its step packs them and stacked
    [lanes, ...]; with ``offsets``, lane k's inputs are its program's block
    ``b + offsets[k]`` (JAX traces ``frame0``).  Returns the init state,
    the state after each block and the audio [lanes, ch, blocks * BLOCK].
    Kept for the module's other tests."""
    jb = _jax_batched(graph, rate, lanes)
    progs = _lane_programs(graph, jp, rate, lanes)
    offsets = offsets or (0,) * lanes
    pack = jb._step_program.pack_inputs
    st = jb.init_states()
    states, outs = [jax.device_get(st)], []
    for b in range(blocks):
        packed = [pack(p.block_inputs(b + o)) for p, o in zip(progs, offsets)]
        st, y = jb.step(st, jax.tree.map(lambda *xs: np.stack(xs), *packed))
        states.append(jax.device_get(st))
        outs.append(np.asarray(y))
    return states, np.concatenate(outs, axis=-1)


def _port_lanes(pb, graph, rate, blocks, states, lanes=LANES, first=0):
    progs = _lane_programs(graph, pt, rate, lanes)
    for b in range(first):
        for p in progs:  # lowered and dropped: the lanes start at ``first``
            p.block_inputs(b)
    outs = []
    for b in range(first, first + blocks):
        states, y = pb.step(states, [p.block_inputs(b) for p in progs])
        outs.append(y.numpy())
    return states, np.concatenate(outs, axis=-1)


def _assert_lanes_differ(audio):
    assert max(np.abs(audio[0] - audio[k]).max()
               for k in range(1, len(audio))) > 0.05


@pytest.mark.parametrize("graph,rate,case", [
    *[(g, r, "") for g, r in DIVERGENT], (one_source, SR, "mesh"),
    (headline, SR, "mixdown")],
    ids=DIVERGENT_IDS + ["mesh", "mixdown"])
def test_divergent_lanes_match_jax(graph, rate, case):
    """Per-lane inputs: each lane against the JAX package's lanes stepped
    over the same per-lane inputs from the same state."""
    lanes = 4 if case == "mesh" else LANES
    jstates, want = _jax_lanes(graph, rate, 3, lanes)
    _assert_lanes_differ(want)
    pb = BatchedRenderProgram(
        _program(graph, pt, rate), lanes=lanes,
        mesh=["cpu", "cpu"] if case == "mesh" else None,
        mixdown=case == "mixdown")
    _, got = _port_lanes(pb, graph, rate, 3,
                         batched_state_from_jax(jstates[0], pb), lanes)
    if case == "mixdown":
        assert got.shape == (1, 2, 3 * BLOCK)
        _close_db(got[0], want.sum(0), DB90)
        return
    assert got.shape == (lanes, 2, 3 * BLOCK)
    for lane in range(lanes):
        _close_db(got[lane], want[lane], DB90)


@pytest.mark.parametrize("graph,rate", [(headline, SR), (pools, 65536),
                                        (granular, SR)],
                         ids=["headline", "pools", "granular"])
def test_lanes_at_different_frames_match_jax(graph, rate):
    """Lanes whose blocks start at different frames (lane k fed its own
    program's block ``b + k``) against the JAX package's lanes over the
    same per-lane inputs, from the same state."""
    offsets = tuple(range(LANES))
    jstates, want = _jax_lanes(graph, rate, 3, LANES, offsets)
    pb = BatchedRenderProgram(_program(graph, pt, rate), lanes=LANES)
    progs = _lane_programs(graph, pt, rate, LANES)
    states, outs = batched_state_from_jax(jstates[0], pb), []
    for b in range(3):
        states, y = pb.step(states, [p.block_inputs(b + o)
                                     for p, o in zip(progs, offsets)])
        outs.append(y.numpy())
    got = np.concatenate(outs, axis=-1)
    assert got.shape == (LANES, 2, 3 * BLOCK)
    for lane in range(LANES):
        _close_db(got[lane], want[lane], DB90)


def test_batched_state_with_unequal_smoothers():
    """JAX lanes whose smoother states differ (after a per-lane block)
    convert into per-lane smoother rows and step on as JAX's lanes do."""
    jstates, want = _jax_lanes(headline, SR, 3, LANES)
    pb = BatchedRenderProgram(_program(headline), lanes=LANES)
    states = batched_state_from_jax(jstates[1], pb)
    sizes = {k: len(v) for k, v in pb.program._param_groups.items()}
    widths = {k: torch.as_tensor(v if isinstance(v, torch.Tensor) else v[0])
              .shape[0] for k, v in states[0]["smoothers"].items()}
    assert any(widths[k] == LANES * sizes[k] for k in sizes)
    _, got = _port_lanes(pb, headline, SR, 2, states, first=1)
    for lane in range(LANES):
        _close_db(got[lane], want[lane, :, BLOCK:], DB90)


@pytest.mark.parametrize("graph,rate", DIVERGENT, ids=DIVERGENT_IDS)
def test_divergent_lanes_match_single_programs(graph, rate):
    """Each lane equals its own single program with that lane's schedule."""
    frames = 3 * BLOCK
    pb = BatchedRenderProgram(_program(graph, pt, rate), lanes=LANES)
    _, got = _port_lanes(pb, graph, rate, 3, pb.init_states())
    _assert_lanes_differ(got)
    for lane, prog in enumerate(_lane_programs(graph, pt, rate, LANES)):
        np.testing.assert_allclose(got[lane], prog.render(frames), rtol=0,
                                   atol=1e-6, err_msg=f"lane {lane}")


def test_shared_divergent_shared_blocks():
    """Shared, per-lane, then shared blocks: the smoothers widen to per-lane
    rows at the per-lane block and keep them, and every lane equals a
    single program given the same inputs block by block."""
    lanes = _lane_programs(headline, pt, SR, LANES)
    pb = BatchedRenderProgram(_program(headline), lanes=LANES)
    singles = [_program(headline) for _ in range(LANES)]
    sts = [s.init_state() for s in singles]
    states, outs, want = pb.init_states(), [], []
    for b in range(4):
        per_lane = b == 1
        inputs = ([p.block_inputs(b) for p in lanes] if per_lane
                  else pb.block_inputs(b))
        states, y = pb.step(states, inputs)
        outs.append(y.numpy())
        ys = []
        for k, single in enumerate(singles):
            sts[k], yk = single.step(sts[k], inputs[k] if per_lane else inputs)
            ys.append(yk.numpy())
        want.append(np.stack(ys))
        widths = {tree_width(v) for v in states[0]["smoothers"].values()}
        sizes = {len(v) for v in pb.program._param_groups.values()}
        assert (widths == {LANES * n for n in sizes}) == (b >= 1), b
    got, want = np.concatenate(outs, -1), np.concatenate(want, -1)
    _assert_lanes_differ(got)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def tree_width(st):
    return (st if isinstance(st, torch.Tensor) else st[0]).shape[0]


def test_divergent_block_makes_one_lanes_launches(monkeypatch):
    """A per-lane block calls each kernel's wrapper as often as a block of
    one lane, each call over 3 times the rows."""
    calls = _counting(monkeypatch)
    prog = _program(headline)
    prog.step(prog.init_state(), prog.block_inputs(0))
    one = {k: list(v) for k, v in calls.items()}
    for v in calls.values():
        v.clear()
    pb = BatchedRenderProgram(_program(headline), lanes=LANES)
    progs = _lane_programs(headline, pt, SR, LANES)
    pb.step(pb.init_states(), [p.block_inputs(0) for p in progs])
    assert len(one["ramp_read"]) == 1 and len(one["iir2"]) > 1
    for k in calls:
        assert calls[k] == [LANES * r for r in one[k]], k


def test_pool_step_bound_is_the_lanes_largest():
    """Lanes whose sampler notes sit in different step buckets: the pool
    clamps to the largest lane's bound, which binds no lane, so each lane
    equals its own program."""
    progs = [_program(functools.partial(pools, lane=k), pt, 65536)
             for k in range(LANES)]
    progs[2].nodes["main/sub/smp0"].note_on(96, volume=0.3, time=BLOCK)
    inputs = [p.block_inputs(0) for p in progs]
    smax = [float(i["extra"]["main/sub/smp0"]["_smax"]) for i in inputs]
    assert smax[2] > smax[0] == smax[1]
    pb = BatchedRenderProgram(_program(pools, pt, 65536), lanes=LANES)
    states, y0 = pb.step(pb.init_states(), inputs)
    _, y1 = pb.step(states, [p.block_inputs(1) for p in progs])
    got = np.concatenate([y0.numpy(), y1.numpy()], -1)
    for k in range(LANES):
        single = _program(functools.partial(pools, lane=k), pt, 65536)
        if k == 2:
            single.nodes["main/sub/smp0"].note_on(96, volume=0.3, time=BLOCK)
        np.testing.assert_allclose(got[k], single.render(2 * BLOCK), rtol=0,
                                   atol=1e-6, err_msg=f"lane {k}")


def _leaf_banks(path, lane):
    """Two streamed sources (one bank), two dx7 synth sources (one bank)
    and an empty source, each lane its own schedule: lane 1 changes a
    streamed source's speed, lane 2 seeks one and stops a synth, every
    lane moves a synth's volume."""
    synths = importlib.import_module("phonic_tpu_torch.synths")
    main = pt.Mixer("main")
    for k, start in enumerate((0, 300)):
        s = pt.StreamedFileSource(path, pt.FilePlaybackOptions(
            volume=0.5, start_time=start), name=f"stream{k}")
        if lane == 2 and k == 0:
            s.seek(BLOCK + 30, 4000.0)
        main.add_source(s)
    voice = synths.dx7()
    for k, freq in enumerate((220.0, 330.0)):
        main.add_source(pt.SynthSource(voice, pt.SynthPlaybackOptions(
            frequency=freq, volume=0.3, duration=2 * BLOCK), name=f"syn{k}"))
    main.add_source(pt.EmptySource(name="empty"))
    prog = pt.RenderProgram(main, pt.EngineConfig(
        sample_rate=SR, block_frames=BLOCK, device="cpu"))
    prog.set_parameter("main/syn1", "VOLU", 0.1 + 0.2 * lane,
                       at_frame=200 + 50 * lane)
    if lane == 1:
        prog.set_parameter("main/stream1", "SPED", 1.5, at_frame=BLOCK // 2)
    if lane == 2:
        prog.stop_source("main/syn0", at_frame=BLOCK + 400)
    return prog


def test_divergent_leaf_banks_match_single_programs(tmp_path):
    """Streamed, synth and empty banks with per-lane inputs: each lane's
    host windows come from its own program's nodes, and each lane equals
    its own single program."""
    t = np.arange(20000) / SR
    path = str(tmp_path / "tone.wav")
    pwav.write_wav(path, (0.4 * np.sin(2 * np.pi * 250.0 * t) * np.exp(-t))
                   .astype(np.float32)[None], SR, bits=32, float_format=True)
    lanes = [_leaf_banks(path, k) for k in range(LANES)]
    pb = BatchedRenderProgram(_leaf_banks(path, 0), lanes=LANES)
    states, outs = pb.init_states(), []
    for b in range(3):
        states, y = pb.step(states, [p.block_inputs(b) for p in lanes])
        outs.append(y.numpy())
    got = np.concatenate(outs, -1)
    _assert_lanes_differ(got)
    for k in range(LANES):
        np.testing.assert_allclose(got[k], _leaf_banks(path, k).render(
            3 * BLOCK), rtol=0, atol=1e-6, err_msg=f"lane {k}")


def _structure_errors():
    def other_frame0(ins):  # folds: lanes may start at different frames
        ins[1] = dict(ins[1], frame0=ins[1]["frame0"] + BLOCK)

    def other_graph(ins):
        ins[2] = _program(one_source).block_inputs(0)

    def one_too_many(ins):
        ins.append(ins[0])
    return {"frame0": (other_frame0, None), "structure":
            (other_graph, "parameter groups|rows|source paths"),
            "lane_count": (one_too_many, "lanes of inputs")}


@pytest.mark.parametrize("case", sorted(_structure_errors()))
def test_lanes_that_do_not_fold_raise(case):
    """Lanes of another structure or count raise ``ValueError``; a lane
    whose block starts at another frame folds (the ``frame0`` case): its
    audio is the block rendered from that frame."""
    change, match = _structure_errors()[case]
    pb = BatchedRenderProgram(_program(headline), lanes=LANES)
    inputs = [p.block_inputs(0)
              for p in _lane_programs(headline, pt, SR, LANES)]
    change(inputs)
    if match is not None:
        with pytest.raises(ValueError, match=match):
            pb.step(pb.init_states(), inputs)
        return
    _, y = pb.step(pb.init_states(), inputs)
    single = _program(headline)
    LANE_SCHEDULES[headline](single, 1)
    _, want = single.step(single.init_state(), inputs[1])
    assert inputs[1]["frame0"] == BLOCK
    np.testing.assert_array_equal(y[1].numpy(), want.numpy())

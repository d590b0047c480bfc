"""One graph's banks split over a mesh (``GraphShardedProgram``,
phonic_tpu_torch/parallel/mesh.py), lanes whose blocks start at different
frames, and the synth generator's note pairs against the JAX package, on
the CPU at 1024-frame blocks.

* Split over ``["cpu"] * k`` (k = 2, 4), the counterparts of the JAX
  package's ``make_wide_prog`` (8 file sources, 4 sub-mixers with a gain)
  and ``make_full_family_prog`` (file banks, a sampler pool, a delay on the
  master; tests/test_parallel.py) and the reduced headline graph equal the
  unsharded program bit for bit, audio and state, with auto-bypass and
  metering too.  Against the JAX package's ``GraphShardedProgram`` on its
  4-device CPU mesh: the wide graph bit for bit, as JAX's own test holds
  JAX; the full family to -90 dB of peak (its delay's feedback-loop
  recurrences associate their float32 sums differently in the two
  packages: 3.9e-6 of a 1.70 peak measured, 1.2e-7 without the delay).
  A state carried over from JAX's sharded program renders JAX's audio.
* A bank the mesh does not divide (a 3-entry mesh) stays whole on the
  first device; the 2D lanes x graph layout equals the unsharded lanes.
* Lanes whose blocks start at different frames (lane k fed its own
  program's block ``b + k``): each lane equals its own program stepped
  from ``init_state`` over blocks ``k, k + 1, ...``.  Their parity to the
  JAX package's lanes is in tests/test_torch_parallel.py, which compiles
  the JAX lanes once for its module.
* The synth generator at 65536 Hz, sub3 without detune, two voices, over
  the note pairs 57 -> 45, 45 -> 57 and 57 -> 69: the second voice idles
  at note 60 (261.6 Hz, not a dyadic increment) through the first block,
  and JAX sums that phase in float32 where the port sums in float64; with
  JAX's ``phase_accumulate`` sums evaluated by numpy in float64
  (``jax.pure_callback``), every pair holds -90 dB
  (scripts/torch_synth_note_gap.py: -130.5..-130.9 dB; -84.1..-96.2
  without the attribution).  JAX renders them with the standard polyBLEP
  residual, the port's (``jax_polyblep.py``).
* Every CUDA launcher makes its card current through ``DeviceGuard``,
  which gives the caller's device back (csrc/device_guard.cuh).
"""

import importlib
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import phonic_tpu as jp
import phonic_tpu.ops.osc as josc
import phonic_tpu_torch as pt
from phonic_tpu.parallel.mesh import BatchedRenderProgram as JBatched
from phonic_tpu.parallel.mesh import GraphShardedProgram as JSharded
from phonic_tpu_torch.convert import state_from_jax
from phonic_tpu_torch.graph.engine import tree_leaves
from phonic_tpu_torch.io import wav as pwav
from phonic_tpu_torch.parallel.mesh import (BatchedRenderProgram,
                                            GraphShardedProgram,
                                            graph_state_shardings)
from jax_polyblep import standard_polyblep
from test_parallel import make_full_family_prog, make_wide_prog
from test_torch_parallel import (DIVERGENT, DIVERGENT_IDS, LANE_SCHEDULES,
                                 _lane_graph, _lane_programs, _leaf_banks,
                                 headline, pools)

SR = 48000
BLOCK = 1024
BLOCKS = 4
DB90 = 10.0 ** (-90.0 / 20.0)
CPU = torch.device("cpu")


def _effect(pkg, module, name):
    return getattr(importlib.import_module(f"{pkg.__name__}.effects.{module}"),
                   name)


def _tone_buffer(pkg, frames, freq, amp):
    t = np.arange(frames) / SR
    return pkg.AudioFileBuffer.from_array(
        (amp * np.sin(2 * np.pi * freq * t)).astype(np.float32)[None, :], SR)


def wide(pkg=pt, n_sources=8, n_subs=4):
    """``make_wide_prog``'s graph (tests/test_parallel.py)."""
    Gain = _effect(pkg, "gain", "GainEffect")
    rng = np.random.default_rng(3)
    main = pkg.Mixer("main")
    subs = [main.add_mixer(pkg.Mixer(f"s{i}")) for i in range(n_subs)]
    for i in range(n_sources):
        buf = _tone_buffer(pkg, 6000 + 500 * i, float(rng.uniform(100, 500)),
                           0.3)
        subs[i % n_subs].add_source(pkg.FileSource(buf, pkg.FilePlaybackOptions(
            repeat=None, fade_out_secs=0.0,
            volume=float(rng.uniform(0.3, 0.8)))))
    for s in subs:
        s.add_effect(Gain(gain=0.9))
    return main


def full_family(pkg=pt, n_sources=8, n_samplers=4):
    """``make_full_family_prog``'s graph: file banks, a sampler pool, sibling
    gains and a delay on the master."""
    Gain = _effect(pkg, "gain", "GainEffect")
    Delay = _effect(pkg, "delay", "DelayEffect")
    rng = np.random.default_rng(3)
    main = pkg.Mixer("main")
    subs = [main.add_mixer(pkg.Mixer(f"s{i}")) for i in range(4)]
    for i in range(n_sources):
        buf = _tone_buffer(pkg, 6000 + 500 * i, float(rng.uniform(100, 500)),
                           0.3)
        subs[i % 4].add_source(pkg.FileSource(buf, pkg.FilePlaybackOptions(
            repeat=None, fade_out_secs=0.0,
            volume=float(rng.uniform(0.3, 0.8)))))
    sbuf = _tone_buffer(pkg, 5000, 330.0, 0.4)
    for k in range(n_samplers):
        smp = pkg.Sampler(sbuf, pkg.GeneratorPlaybackOptions(voices=4))
        nid = smp.note_on(60 + k, volume=0.5, time=0)
        smp.note_off(nid, time=8 * BLOCK)
        subs[k % 4].add_source(smp)
    for s in subs:
        s.add_effect(Gain(gain=0.9))
    main.add_effect(Delay(delay_ms=30.0, feedback=0.3, wet=0.2))
    return main


GRAPHS = {"wide": wide, "full_family": full_family, "headline": headline}


def _program(graph, rate=SR, **config):
    return pt.RenderProgram(graph(pt), pt.EngineConfig(
        sample_rate=rate, block_frames=BLOCK, device="cpu", **config))


def _render(prog, state, blocks=BLOCKS, first=0):
    outs = []
    for b in range(first, first + blocks):
        state, y = prog.step(state, prog.block_inputs(b))
        outs.append(y)
    return state, outs


def _audio(outs):
    return np.concatenate([y[0].numpy() if isinstance(y, tuple) else y.numpy()
                           for y in outs], axis=-1)


def _close_db(got, want, bound=DB90):
    assert got.shape == want.shape and np.isfinite(got).all()
    peak = np.abs(want).max()
    assert peak > 0.05
    err = np.abs(got - want).max()
    assert err <= bound * peak, f"{20 * np.log10(err / peak):.1f} dB"


def _assert_states_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# the split program against the unsharded one
# ---------------------------------------------------------------------------

# graph, mesh size, config -> the banks the mesh splits
SPLITS = {
    ("wide", 2, ""): {"file_batches": [0], "pools": [], "chains": [0]},
    ("wide", 4, ""): {"file_batches": [0], "pools": [], "chains": [0]},
    ("full_family", 2, ""): {"file_batches": [0], "pools": [0],
                             "chains": [1]},
    ("full_family", 4, ""): {"file_batches": [0], "pools": [0],
                             "chains": [1]},
    ("headline", 2, ""): {"file_batches": [0], "pools": [], "chains": [1]},
    ("headline", 4, ""): {"file_batches": [0], "pools": [], "chains": []},
    ("headline", 2, "bypass_meter"): {"file_batches": [0], "pools": [],
                                      "chains": [1]},
}


@pytest.mark.parametrize("graph,k,config", sorted(SPLITS),
                         ids=[f"{g}-{k}{'-' + c if c else ''}"
                              for g, k, c in sorted(SPLITS)])
def test_split_equals_unsharded(graph, k, config):
    """Audio, mixer levels and the state after 4 blocks equal the unsharded
    program's bit for bit; the banks the mesh divides split."""
    cfg = dict(auto_bypass=True, meter_mixers=True) if config else {}
    prog = _program(GRAPHS[graph], **cfg)
    sharded = GraphShardedProgram(prog, ["cpu"] * k)
    assert {kind: sorted(s) for kind, s in sharded._splits.items()} \
        == SPLITS[(graph, k, config)]
    st, got = _render(sharded, sharded.init_state())
    ref = _program(GRAPHS[graph], **cfg)
    st_ref, want = _render(ref, ref.init_state())
    np.testing.assert_array_equal(_audio(got), _audio(want))
    assert np.abs(_audio(want)).max() > 0.05
    if config:
        for a, b in zip(got, want):
            assert list(a[1]) == list(b[1])
            assert torch.equal(a[1].stats, b[1].stats)
    _assert_states_equal(sharded.gather_state(st), st_ref)
    # a split bank's state is its shards' (one per mesh entry)
    for kind, banks in sharded._splits.items():
        for i in banks:
            assert len(st[kind][i]) == k


def test_state_shardings_tree():
    """``graph_state_shardings``: the state's tree with a device per leaf,
    a split bank's entry a list of its shards' trees; a mesh of one
    device puts every leaf on it."""
    prog = _program(wide)
    tree = graph_state_shardings(prog, ["cpu", "cpu"])
    assert isinstance(tree["file_batches"][0], list)
    assert [t["base"] for t in tree["file_batches"][0]] == [CPU, CPU]
    assert isinstance(tree["chains"][0], list) and len(tree["chains"][0]) == 2
    assert tree["smoothers"].keys() == prog.init_state()["smoothers"].keys()
    one = graph_state_shardings(prog, ["cpu"])
    assert one["file_batches"][0]["base"] == CPU
    assert all(d == CPU for d in tree_leaves(one))
    with pytest.raises(ValueError, match="2D"):
        graph_state_shardings(prog, ["cpu"], lane_axis="data")


def test_indivisible_group_stays_on_the_first_device():
    """A 3-entry mesh splits the 6-source file bank and leaves the 4-mixer
    chain whole on the first device; the audio equals the unsharded
    program's."""
    graph = lambda pkg: wide(pkg, n_sources=6, n_subs=4)  # noqa: E731
    prog = _program(graph)
    sharded = GraphShardedProgram(prog, ["cpu"] * 3)
    assert sorted(sharded._splits["file_batches"]) == [0]
    assert sharded._splits["chains"] == {}
    tree = graph_state_shardings(prog, ["cpu"] * 3)
    assert len(tree["file_batches"][0]) == 3
    assert isinstance(tree["chains"][0][0], dict)  # its stages, unsplit
    st, got = _render(sharded, sharded.init_state())
    assert not isinstance(st["chains"][0][0], list)
    ref = _program(graph)
    np.testing.assert_array_equal(_audio(got),
                                  _audio(_render(ref, ref.init_state())[1]))


# ---------------------------------------------------------------------------
# against the JAX package's GraphShardedProgram on its 4-device CPU mesh
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_sharded():
    """Each JAX graph's 4 blocks through its GraphShardedProgram on 4 of
    the CPU mesh's devices, and its state after block 0."""
    mesh = Mesh(np.array(jax.devices()[:4]), ("graph",))
    out = {}
    for name, make in (("wide", make_wide_prog),
                       ("full_family", make_full_family_prog)):
        sharded = JSharded(make(), mesh)
        st, outs, states = sharded.init_state(), [], []
        for b in range(BLOCKS):
            st, y = sharded.step(st, sharded.block_inputs(b))
            outs.append(np.asarray(y))
            states.append(jax.device_get(st))
        out[name] = (np.concatenate(outs, axis=-1), states[0])
    return out


@pytest.mark.parametrize("graph", ["wide", "full_family"])
def test_matches_jax_graph_sharded(jax_sharded, graph):
    want, _ = jax_sharded[graph]
    prog = _program(GRAPHS[graph])
    sharded = GraphShardedProgram(prog, ["cpu"] * 4)
    got = _audio(_render(sharded, sharded.init_state())[1])
    if graph == "wide":
        np.testing.assert_array_equal(got, want)
    else:
        _close_db(got, want)


def test_state_carried_from_jax_sharded(jax_sharded):
    """JAX's sharded state after block 0, fetched and converted
    (``state_from_jax``), placed on the port's mesh, renders blocks 1-3 as
    JAX did."""
    want, state1 = jax_sharded["wide"]
    prog = _program(wide)
    sharded = GraphShardedProgram(prog, ["cpu"] * 4)
    st = sharded.shard_state(state_from_jax(state1, prog))
    assert isinstance(st["file_batches"][0], list)
    got = _audio(_render(sharded, st, BLOCKS - 1, first=1)[1])
    np.testing.assert_array_equal(got, want[:, BLOCK:])


# ---------------------------------------------------------------------------
# the 2D lanes x graph layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("graph,rate,inputs", [
    (headline, SR, "shared"), (headline, SR, "per_lane"),
    (pools, 65536, "shared"), (pools, 65536, "per_lane")],
    ids=["headline-shared", "headline-per_lane", "pools-shared",
         "pools-per_lane"])
def test_2d_lanes_by_graph_equal_unsharded_lanes(graph, rate, inputs):
    """4 lanes as 2 lane shards, each split over 2 entries, equal the 4
    lanes on one device bit for bit, with shared inputs and with each
    lane's own: the headline's file bank and chain, and a sampler pool
    (its lowered arrays split by rows)."""
    mesh2d = [["cpu", "cpu"], ["cpu", "cpu"]]
    tree = graph_state_shardings(_program(graph, rate), mesh2d, "graph",
                                 lane_axis="data")
    # the bank that splits: the headline's file bank, the sampler pool
    kind, bank = (("file_batches", 0) if graph is headline else
                  ("pools", next(i for i, p in enumerate(
                      _program(graph, rate).pools) if len(p.paths) == 2)))
    assert len(tree) == 2 and len(tree[0][kind][bank]) == 2
    lanes = 4
    outs = {}
    for name, mesh in (("2d", mesh2d), ("one", None)):
        progs = _lane_programs(graph, pt, rate, lanes)
        pb = BatchedRenderProgram(_program(graph, rate), lanes=lanes,
                                  mesh=mesh)
        states, ys = pb.init_states(), []
        for b in range(3):
            x = (pb.block_inputs(b) if inputs == "shared"
                 else [p.block_inputs(b) for p in progs])
            states, y = pb.step(states, x)
            ys.append(y.numpy())
        outs[name] = np.concatenate(ys, axis=-1)
        if mesh is not None:
            assert all(isinstance(s, GraphShardedProgram) for s in pb.shards)
            assert [s.lanes for s in pb.shards] == [2, 2]
            assert bank in pb.shards[0]._splits[kind]
    assert outs["one"].shape == (lanes, 2, 3 * BLOCK)
    assert np.abs(outs["one"]).max() > 0.05
    np.testing.assert_array_equal(outs["2d"], outs["one"])


# ---------------------------------------------------------------------------
# lanes whose blocks start at different frames
# ---------------------------------------------------------------------------

OFFSETS = (0, 1, 2)  # lane k renders from block k


@pytest.mark.parametrize("graph,rate", DIVERGENT, ids=DIVERGENT_IDS)
def test_lanes_at_different_frames_match_own_programs(graph, rate):
    """Lane k, fed its own program's blocks ``b + k``, equals that program
    stepped from ``init_state`` over the same blocks; a lane-major split
    over two devices gives the same."""
    progs = _lane_programs(graph, pt, rate, len(OFFSETS))
    pb = BatchedRenderProgram(_program(graph, rate), lanes=len(OFFSETS))
    states, ys = pb.init_states(), []
    for b in range(3):
        states, y = pb.step(states, [p.block_inputs(b + o)
                                     for p, o in zip(progs, OFFSETS)])
        ys.append(y.numpy())
    got = np.concatenate(ys, axis=-1)
    assert got.shape == (len(OFFSETS), 2, 3 * BLOCK)
    for k, o in enumerate(OFFSETS):
        single = pt.RenderProgram(_lane_graph(graph, k)(pt), pt.EngineConfig(
            sample_rate=rate, block_frames=BLOCK, device="cpu"))
        LANE_SCHEDULES[graph](single, k)
        want = _audio(_render(single, single.init_state(), 3, first=o)[1])
        np.testing.assert_array_equal(got[k], want, err_msg=f"lane {k}")
    assert np.abs(got).max() > 0.05


def test_leaf_banks_at_different_frames(tmp_path):
    """Streamed, synth-source and empty banks with lanes at different
    frames: each lane equals its own program over its own blocks."""
    t = np.arange(20000) / SR
    path = str(tmp_path / "tone.wav")
    pwav.write_wav(path, (0.4 * np.sin(2 * np.pi * 250.0 * t) * np.exp(-t))
                   .astype(np.float32)[None], SR, bits=32, float_format=True)
    lanes = [_leaf_banks(path, k) for k in range(len(OFFSETS))]
    pb = BatchedRenderProgram(_leaf_banks(path, 0), lanes=len(OFFSETS))
    states, ys = pb.init_states(), []
    for b in range(2):
        states, y = pb.step(states, [p.block_inputs(b + o)
                                     for p, o in zip(lanes, OFFSETS)])
        ys.append(y.numpy())
    got = np.concatenate(ys, axis=-1)
    for k, o in enumerate(OFFSETS):
        single = _leaf_banks(path, k)
        want = _audio(_render(single, single.init_state(), 2, first=o)[1])
        np.testing.assert_array_equal(got[k], want, err_msg=f"lane {k}")
        assert np.abs(want).max() > 0.05


def test_split_lanes_at_different_frames():
    """Headline lanes at different frames through the 2D layout equal the
    same lanes on one device."""
    outs = []
    for mesh in ([["cpu", "cpu"]] * 3, None):
        progs = _lane_programs(headline, pt, SR, 3)
        pb = BatchedRenderProgram(_program(headline), lanes=3, mesh=mesh)
        states, ys = pb.init_states(), []
        for b in range(2):
            states, y = pb.step(states, [p.block_inputs(b + o)
                                         for p, o in zip(progs, OFFSETS)])
            ys.append(y.numpy())
        outs.append(np.concatenate(ys, axis=-1))
    np.testing.assert_array_equal(outs[0], outs[1])


# ---------------------------------------------------------------------------
# the synth generator's note pairs
# ---------------------------------------------------------------------------

GEN_SR = 65536


def _synth_pair(pkg, first, second):
    synths = importlib.import_module(pkg.__name__ + ".synths")
    gen = pkg.SynthGenerator(synths.sub3(detune_cents=0.0),
                             pkg.GeneratorPlaybackOptions(voices=2),
                             name="gen")
    a = gen.note_on(first, 0.6, time=0)
    gen.note_on(second, 0.4, time=BLOCK)
    gen.note_off(a, time=2 * BLOCK)
    main = pkg.Mixer("main")
    main.add_source(gen)
    return main


def _phases_np(p0, inc):
    """The port's phase sum (ops/osc.py): a float64 running sum of the
    float32 increments, each phase rounded once to float32."""
    inc = np.asarray(inc, np.float64)
    csum = np.cumsum(inc, axis=-1)
    p0 = np.asarray(p0, np.float64)

    def wrap(v):
        f = (v - np.floor(v)).astype(np.float32)
        return np.where(f >= 1.0, f - 1.0, f).astype(np.float32)
    return wrap(p0[..., None] + (csum - inc)), wrap(p0 + csum[..., -1])


def _attributed_phase_accumulate(phase0, freq, sr):
    """``phonic_tpu.ops.osc.phase_accumulate`` with its float32 cumsum
    evaluated by numpy in float64."""
    inc = jnp.asarray(freq, jnp.float32) / sr
    p0 = jnp.asarray(phase0, jnp.float32)
    return jax.pure_callback(
        _phases_np, (jax.ShapeDtypeStruct(inc.shape, jnp.float32),
                     jax.ShapeDtypeStruct(p0.shape, jnp.float32)),
        p0, inc, vmap_method="broadcast_all")


PAIRS = [(57, 45), (45, 57), (57, 69)]


@pytest.fixture(scope="module")
def jax_synth_pairs():
    """The JAX package's synth generator over the three note pairs, with
    its oscillator phase sums in float64: the pairs as the lanes of one
    ``BatchedRenderProgram``, each lane's inputs lowered by its own
    program (one compile for the three)."""
    saved = josc.phase_accumulate
    josc.phase_accumulate = _attributed_phase_accumulate
    try:
        with standard_polyblep():
            cfg = jp.EngineConfig(sample_rate=GEN_SR, block_frames=BLOCK)
            progs = [jp.RenderProgram(_synth_pair(jp, *pair), cfg)
                     for pair in PAIRS]
            jb = JBatched(jp.RenderProgram(_synth_pair(jp, *PAIRS[0]), cfg),
                          lanes=len(PAIRS))
            pack = jb._step_program.pack_inputs
            st, outs = jb.init_states(), []
            for b in range(3):
                packed = [pack(p.block_inputs(b)) for p in progs]
                st, y = jb.step(st, jax.tree.map(lambda *xs: np.stack(xs),
                                                  *packed))
                outs.append(np.asarray(y))
    finally:
        josc.phase_accumulate = saved
    return np.concatenate(outs, axis=-1)


@pytest.mark.parametrize("pair", range(len(PAIRS)),
                         ids=[f"{a}-{b}" for a, b in PAIRS])
def test_synth_note_pairs_match_attributed_jax(jax_synth_pairs, pair):
    """The port's synth generator against the JAX package's with its
    oscillator phase sums in float64, to -90 dB of peak over 3 blocks."""
    prog = pt.RenderProgram(_synth_pair(pt, *PAIRS[pair]), pt.EngineConfig(
        sample_rate=GEN_SR, block_frames=BLOCK, device="cpu"))
    _close_db(prog.render(3 * BLOCK), jax_synth_pairs[pair])


# ---------------------------------------------------------------------------
# the launchers' device switch
# ---------------------------------------------------------------------------

def test_launchers_restore_the_callers_device():
    """Every CUDA launcher sets its card through ``DeviceGuard`` (which
    sets the caller's device back on return), and none calls
    ``cudaSetDevice`` itself."""
    csrc = Path(pt.__file__).resolve().parent / "csrc"
    guard = (csrc / "device_guard.cuh").read_text()
    assert "cudaSetDevice(previous)" in guard
    launchers = 0
    for src in sorted(csrc.glob("*.cu")):
        text = src.read_text()
        assert "cudaSetDevice" not in text, src.name
        launches = len(re.findall(r"<<<", text))
        guards = len(re.findall(r"DeviceGuard on\(device\);", text))
        assert guards >= 1 if launches else guards == 0, src.name
        launchers += guards
    # ramp_read, the scans, the follower, the gate, the smoothers, the
    # delay, the reverb, the chorus, the synth voice and the synth mix
    assert launchers == 10

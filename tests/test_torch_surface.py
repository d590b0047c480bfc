"""The rest of the audio surface (phonic_tpu_torch/effects/filter.py,
effects/pan.py, ops/fader.py, sources/empty.py, ops/waveform.py) against
the JAX package on the CPU.

* FilterEffect, all four types, in four sibling sub-mixers that run as one
  batched chain in both packages, with a type switch and cutoff and Q
  automation mid-render: -90 dB of each block's peak.
* PanningEffect width, inversion and pan, two batched lanes and the
  master, with automation: to 1e-6.
* The fader functions, to 1e-6; ``ops/waveform`` bit for bit.
* EmptySource / EmptyGenerator in a graph render silence and leave the
  rest of the mix unchanged.
* One RenderProgram over a graph that holds every node type this slice
  adds renders on the CPU.
* Every public name of every JAX module has a counterpart in the port's
  module of the same path, except the names of ``NOT_PORTED``, each with
  its reason.
"""

import ast
import importlib
import inspect
import pkgutil

import numpy as np
import pytest
import torch

import phonic_tpu as jp
import phonic_tpu_torch as pt
from phonic_tpu.effects.filter import FilterEffect as JFilter
from phonic_tpu.effects.pan import PanningEffect as JPan
from phonic_tpu.ops import fader as jfader
from phonic_tpu.ops import waveform as jwaveform
from phonic_tpu.sources.empty import EmptyGenerator as JEmptyGen
from phonic_tpu.sources.empty import EmptySource as JEmpty
from phonic_tpu_torch.ops import fader as pfader
from phonic_tpu_torch.ops import waveform as pwaveform

SR = 48000
BLOCK = 4096
BLOCKS = 3
DB90 = 10.0 ** (-90.0 / 20.0)


def _pkg(pkg):
    if pkg is jp:
        return JFilter, JPan, JEmpty, JEmptyGen
    return pt.FilterEffect, pt.PanningEffect, pt.EmptySource, pt.EmptyGenerator


def _tone(pkg, frames, freqs, seed):
    """A stereo pair of partial stacks with a little noise (broadband
    content for the filters)."""
    rng = np.random.default_rng(seed)
    t = np.arange(frames) / SR
    x = np.stack([sum(0.2 * np.sin(2 * np.pi * f * (1 + 0.1 * c) * t)
                      for f in freqs) for c in range(2)])
    x = x + 0.05 * rng.standard_normal(x.shape)
    return pkg.AudioFileBuffer.from_array(x.astype(np.float32), SR)


def _program(pkg, main):
    if pkg is jp:
        return jp.RenderProgram(main, jp.EngineConfig(block_frames=BLOCK))
    return pt.RenderProgram(main, pt.EngineConfig(block_frames=BLOCK,
                                                  device="cpu"))


def _render(pkg, prog):
    frames = BLOCKS * BLOCK
    return (prog.render(frames, mode="loop") if pkg is jp
            else prog.render(frames))


def _blocks_close(got, want, bound):
    assert got.shape == want.shape and np.isfinite(got).all()
    for b in range(BLOCKS):
        sl = slice(b * BLOCK, (b + 1) * BLOCK)
        peak = np.abs(want[:, sl]).max()
        assert peak > 0.05
        err = np.abs(got[:, sl] - want[:, sl]).max()
        assert err <= bound * peak, f"block {b}: {20 * np.log10(err / peak):.1f} dB"


# ---------------------------------------------------------------------------
# 1. FilterEffect
# ---------------------------------------------------------------------------

FILTER_TYPES = ("Lowpass", "Bandpass", "Bandstop", "Highpass")


def _filters(pkg):
    Filter = _pkg(pkg)[0]
    main = pkg.Mixer("main")
    for k, ftype in enumerate(FILTER_TYPES):
        sub = main.add_mixer(pkg.Mixer(f"sub{k}"))
        sub.add_source(pkg.FileSource(
            _tone(pkg, 20000, (110.0 * (k + 1), 2300.0, 7100.0), k),
            pkg.FilePlaybackOptions(volume=0.5, repeat=None), name="src"))
        sub.add_effect(Filter(ftype, 1000.0 * (k + 1), 0.5 + 0.5 * k,
                              name="filter"))
    return main


def _schedule_filters(prog):
    # a stepped type switch, an exponentially smoothed cutoff ramp and a
    # linearly smoothed Q change, mid-block
    prog.set_parameter("main/sub0/filter", "type", 3, at_frame=BLOCK + 1000)
    prog.set_parameter("main/sub2/filter", "type", 1, at_frame=2 * BLOCK)
    prog.set_parameter("main/sub1/filter", "cuto", 300.0, at_frame=700)
    prog.set_parameter("main/sub3/filter", "cuto", 9000.0, at_frame=BLOCK + 50)
    prog.set_parameter("main/sub3/filter", "fltq", 3.0, at_frame=BLOCK + 50)


def test_filter_matches_jax():
    outs = []
    for pkg in (jp, pt):
        prog = _program(pkg, _filters(pkg))
        _schedule_filters(prog)
        outs.append(_render(pkg, prog))
        if pkg is jp:
            assert len(prog.effect_batches) == 1
        else:
            assert [len(c["mixers"]) for c in prog.chains] == [4]
    want, got = outs
    _blocks_close(got, want, DB90)


def test_filter_tail():
    f = pt.FilterEffect()
    ctx = pt.RenderProgram(pt.Mixer("main"), pt.EngineConfig(
        device="cpu")).ctx
    assert f.tail_frames(ctx) == SR // 10 == JFilter().tail_frames(ctx)


# ---------------------------------------------------------------------------
# 2. PanningEffect, and the empty nodes
# ---------------------------------------------------------------------------

def _panning(pkg, empties=True):
    _, Pan, Empty, EmptyGen = _pkg(pkg)
    main = pkg.Mixer("main")
    for k in range(2):
        sub = main.add_mixer(pkg.Mixer(f"sub{k}"))
        sub.add_source(pkg.FileSource(
            _tone(pkg, 15000, (150.0 + 60 * k, 420.0), 10 + k),
            pkg.FilePlaybackOptions(volume=0.6, repeat=None), name="src"))
        sub.add_effect(Pan(pan=-0.5 + k, width=0.4 + 1.2 * k,
                           invert_l=k == 1, name="pan"))
        if empties:
            sub.add_source(Empty(name="empty"))
    if empties:
        main.add_source(EmptyGen(name="nothing"))
    main.add_effect(Pan(width=1.0, name="pan"))
    return main


def _schedule_panning(prog):
    prog.set_parameter("main/pan", "pan ", 0.7, at_frame=BLOCK + 300)
    prog.set_parameter("main/pan", "wdth", 1.8, at_frame=2 * BLOCK + 10)
    prog.set_parameter("main/sub0/pan", "invr", 1.0, at_frame=BLOCK)
    prog.set_parameter("main/sub1/pan", "wdth", 1.0, at_frame=2 * BLOCK)


def test_panning_and_empties_match_jax():
    outs = []
    for pkg in (jp, pt):
        prog = _program(pkg, _panning(pkg))
        _schedule_panning(prog)
        outs.append(_render(pkg, prog))
    want, got = outs
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_empties_render_silence():
    """The graph with the empty nodes equals the graph without them, and
    they count no duration."""
    progs = [_program(pt, _panning(pt, empties=e)) for e in (True, False)]
    for prog in progs:
        _schedule_panning(prog)
    got, want = (_render(pt, p) for p in progs)
    np.testing.assert_array_equal(got, want)
    ctx = progs[0].ctx
    assert pt.EmptySource().duration_frames(ctx) == 0
    assert pt.EmptyGenerator().duration_frames(ctx) == 0
    assert sum(isinstance(p.proto, (pt.EmptySource, pt.EmptyGenerator))
               for p in progs[0].pools) == 3


def test_panning_needs_stereo():
    main = pt.Mixer("main")
    main.add_source(pt.FileSource(_tone(pt, 1000, (200.0,), 0)))
    main.add_effect(pt.PanningEffect(pan=0.3))
    prog = pt.RenderProgram(main, pt.EngineConfig(channels=1,
                                                  block_frames=1024,
                                                  device="cpu"))
    with pytest.raises(ValueError, match="stereo"):
        prog.render(1024)


# ---------------------------------------------------------------------------
# 3. the fader, the waveform helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("start", [(1.0, 0.0, 0.05), (0.0, 0.8, 0.01),
                                   (1.0, 0.0, 0.0), None])
def test_fader_matches_jax(start):
    """A fade out, a fade in, a jump (zero duration) and a stopped fader,
    over two blocks."""
    js, ps = jfader.fader_init(), pfader.fader_init()
    if start is not None:
        js = jfader.fader_start(js, *start, SR)
        ps = pfader.fader_start(ps, *start, SR)
    for n in (4096, 2048):
        js, jg = jfader.fader_block(js, n)
        ps, pg = pfader.fader_block(ps, n)
        np.testing.assert_allclose(pg.numpy(), np.asarray(jg), rtol=0,
                                   atol=1e-6)
        assert int(ps.mode) == int(js.mode)
        np.testing.assert_allclose(float(ps.current), float(js.current),
                                   atol=1e-6)
    np.testing.assert_allclose(
        pfader.fader_inertia(torch.tensor([0.0, 0.01, 0.5]), SR).numpy(),
        np.asarray(jfader.fader_inertia(np.float32([0.0, 0.01, 0.5]), SR)),
        rtol=1e-6)


def test_waveform_equals_jax():
    rng = np.random.default_rng(4)
    audio = rng.standard_normal((2, 10001)).astype(np.float32)
    for buckets in (1, 7, 512):
        for got, want in zip(pwaveform.mixed_down(audio, buckets),
                             jwaveform.mixed_down(audio, buckets)):
            np.testing.assert_array_equal(got, want)
        for got, want in zip(pwaveform.multi_channel(audio, buckets),
                             jwaveform.multi_channel(audio, buckets)):
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
    empty = pwaveform.mixed_down(np.zeros((2, 0), np.float32), 4)
    np.testing.assert_array_equal(empty[0], np.zeros(4, np.float32))


# ---------------------------------------------------------------------------
# 4. every new node type in one program
# ---------------------------------------------------------------------------

def test_program_over_every_new_node_type(tmp_path):
    path = tmp_path / "s.wav"
    t = np.arange(20000) / SR
    pt.io.wav.write_wav(path, np.stack([np.sin(2 * np.pi * 200 * t)] * 2
                                       ).astype(np.float32) * 0.3, SR)
    main = pt.Mixer("main")
    gen = pt.SynthGenerator(pt.synths.sub3(), pt.GeneratorPlaybackOptions(
        voices=3))
    gen.note_off(gen.note_on(60, 0.8, time=0), time=3000)
    main.add_source(gen)
    main.add_source(pt.SynthSource(pt.synths.organ(), pt.SynthPlaybackOptions(
        frequency=220.0, duration=5000)))
    main.add_source(pt.StreamedFileSource(str(path)))
    main.add_source(pt.EmptySource())
    main.add_source(pt.EmptyGenerator())
    main.add_effect(pt.FilterEffect("Highpass", 80.0))
    main.add_effect(pt.PanningEffect(pan=-0.2, width=0.8))
    prog = pt.RenderProgram(main, pt.EngineConfig(block_frames=2048,
                                                  device="cpu"))
    audio = prog.render()
    assert audio.shape == (2, prog.natural_duration_frames())
    assert np.isfinite(audio).all() and np.abs(audio).max() > 0.1


# ---------------------------------------------------------------------------
# 5. public names, module by module
# ---------------------------------------------------------------------------

_ONE_HOT = "a one-hot matrix-product read of the TPU; a gather here"
_SOURCE_NODE = ("a source's per-node step: every source renders as a lane "
                "of a bank (FileBatch / LeafBatch render_lanes)")
# JAX name (module, or module:name, or module:Class.attribute) -> reason
NOT_PORTED = {
    "phonic_tpu.ops.pallas_scan": "the TPU kernels; the port's are "
                                  "csrc/scan.cu behind ops/scan.py",
    **{f"phonic_tpu.ops.rampread:{n}": "the TPU read's stride-124 "
       "overlapped-row packing; the CUDA read takes planar buffers"
       for n in ("LANE", "PAD_LEFT", "STRIDE", "pack", "slice_rows",
                 "window_rows")},
    "phonic_tpu.graph.batching:RR_CHUNK": "the TPU read's window chunk",
    **{f"phonic_tpu.ops.resample:{n}": _ONE_HOT
       for n in ("MM2_MAX_ROWS", "MM_MAX_ROWS", "MM_PAD_LEFT", "MM_STRIDE",
                 "hermite_read_mm", "hermite_read_mm2", "mm_pack", "mm_rows",
                 "use_mm", "use_mm2")},
    **{f"phonic_tpu.ops.chrono:{n}": "the absolute-time window's one-hot "
       "machinery; the port rolls its window (chrono.roll) and gathers "
       "(read_frac_win)"
       for n in ("begin", "end", "read_frac", "read_frac_win_grouped",
                 "write_at")},
    "phonic_tpu.generators.granular:source_ext": "the tap buffer of the "
        "one-hot grain read; LeafBatch's read table holds the extended "
        "buffer",
    "phonic_tpu.graph.engine:RenderProgram.jit_cache_size": "the recompile "
        "guard; nothing is compiled here",
    "phonic_tpu.generators.sampler:Sampler.BATCH_CARRY": "the port carries "
        "a sampler pool's whole state across a rebuild, grain pools too",
    "phonic_tpu.generators.sampler:Sampler.batch_pad_states": "LeafBatch "
        "pads the pool's buffers itself",
    **{f"phonic_tpu.{m}:{c}.{a}": _SOURCE_NODE for m, c, a in (
        ("graph.nodes", "Node", "init_state"), ("graph.nodes", "Node", "process"),
        ("graph.nodes", "Source", "init_state"),
        ("graph.nodes", "Source", "process"),
        ("generators.base", "Generator", "init_state"),
        ("generators.base", "Generator", "process"),
        ("generators.synth", "SynthGenerator", "process"),
        ("sources.empty", "EmptySource", "process"),
        ("sources.empty", "EmptyGenerator", "process"),
        ("sources.file", "FileSource", "init_state"),
        ("sources.file", "FileSource", "process"),
        ("sources.streamed", "StreamedFileSource", "process"),
        ("sources.synth", "SynthSource", "process"))},
}


def _own_names(mod, is_pkg: bool) -> set:
    """A package's public names (what it imports included); a module's
    names defined in its source, and its ``__all__``."""
    if is_pkg:
        return {n for n in vars(mod) if not n.startswith("_")
                and not inspect.ismodule(getattr(mod, n))}
    tree = ast.parse(open(mod.__file__).read())
    out = set(getattr(mod, "__all__", ()))
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            out.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            out.add(node.target.id)
    return {n for n in out if not n.startswith("_")}


def test_public_names_have_counterparts():
    missing = []
    for info in pkgutil.walk_packages(jp.__path__, "phonic_tpu."):
        jm = importlib.import_module(info.name)
        try:
            pm = importlib.import_module("phonic_tpu_torch"
                                         + info.name[len("phonic_tpu"):])
        except ModuleNotFoundError:
            missing.append(info.name)
            continue
        for name in sorted(_own_names(jm, info.ispkg)):
            if not hasattr(pm, name):
                missing.append(f"{info.name}:{name}")
                continue
            jo, po = getattr(jm, name), getattr(pm, name)
            if inspect.isclass(jo) and inspect.isclass(po):
                missing.extend(f"{info.name}:{name}.{a}" for a in dir(jo)
                               if not a.startswith("_") and not hasattr(po, a))
    missing += [f"phonic_tpu:{n}" for n in sorted(_own_names(jp, True))
                if not hasattr(pt, n)]
    unlisted = sorted(set(missing) - set(NOT_PORTED))
    assert not unlisted, unlisted
    # every entry of the list is still missing: a port makes it go
    assert sorted(set(NOT_PORTED) - set(missing)) == []

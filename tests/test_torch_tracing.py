"""The port's spans and counters (phonic_tpu_torch/tracing.py) on the CPU.

* Off, a block records no span and moves no counter, and ``span()`` hands
  out one shared no-op context.
* Under ``enable()``, one block of a file source -> EQ5 -> chorus graph
  with a sampler pool records one ``engine.step`` whose children are the
  smoothers, the two source banks and the two effect stages, each inside
  its parent and serving the step's block; the lowering and the upload
  serve it too.
* Under a ``torch.profiler`` session each span is also a ``phonic.*``
  range on the profiler's CPU timeline, no user annotation, at the span's
  own times: one clock.
* ``Player.run`` records each block's dispatch, finish and wait, and its
  ``cpu_load()`` is those spans' durations folded by its own rule.
* The benchmark's readers of the spans (``portbench/metrics/``) read
  nothing without spans, and per block values that add up with them.
* A synth generator's render records ``synth.notes`` and ``synth.voices``
  inside its pool's span, and its lowering counts its trigger slots under
  ``synth.trigger_slots``; with tracing off, neither.
"""

import importlib.util
import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from phonic_tpu_torch import (AudioFileBuffer, EngineConfig,
                              FilePlaybackOptions, FileSource,
                              GeneratorPlaybackOptions, Mixer, RenderProgram,
                              Sampler, SynthGenerator, synths, tracing)
from phonic_tpu_torch.effects.chorus import ChorusEffect
from phonic_tpu_torch.effects.eq5 import Eq5Effect
from phonic_tpu_torch.outputs.null import NullOutput
from phonic_tpu_torch.player import CpuLoad, Player, PlayerConfig

SR = 48000
BLOCK = 1024


@pytest.fixture(autouse=True)
def clean_registry():
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


def _tone(frames, freq):
    t = np.arange(frames) / SR
    x = (0.5 * np.sin(2 * np.pi * freq * t) * np.exp(-3 * t)).astype(np.float32)
    return AudioFileBuffer.from_array(x[None, :], SR)


def _program():
    """A file source -> EQ5 -> chorus sub-mixer and a sampler (a generator
    pool) on the main mixer."""
    m = Mixer("main")
    sub = m.add_mixer(Mixer("sub"))
    sub.add_source(FileSource(_tone(9000, 220), FilePlaybackOptions(
        volume=0.5, repeat=None), name="src"))
    sub.add_effect(Eq5Effect(gains=[3.0, -2.0, 0.0, 1.0, 2.0], name="eq"))
    sub.add_effect(ChorusEffect(rate=0.7, name="chorus"))
    sampler = Sampler(_tone(6000, 330), GeneratorPlaybackOptions(voices=4),
                      name="sampler")
    sampler.note_on(60, 0.8, time=100)
    m.add_source(sampler)
    return RenderProgram(m, EngineConfig(sample_rate=SR, block_frames=BLOCK,
                                         device="cpu"))


def _render(prog, blocks=(0,)):
    state = prog.init_state()
    for b in blocks:
        state, _ = prog.step(state, prog.block_inputs(b))


def test_off_records_nothing():
    prog = _program()
    _render(prog, (0, 1))
    tracing.count("kernel.ramp_read")
    assert tracing.spans() == [] and tracing.counters() == {}
    assert tracing.span("engine.step") is tracing.span("effect.Eq5Effect")
    assert tracing.span("x", block=3) is tracing.span("y")


def test_one_block_spans_nest():
    prog = _program()
    state = prog.init_state()
    state, _ = prog.step(state, prog.block_inputs(0))  # not traced
    tracing.enable()
    state, _ = prog.step(state, prog.block_inputs(2))
    tracing.disable()
    sp = tracing.spans()
    names = [s.name for s in sp]
    assert names.count("engine.step") == 1
    assert names.count("engine.lower") == 1
    step = names.index("engine.step")
    children = sorted(s.name for s in sp if s.parent == step)
    assert children == ["effect.ChorusEffect", "effect.Eq5Effect",
                        "engine.smooth", "source.file_bank", "source.pool"]
    lower = names.index("engine.lower")
    assert sorted(s.name for s in sp if s.parent == lower) == [
        "engine.lower.nodes", "engine.lower.params"]
    for i, s in enumerate(sp):
        assert s.block == 2, s
        assert s.end is not None and s.start <= s.end
        if s.parent >= 0:
            p = sp[s.parent]
            assert p.start <= s.start and s.end <= p.end, (p, s)
            assert s.parent < i
        else:
            assert s.name in ("engine.lower", "engine.upload", "engine.step")
    # the upload before the step, the lowering before both
    top = [s.name for s in sp if s.parent < 0]
    assert top == ["engine.lower", "engine.upload", "engine.step"]


def test_profiler_ranges_share_the_clock():
    prog = _program()
    state = prog.init_state()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        state, _ = prog.step(state, prog.block_inputs(1))
        tracing.count("kernel.iir2", 2)
    sp = tracing.spans()
    # the sampler's voice plan counts its one note and lowered segment
    assert len(sp) >= 9 and tracing.counters() == {
        "kernel.iir2": 2, "generator.plan_events": 1,
        "generator.segments": 1}
    t0 = prof.profiler.kineto_results.trace_start_ns()
    ranges = sorted((e for e in prof.events() if e.name.startswith("phonic.")),
                    key=lambda e: e.time_range.start)
    assert [e.name for e in ranges] == ["phonic." + s.name for s in sp]
    for e, s in zip(ranges, sp):
        assert e.device_type == torch.autograd.DeviceType.CPU
        assert not e.is_user_annotation
        assert abs(e.time_range.start * 1e3 + t0 - s.start) < 100e3, (e, s)
        assert abs(e.time_range.end * 1e3 + t0 - s.end) < 100e3, (e, s)
    # off again once the profiler stops
    _render(prog)
    assert len(tracing.spans()) == len(sp)


def test_player_spans_are_its_cpu_load():
    player = Player(NullOutput(SR, 2), PlayerConfig(block_frames=BLOCK),
                    device="cpu")
    for k in range(2):
        sub = player.add_mixer()
        player.play_file(_tone(9000, 200 + 90 * k),
                         FilePlaybackOptions(volume=0.5, repeat=None),
                         mixer=sub.mixer)
        sub.add_effect(ChorusEffect(rate=0.7 + k))
    tracing.enable()
    player.run(4 * BLOCK)
    tracing.disable()
    sp = tracing.spans()
    by = {name: [s for s in sp if s.name == name] for name in
          ("player.dispatch", "player.finish", "player.wait", "engine.step",
           "engine.lower")}
    for name, got in by.items():
        assert [s.block for s in got] == [0, 1, 2, 3], name
    for s in by["player.wait"]:
        assert sp[s.parent].name == "player.finish"
        assert sp[s.parent].block == s.block
    for name in ("engine.step", "engine.lower"):
        for s in by[name]:
            assert sp[s.parent].name == "player.dispatch"
    # the pipeline: block 0 finishes after blocks 1 and 2 are dispatched
    assert by["player.dispatch"][2].end <= by["player.finish"][0].start
    want = CpuLoad()
    for d, f in zip(by["player.dispatch"], by["player.finish"]):
        load = ((d.end - d.start) + (f.end - f.start)) / 1e9 / (BLOCK / SR)
        want.peak = max(want.peak * 0.95, load)
        a = player._cpu_alpha
        want.average = (1 - a) * want.average + a * load
    got = player.cpu_load()
    assert (got.average, got.peak) == (want.average, want.peak)
    assert got.average > 0


def test_span_buffer_is_bounded(monkeypatch):
    monkeypatch.setattr(tracing, "MAX_SPANS", 3)
    tracing.enable()
    for b in range(4):
        with tracing.span("outer", block=b):
            with tracing.span("inner"):
                pass
    assert [(s.name, s.block) for s in tracing.spans()] == [
        ("outer", 0), ("inner", 0), ("outer", 1)]
    assert tracing.counters() == {"tracing.dropped": 5}


METRICS = ("engine.host_ms_per_block", "engine.lower_ms_per_block",
           "sources.host_ms_per_block", "effects.host_ms_per_block",
           "player.host_ms_per_block", "player.wait_ms_per_block",
           "kernels.launches_per_block")


def _metric(name):
    """``portbench/metrics/<name>.py``, loaded by path as the benchmark
    loads it."""
    path = Path(__file__).resolve().parents[1] / "portbench" / "metrics" / \
        f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_benchmark_readers_add_up():
    """The benchmark's readers of the spans and counters: nothing without
    spans; after a traced Player run, per block, the engine step holds the
    sources and effects, and the Player's host time holds the lowering, the
    step and the wait."""
    r = types.SimpleNamespace(module=lambda kind, name: _metric(name),
                              notes=[])

    def read():
        return {m: _metric(m).read(r) for m in METRICS}

    assert read() == dict.fromkeys(METRICS)
    player = Player(NullOutput(SR, 2), PlayerConfig(block_frames=BLOCK),
                    device="cpu")
    sub = player.add_mixer()
    player.play_file(_tone(9000, 200), FilePlaybackOptions(volume=0.5),
                     mixer=sub.mixer)
    sub.add_effect(Eq5Effect(gains=[3.0, -2.0, 0.0, 1.0, 2.0]))
    sub.add_effect(ChorusEffect(rate=0.7))
    player.run(BLOCK)  # built and warm
    tracing.enable()
    player.run(3 * BLOCK)
    tracing.count("kernel.iir2", 6)
    tracing.disable()
    got = read()
    assert all(v is not None for v in got.values()), got
    assert got["kernels.launches_per_block"] == 2.0
    assert got["engine.host_ms_per_block"] >= (
        got["sources.host_ms_per_block"] + got["effects.host_ms_per_block"])
    assert got["player.host_ms_per_block"] >= (
        got["engine.lower_ms_per_block"] + got["engine.host_ms_per_block"]
        + got["player.wait_ms_per_block"])
    # the stage table: every span name once, with its calls per block
    (table,) = r.notes
    assert table.startswith("stages over 3 blocks")
    for name in ("engine.step", "effect.ChorusEffect", "effect.GainEffect",
                 "player.wait", "engine.lower.params"):
        assert re.search(rf"[:,] {re.escape(name)} -?[0-9.]+ x1[,;]",
                         table), (name, table)
    assert table.endswith("; counters per block: kernel.iir2 2")


def test_synth_spans_and_counter():
    """A 4-voice synth generator whose voice 0 starts two notes in block 0
    (2 trigger slots): off, a block records nothing; on, one block records
    ``synth.notes`` and ``synth.voices`` inside ``source.pool`` and counts
    4 x 2 slots, which the benchmark's readers give per block."""
    def program():
        gen = SynthGenerator(synths.sub3(), GeneratorPlaybackOptions(voices=4),
                             release_secs=0.001, name="synth")
        for t in (100, 300):
            gen.note_off(gen.note_on(60, time=t), time=t + 50)
        m = Mixer("main")
        m.add_source(gen)
        return RenderProgram(m, EngineConfig(sample_rate=SR, block_frames=BLOCK,
                                             device="cpu"))

    r = types.SimpleNamespace(module=lambda kind, name: _metric(name),
                              notes=[])
    readers = ("synth.host_ms_per_block", "synth.trigger_slots_per_block")
    _render(program())
    assert tracing.spans() == [] and tracing.counters() == {}
    assert [_metric(m).read(r) for m in readers] == [None, None]
    prog = program()
    tracing.enable()
    _render(prog)
    tracing.disable()
    sp = tracing.spans()
    names = [s.name for s in sp]
    pool = names.index("source.pool")
    assert [s.name for s in sp if s.parent == pool] == ["synth.notes",
                                                        "synth.voices"]
    assert tracing.counters()["synth.trigger_slots"] == 8
    host, slots = (_metric(m).read(r) for m in readers)
    assert host > 0.0 and slots == 8.0

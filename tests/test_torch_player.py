"""The Player slice through both packages on the CPU.

A small live graph: two sub-mixers, each with an endless and a short file
source and EQ5 -> chorus (one batched chain in both packages), a master
reverb before the Player's master gain, 2048-frame blocks, metering and
auto-bypass on as the Player always runs.  One scripted run on each side
renders 10 blocks through ``render_block``; the two short sources run out
and are retired in one rebuild (``retire_after_dead_sources=2``), and at
block 6 a third sub-mixer with the same chain joins the batched chain.

* Each block's audio matches the JAX Player to -90 dB of its peak, and each
  mixer's peak and RMS match to rtol 1e-4.
* The edited, retired render equals the port's unedited render bit for bit.
* Auto-bypass engages after max_tail_frames + 2 s of silence, as in JAX.
* Sibling chains batched under auto-bypass keep a late lane frozen while
  it is parked (the JAX package's test_batched_chains_freeze_parked_lanes).
* A JAX state with silence ages, carried over with ``state_from_jax``,
  renders the next block as JAX does.
* ``step_packed`` equals ``step`` bit for bit; the pipelined ``run``
  equals serial ``render_block``s, split runs equal one run.
* Checkpoints round-trip, and a mismatched one raises.
"""

import importlib
import time

import jax
import numpy as np
import pytest
import torch

from phonic_tpu_torch import (AudioFileBuffer, EngineConfig, FilePlaybackOptions,
                              FileSource, Mixer, RenderProgram, Sampler)
from phonic_tpu_torch.checkpoint import load_state, save_state
from phonic_tpu_torch.convert import state_from_jax
from phonic_tpu_torch.effects.chorus import ChorusEffect
from phonic_tpu_torch.effects.eq5 import Eq5Effect
from phonic_tpu_torch.effects.reverb import ReverbEffect
from phonic_tpu_torch.errors import CheckpointError
from phonic_tpu_torch.generators.base import Generator, GeneratorPlaybackOptions
from phonic_tpu_torch.graph.engine import AGE_MAX
from phonic_tpu_torch.outputs.null import NullOutput
from phonic_tpu_torch import synths
from phonic_tpu_torch.io.wav import write_wav
from phonic_tpu_torch.player import PlaybackHandle, Player, PlayerConfig
from phonic_tpu_torch.sources.streamed import StreamedFileSource
from phonic_tpu_torch.synth64 import synth_player
from phonic_tpu_torch.player_rt import player_rt_player

SR = 48000
BLOCK = 2048
BLOCKS = 10
EDIT_BLOCK = 6
DB90 = 10.0 ** (-90.0 / 20.0)
LEVEL_RTOL = 1e-4


def _package(name):
    """The classes the scenarios use, from ``phonic_tpu`` or the port."""
    names = {"": ("AudioFileBuffer", "FilePlaybackOptions", "FileSource",
                  "Mixer", "RenderProgram", "EngineConfig"),
             ".player": ("Player", "PlayerConfig"),
             ".outputs.null": ("NullOutput",),
             ".effects.eq5": ("Eq5Effect",),
             ".effects.chorus": ("ChorusEffect",),
             ".effects.delay": ("DelayEffect",),
             ".effects.reverb": ("ReverbEffect",)}
    ns = {}
    for mod, attrs in names.items():
        m = importlib.import_module(name + mod)
        ns.update((a, getattr(m, a)) for a in attrs)
    return type(name, (), ns)


JAX = _package("phonic_tpu")
PORT = _package("phonic_tpu_torch")


def _tone(pkg, frames, freq, decay=3.0):
    t = np.arange(frames) / SR
    x = (0.5 * np.sin(2 * np.pi * freq * t) * np.exp(-t * decay)).astype(np.float32)
    return pkg.AudioFileBuffer.from_array(x[None, :], SR)


def _live_player(pkg, edit=True, retire=True, **device):
    """The scripted Player; returns the audio [2, BLOCKS * BLOCK] and, per
    block, every mixer's (peak, rms) in walk order."""
    player = pkg.Player(pkg.NullOutput(SR, 2), pkg.PlayerConfig(
        block_frames=BLOCK, retire_after_dead_sources=2,
        auto_retire_sources=retire), **device)
    rng = np.random.default_rng(3)
    for k in range(2):
        sub = player.add_mixer()
        player.play_file(_tone(pkg, 20000, 110 * (k + 2)), pkg.FilePlaybackOptions(
            volume=0.5, panning=0.3 - 0.6 * k, repeat=None), mixer=sub.mixer)
        player.play_file(_tone(pkg, 3000 + 1500 * k, 300 + 50 * k),
                         pkg.FilePlaybackOptions(volume=0.4, speed=0.75 + 0.5 * k),
                         mixer=sub.mixer)
        sub.add_effect(pkg.Eq5Effect(gains=list(rng.uniform(-6, 6, 5))))
        sub.add_effect(pkg.ChorusEffect(rate=0.5 + k))
    player.add_effect(pkg.ReverbEffect(room_size=0.6, wet=0.2,
                                       min_room_size=0.55))
    audio, levels = [], []
    for b in range(BLOCKS):
        if edit and b == EDIT_BLOCK:
            sub = player.add_mixer()
            sub.add_effect(pkg.Eq5Effect())
            sub.add_effect(pkg.ChorusEffect(rate=1.5))
        audio.append(player.render_block())
        levels.append([(player.mixer_audio_level(obj).peak.copy(),
                        player.mixer_audio_level(obj).rms.copy())
                       for _, kind, obj in player.main_mixer.walk()
                       if kind == "mixer"])
    return np.concatenate(audio, axis=1), levels, player


@pytest.fixture(scope="module")
def jax_live():
    audio, levels, player = _live_player(JAX)
    return audio, levels


def _close(got, want, peak=None):
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    peak = np.abs(want).max() if peak is None else peak
    assert peak > 0.01
    err = np.abs(got - want).max()
    assert err <= DB90 * peak, f"{20 * np.log10(err / peak):.1f} dB"


def test_player_matches_jax(jax_live):
    want, want_levels = jax_live
    got, got_levels, player = _live_player(PORT, device="cpu")
    assert player.rebuilds == 2  # the retirement and the edit
    assert len(player._program.chains[1]["mixers"]) == 3
    for b in range(BLOCKS):
        sl = slice(b * BLOCK, (b + 1) * BLOCK)
        _close(got[:, sl], want[:, sl])
        assert len(got_levels[b]) == len(want_levels[b])
        for (gp, gr), (wp, wr) in zip(got_levels[b], want_levels[b]):
            np.testing.assert_allclose(gp, wp, rtol=LEVEL_RTOL)
            np.testing.assert_allclose(gr, wr, rtol=LEVEL_RTOL)


def test_edits_leave_survivors_bit_exact():
    """Retiring dead sources and adding a silent sub-mixer to the batched
    chain move lanes between banks and chains; the surviving sources'
    audio does not change by one bit."""
    got, _, player = _live_player(PORT, device="cpu")
    want, _, plain = _live_player(PORT, edit=False, retire=False, device="cpu")
    assert player.rebuilds == 2 and plain.rebuilds == 0
    assert len(player._program.source_paths) == 2
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# auto-bypass
# ---------------------------------------------------------------------------

BYPASS_BLOCKS = 58  # 2.47 s: past EQ5's limit, max_tail_frames + 2 s = 2.2 s


def _bypass_player(pkg, **device):
    """Two sub-mixers running EQ5 (one batched chain) on 0.1 s tones, then
    silence; the main mixer runs the master gain alone."""
    player = pkg.Player(pkg.NullOutput(SR, 2), pkg.PlayerConfig(
        block_frames=BLOCK), **device)
    for k in range(2):
        sub = player.add_mixer()
        player.play_file(_tone(pkg, 4800 + 2000 * k, 440 * (k + 1)),
                         pkg.FilePlaybackOptions(volume=0.8, repeat=0),
                         mixer=sub.mixer)
        sub.add_effect(pkg.Eq5Effect(gains=[6.0, -3.0, 4.0, 2.0, -6.0]))
    audio = np.concatenate([player.render_block()
                            for _ in range(BYPASS_BLOCKS)], axis=1)
    return audio, player


def test_auto_bypass_engages_as_in_jax():
    want, jplayer = _bypass_player(JAX)
    got, player = _bypass_player(PORT, device="cpu")
    _close(got, want)
    prog, ages = player._program, player._state["bypass"]
    batched = next(c for c, c_ in enumerate(prog.chains)
                   if len(c_["mixers"]) == 2)
    # not vacuous: stages passed their limit and are bypassed
    parked = ages[batched] >= prog.chains[batched]["limits"]
    assert parked.all()
    assert (ages[batched] < AGE_MAX).all()
    jages = jax.device_get(jplayer._state["bypass"])
    np.testing.assert_array_equal(ages[batched].numpy(), jages["__batch0"])
    main = prog._chain_of["main"]
    assert int(ages[main][0, 0]) == int(jages["main/master"])


# ---------------------------------------------------------------------------
# staggered starts on a batched chain, and a JAX state with silence ages
# ---------------------------------------------------------------------------

FREEZE_BLOCK = 8192
FREEZE_BLOCKS = 6
CARRY_AFTER = 3  # blocks the JAX state has rendered when it is carried over


def _freeze_graph(pkg):
    """The JAX package's test_batched_chains_freeze_parked_lanes graph, with
    node names: lane 1's source starts 26575 frames late."""
    m = pkg.Mixer("main")
    t = np.arange(SR // 2) / SR
    for k, start in enumerate((0, 26575)):
        sub = m.add_mixer(pkg.Mixer(f"sub{k}"))
        tone = (0.4 * np.sin(2 * np.pi * 220 * (k + 1) * t)).astype(np.float32)
        buf = pkg.AudioFileBuffer.from_array(tone[None, :], SR)
        sub.add_source(pkg.FileSource(buf, pkg.FilePlaybackOptions(
            volume=0.5, start_time=start, fade_out_secs=0.0), name="src"))
        sub.add_effect(pkg.ChorusEffect(rate=0.5 + k, depth=0.3, wet=0.4,
                                        name="chorus"))
        sub.add_effect(pkg.DelayEffect(delay_ms=80.0 + 20 * k, feedback=0.3,
                                       wet=0.4, name="delay"))
    return m


def _freeze_config(pkg, **kw):
    return pkg.EngineConfig(sample_rate=SR, block_frames=FREEZE_BLOCK,
                            auto_bypass=True, **kw)


@pytest.fixture(scope="module")
def jax_freeze():
    """The JAX render block by block, and its state after CARRY_AFTER
    blocks (one compiled step)."""
    prog = JAX.RenderProgram(_freeze_graph(JAX), _freeze_config(JAX))
    assert prog.effect_batches
    state, blocks, carried = prog.init_state(), [], None
    for b in range(FREEZE_BLOCKS):
        if b == CARRY_AFTER:
            carried = jax.device_get(state)
        state, y = prog.step_packed(state, prog.packed_block_inputs(b))
        blocks.append(np.asarray(y))
    return np.concatenate(blocks, axis=1), carried


def test_batched_lanes_freeze_while_parked(jax_freeze):
    want, _ = jax_freeze
    prog = RenderProgram(_freeze_graph(PORT), _freeze_config(PORT,
                                                             device="cpu"))
    (chain,) = [c for c in prog.chains if len(c["mixers"]) == 2]
    state = prog.init_state()
    lfo0 = state["chains"][0][0]["lfo_l"].phase.clone()
    state, _ = prog.step(state, prog.block_inputs(0))
    # the late lane's input is silent and its stages parked: its chorus
    # LFO has not moved, the early lane's has
    moved = state["chains"][0][0]["lfo_l"].phase != lfo0
    assert moved.tolist() == [True, False]
    got = prog.render(FREEZE_BLOCKS * FREEZE_BLOCK)
    _close(got, want)
    unbatched = RenderProgram(_freeze_graph(PORT), _freeze_config(
        PORT, batch_effects=False, device="cpu"))
    _close(unbatched.render(FREEZE_BLOCKS * FREEZE_BLOCK), got)


def test_state_from_jax_carries_silence_ages(jax_freeze):
    want, carried = jax_freeze
    # the early lane's stages active, the late lane's still parked
    assert {int(a) for a in np.ravel(carried["bypass"]["__batch0"])} == {
        0, AGE_MAX}
    prog = RenderProgram(_freeze_graph(PORT), _freeze_config(PORT,
                                                             device="cpu"))
    for b in range(CARRY_AFTER):  # the host lowering's own position
        prog.block_inputs(b)
    state = state_from_jax(carried, prog)
    np.testing.assert_array_equal(state["bypass"][0].numpy(),
                                  carried["bypass"]["__batch0"])
    _, y = prog.step(state, prog.block_inputs(CARRY_AFTER))
    sl = slice(CARRY_AFTER * FREEZE_BLOCK, (CARRY_AFTER + 1) * FREEZE_BLOCK)
    _close(y.numpy(), want[:, sl])


def test_state_from_jax_maps_parked_ages(jax_freeze):
    """Ages of a parked lane (still at the start sentinel) and of single-
    lane chains map onto the port's matrices."""
    prog = RenderProgram(_freeze_graph(PORT), _freeze_config(
        PORT, batch_effects=False, device="cpu"))
    jstate = {k: v for k, v in jax_freeze[1].items()}
    ages = np.array([[0, AGE_MAX + 4], [7, 9]], np.int32)
    jstate["bypass"] = {f"main/sub{k}/{e}": ages[i, k]
                        for i, e in enumerate(("chorus", "delay"))
                        for k in range(2)}
    jstate["nodes"] = dict(jstate.get("nodes", {}))
    for k in range(2):
        for i, e in enumerate(("chorus", "delay")):
            jstate["nodes"][f"main/sub{k}/{e}"] = jax.tree.map(
                lambda a: a[k], jstate["effect_batches"][0][i])
    state = state_from_jax(jstate, prog)
    got = np.stack([a.numpy()[:, 0] for a in state["bypass"]], axis=1)
    np.testing.assert_array_equal(got, ages)


# ---------------------------------------------------------------------------
# port only: packed inputs, the pump, checkpoints, the control surface
# ---------------------------------------------------------------------------


def _small_graph():
    """File sources, a sampler (a generator pool) and chains, with names."""
    m = Mixer("main")
    for k in range(2):
        sub = m.add_mixer(Mixer(f"sub{k}"))
        sub.add_source(FileSource(_tone(PORT, 9000, 200 + 90 * k),
                                  FilePlaybackOptions(volume=0.5, repeat=None),
                                  name="src"))
        sub.add_effect(Eq5Effect(gains=[3.0, -2.0, 0.0, 1.0, 2.0], name="eq"))
        sub.add_effect(ChorusEffect(rate=0.7 + k, name="chorus"))
    sampler = Sampler(_tone(PORT, 6000, 330), GeneratorPlaybackOptions(voices=4),
                      name="sampler")
    sampler.note_on(60, 0.8, time=100)
    sampler.note_on(67, 0.6, time=BLOCK + 500)
    m.add_source(sampler)
    m.add_effect(ReverbEffect(room_size=0.5, wet=0.3, min_room_size=0.45,
                              name="reverb"))
    return m, sampler


def _small_program(**kw):
    m, sampler = _small_graph()
    cfg = EngineConfig(sample_rate=SR, block_frames=BLOCK, device="cpu", **kw)
    return RenderProgram(m, cfg), sampler


def test_step_packed_equals_step():
    prog, sampler = _small_program(meter_mixers=True, auto_bypass=True)
    prog.nodes["main/reverb"].handle_message("reset", time=2 * BLOCK + 7)
    a, b = prog.init_state(), prog.init_state()
    versions = []
    for blk in range(5):
        if blk == 3:  # per-note automation lowers new arrays: a new layout
            sampler.set_note_volume(2, 0.3, time=blk * BLOCK + 100)
        inputs = prog.block_inputs(blk)
        a, (ya, la) = prog.step(a, inputs)
        b, (yb, lb) = prog.step_packed(b, prog.pack_inputs(inputs))
        versions.append(prog._pack_version)
        assert torch.equal(ya, yb) and float(ya.abs().max()) > 0.05
        assert torch.equal(la.stats, lb.stats)
        for x, y in zip(jax.tree.leaves(_plain(a)), jax.tree.leaves(_plain(b))):
            assert np.array_equal(x, y)
    assert versions == [1, 1, 1, 2, 2]


def _plain(state):
    """A state tree as nested lists of numpy arrays."""
    if isinstance(state, dict):
        return [_plain(state[k]) for k in sorted(state, key=str)]
    if isinstance(state, (list, tuple)):
        return [_plain(v) for v in state]
    return state.numpy()


def _player_rt_program():
    player = player_rt_player(block_frames=1024, device="cpu")
    return player._ensure_program()


def _synth_program():
    """synth_64v's Player at 1024-frame blocks: a synth generator and a
    bank of synth sources, the filter and pan effects."""
    return synth_player(block_frames=1024, device="cpu")._ensure_program()


def _streamed_program(tmp_path):
    """Two streamed sources in one bank, one with a speed change."""
    t = np.arange(6000) / SR
    path = tmp_path / "s.wav"
    write_wav(path, np.stack([np.sin(2 * np.pi * 300 * t)] * 2
                             ).astype(np.float32) * 0.5, SR)
    main = Mixer("main")
    for k in range(2):
        main.add_source(StreamedFileSource(str(path), FilePlaybackOptions(
            start_time=300 * k, repeat=None), name=f"s{k}"))
    prog = RenderProgram(main, EngineConfig(block_frames=1024, device="cpu",
                                            meter_mixers=True,
                                            auto_bypass=True))
    prog.set_parameter("main/s1", "SPED", 1.5, at_frame=1500)
    return prog


@pytest.mark.parametrize("make", [
    lambda tmp: _small_program(meter_mixers=True, auto_bypass=True)[0],
    lambda tmp: _player_rt_program(), lambda tmp: _synth_program(),
    _streamed_program], ids=["small", "player_rt", "synth", "streamed"])
def test_step_packed_copies_nothing_from_the_host(monkeypatch, make, tmp_path):
    """Inside ``step_packed`` no tensor is made from host data: on the card
    each such tensor is a copy that waits for the stream."""
    prog = make(tmp_path)
    state, _ = prog.step_packed(prog.init_state(), prog.packed_block_inputs(0))
    packed = prog.packed_block_inputs(1)
    made = []
    for name in ("tensor", "as_tensor", "from_numpy"):
        real = getattr(torch, name)

        def spy(data, *args, _real=real, _name=name, **kwargs):
            if not isinstance(data, torch.Tensor):
                made.append(_name)
            return _real(data, *args, **kwargs)
        monkeypatch.setattr(torch, name, spy)
    prog.step_packed(state, packed)
    assert made == []


class _Capture(NullOutput):
    def __init__(self):
        super().__init__(SR, 2)
        self.blocks = []

    def write(self, block):
        self.blocks.append(np.array(block))
        super().write(block)

    def audio(self):
        return np.concatenate(self.blocks, axis=1)


def _capture_player(depth=3):
    player = Player(_Capture(), PlayerConfig(block_frames=BLOCK,
                                             pipeline_depth=depth),
                    device="cpu")
    for k in range(2):
        sub = player.add_mixer()
        player.play_file(_tone(PORT, 9000, 200 + 90 * k),
                         FilePlaybackOptions(volume=0.5, repeat=None),
                         mixer=sub.mixer)
        sub.add_effect(ChorusEffect(rate=0.7 + k))
    return player


def test_pipelined_run_equals_serial_blocks():
    serial = _capture_player()
    want = np.concatenate([serial.render_block() for _ in range(6)], axis=1)
    for depth in (1, 3):
        player = _capture_player(depth)
        player.run(6 * BLOCK)
        np.testing.assert_array_equal(player.output.audio(), want)
        assert player.position == 6 * BLOCK


def test_split_runs_equal_one_run():
    parts = (1000, 3000, 2 * BLOCK + 100, BLOCK + 1)
    one = _capture_player()
    one.run(sum(parts))
    split = _capture_player()
    for frames in parts:
        split.run(frames)
    assert split.position == one.position == sum(parts)
    np.testing.assert_array_equal(split.output.audio(), one.output.audio())


def test_unaligned_run_tail_stays_contiguous():
    serial = _capture_player()
    want = np.concatenate([serial.render_block() for _ in range(3)], axis=1)
    player = _capture_player()
    player.run(1000)
    assert player.position == 1000
    nxt = player.render_block()
    np.testing.assert_array_equal(
        np.concatenate([player.output.audio(), nxt], axis=1),
        want[:, :1000 + BLOCK])
    assert player.position == 1000 + BLOCK


def test_run_async_drains_on_stop():
    """The background pump writes every block it rendered: after stop()
    the output holds exactly the Player's position, and the thread is
    gone."""
    player = _capture_player()
    thread = player.run_async()
    deadline = time.monotonic() + 60.0
    while player.position < 3 * BLOCK and time.monotonic() < deadline:
        time.sleep(0.01)
    player.stop()
    assert not thread.is_alive()
    assert player.position >= 3 * BLOCK
    assert player.output.audio().shape[1] == player.position


def test_nan_guard_silences_and_reports_once():
    player = Player(_Capture(), PlayerConfig(block_frames=BLOCK), device="cpu")
    bad = np.asarray(_tone(PORT, 3000, 440).data[:, :3000]).copy()
    bad[0, 100] = np.nan  # block 0 turns non-finite, block 1 does not
    player.play_file(AudioFileBuffer.from_array(bad, SR))
    panics = []
    player.set_panic_handler(panics.append)
    first, second = player.render_block(), player.render_block()
    assert np.array_equal(first, np.zeros_like(first))
    assert np.isfinite(second).all() and np.abs(second).max() > 0.1
    assert len(panics) == 1 and "non-finite" in panics[0]


def test_checkpoint_round_trip(tmp_path):
    prog, _ = _small_program(auto_bypass=True)
    state = prog.init_state()
    for b in range(2):
        state, _ = prog.step(state, prog.block_inputs(b))
    save_state(state, tmp_path / "snap.pkl", program=prog)
    _, want = prog.step(state, prog.block_inputs(2))
    again, _ = _small_program(auto_bypass=True)
    for b in range(2):
        again.block_inputs(b)
    loaded = load_state(tmp_path / "snap.pkl", program=again)
    _, got = again.step(loaded, again.block_inputs(2))
    assert torch.equal(got, want)


def test_checkpoint_mismatch_raises(tmp_path):
    prog, _ = _small_program(auto_bypass=True)
    save_state(prog.init_state(), tmp_path / "snap.pkl", program=prog)
    m, _ = _small_graph()
    m.children[0].add_effect(Eq5Effect(name="eq2"))
    other = RenderProgram(m, EngineConfig(sample_rate=SR, block_frames=BLOCK,
                                          auto_bypass=True, device="cpu"))
    with pytest.raises(CheckpointError, match="structure"):
        load_state(tmp_path / "snap.pkl", program=other)
    longer, _ = _small_program(auto_bypass=True, max_events_per_block=8)
    with pytest.raises(CheckpointError, match="engine config differs"):
        load_state(tmp_path / "snap.pkl", program=longer)


def test_pool_state_survives_a_rebuild():
    """A sampler's voices keep playing through a topology edit: the edited
    render equals the unedited one bit for bit."""
    def run(edit):
        player = Player(NullOutput(SR, 2), PlayerConfig(block_frames=BLOCK),
                        device="cpu")
        sampler = Sampler(_tone(PORT, 30000, 330),
                          GeneratorPlaybackOptions(voices=4))
        handle = player.play_generator(sampler)
        handle.note_on(60, 0.8, at=300)
        handle.note_on(64, 0.5, at=BLOCK + 20)
        out = []
        for b in range(4):
            if edit and b == 2:
                player.add_mixer().add_effect(Eq5Effect())
            out.append(player.render_block())
        return np.concatenate(out, axis=1), player

    got, player = run(True)
    want, _ = run(False)
    assert player.rebuilds == 1 and np.abs(want).max() > 0.1
    np.testing.assert_array_equal(got, want)


def test_status_events_and_contexts():
    events = []
    player = Player(NullOutput(SR, 2), PlayerConfig(block_frames=BLOCK),
                    device="cpu")
    player.status_handler = events.append
    handle = player.play_file(_tone(PORT, 3000, 440), FilePlaybackOptions(
        playback_pos_emit_rate=0.01), context="ctx")
    for _ in range(3):
        player.render_block()
    kinds = [(e.kind, e.context, e.exhausted) for e in events]
    assert kinds[0] == ("position", "ctx", False)
    assert kinds[-1] == ("stopped", "ctx", True)
    assert not handle.is_playing()


def test_source_cpu_load_probe():
    player = Player(NullOutput(SR, 2), PlayerConfig(block_frames=BLOCK),
                    device="cpu")
    probed = player.play_file(_tone(PORT, 9000, 440), FilePlaybackOptions(
        measure_cpu_load=True))
    plain = player.play_file(_tone(PORT, 9000, 220))
    sampler = Sampler(_tone(PORT, 6000, 330), GeneratorPlaybackOptions(
        voices=2, measure_cpu_load=True))
    gen = player.play_generator(sampler)
    gen.note_on(60, at=0)
    player.render_block()
    for handle in (probed, gen):
        load = handle.cpu_load()
        assert 0.0 < load.average <= load.peak
    assert plain.cpu_load() is None


def test_player_levels_and_master_volume():
    player = _capture_player()
    player.set_volume(0.5)
    audio = player.render_block()
    level = player.audio_level()
    np.testing.assert_allclose(level.peak, np.abs(audio).max(axis=-1))
    main = player.mixer_audio_level(player.main_mixer)
    assert main.peak.shape == (2,) and np.all(main.rms > 0)
    assert np.all(level.peak_db() < 0.0)


def test_deferred_surfaces_raise():
    """Synth and streamed playback play now (tests/test_torch_synth.py and
    tests/test_torch_streamed.py hold them against the JAX package); a
    Generator subclass the package has no renderer for still raises."""
    player = Player(NullOutput(SR, 2), device="cpu")
    assert isinstance(player.play_synth(synths.dx7()), PlaybackHandle)
    assert isinstance(player.play_file(_tone(PORT, 100, 440), stream=True),
                      PlaybackHandle)

    class Synth(Generator):
        pass

    with pytest.raises(NotImplementedError, match="no renderer"):
        player.add_generator(Synth())


def test_render_refuses_meter_mixers():
    prog, _ = _small_program(meter_mixers=True)
    with pytest.raises(ValueError, match="meter_mixers"):
        prog.render(BLOCK)


def test_player_needs_a_card():
    """The Player targets the card by default and never falls back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; chip_smoke.py covers this path")
    with pytest.raises(RuntimeError, match="cuda"):
        Player(NullOutput(SR, 2))
    with pytest.raises(RuntimeError, match="cuda"):
        player_rt_player()


def test_player_rt_graph():
    """player_rt_player builds bench.py's config_player_rt: 16 sources on
    4 sub-mixers with EQ5 and chorus (one batched chain), a reverb before
    the master gain; endless sources, so no retirement."""
    player = player_rt_player(block_frames=1024, device="cpu")
    audio = player.render_block()
    prog = player._program
    assert len(prog.source_paths) == 16 and len(prog.file_batches) == 1
    assert sorted(len(c["mixers"]) for c in prog.chains) == [1, 4]
    assert [type(e).__name__ for e in player.main_mixer.effects] == [
        "ReverbEffect", "GainEffect"]
    assert prog.natural_duration_frames() is None
    assert np.isfinite(audio).all() and np.abs(audio).max() > 0.05
    assert len(player._mixer_levels) == 5

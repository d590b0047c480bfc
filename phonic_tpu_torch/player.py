"""Player: the control-plane facade (port of ``phonic_tpu/player.py``).

Behavioural spec: reference src/player.rs — builds wrapper chains per played
source, owns the main mixer + registries, returns handles for all live
mutation (src/player/handles/*), publishes playback status and metering,
and never touches samples on the control thread.

The Player owns a Mixer tree and builds a RenderProgram from it lazily
(rebuilding only on *topology* edits — parameter changes, note events,
stops and seeks are data, not topology; a rebuild adopts the old program's
state, so unrelated sources play on).  A render pump steps blocks on the
program's device and pushes them into any OutputDevice; handles schedule
sample-accurate control through the engine's timelines.  Metering
(peak/RMS, reference src/source/metered.rs) and CPU load
(processing-time / audio-time, reference src/source/measured.rs) are
tracked per pumped block.

The pump is pipelined on the card: dispatching a block lowers its inputs,
copies them to the device in one asynchronous copy
(``RenderProgram.step_packed``), queues the step and the copies of its
audio and levels back into pinned host buffers, and records an event;
finishing it waits on that event alone.  So with ``pipeline_depth`` D the
host lowers block k+D while the card renders block k.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Optional, Union

import numpy as np
import torch

from . import tracing
from .config import EngineConfig, resolve_device
from .effects.gain import GainEffect
from .errors import NotFoundError, ParameterError, PhonicError
from .generators.base import Generator
from .graph.batching import FileBatch, LeafBatch
from .graph.engine import SOURCE_TYPES, RenderProgram, bank_inputs, tree_map
from .graph.mixer import Mixer
from .graph.nodes import Effect
from .io.decoder import AudioFileBuffer
from .ops.convert import linear_to_db
from .outputs.base import OutputDevice
from .sources.file import NEVER, FilePlaybackOptions, FileSource
from .sources.streamed import StreamedFileSource
from .sources.synth import SynthDef, SynthPlaybackOptions, SynthSource



@dataclasses.dataclass
class PlayerConfig:
    """reference: src/player.rs:127-226."""

    enforce_stereo_playback: bool = True
    block_frames: int = 8192
    max_events_per_block: int = 16
    metering_interval_secs: float = 0.05
    measure_cpu_load: bool = True
    # transient-source retirement (reference: exhausted sources are dropped
    # every block, src/source/mixed.rs:714-715 + playing-map GC,
    # src/player.rs:1135-1176).  Here a retirement is a topology rebuild,
    # so exhausted sources are pruned lazily in batches: masked zeros until
    # >= retire_after_dead_sources of them are dead, then one rebuild
    # removes them all (adopt() carries every surviving state).
    auto_retire_sources: bool = True
    retire_after_dead_sources: int = 8
    # offline/throughput pump (run()/run_async): how many blocks may be
    # dispatched ahead of the one being materialized.  Dispatch only queues
    # work on the card, so depth D overlaps the host's lowering of the next
    # blocks with the device's render and device-to-host copy of earlier
    # ones.  Control->audible latency grows by one block per extra depth;
    # interactive callers that pump via render_block() are unaffected.
    pipeline_depth: int = 3


@dataclasses.dataclass
class PlaybackStatusEvent:
    """reference: src/source/status.rs — Position while playing, Stopped on
    exhaustion/stop."""

    kind: str  # "position" | "stopped"
    source: object  # the source node
    position: int = 0  # output frames into the source's playback
    exhausted: bool = False
    # opaque user context passed along when starting playback (reference:
    # PlaybackStatusContext, src/source/status.rs:9-36)
    context: object = None


@dataclasses.dataclass
class CpuLoad:
    """processing_time / rendered_audio_time (reference:
    src/source/measured.rs:13-19)."""

    average: float = 0.0
    peak: float = 0.0


@dataclasses.dataclass
class AudioLevel:
    peak: np.ndarray = None  # per channel
    rms: np.ndarray = None

    def peak_db(self) -> np.ndarray:
        return np.asarray([float(linear_to_db(p)) for p in self.peak])

    def rms_db(self) -> np.ndarray:
        return np.asarray([float(linear_to_db(r)) for r in self.rms])


class _Handle:
    def __init__(self, player: "Player", node):
        self._player = player
        self._node = node

    @property
    def id(self) -> int:
        """Stable numeric id of this playback/effect (reference:
        PlaybackId/EffectId, src/player/handles/*.rs `id()`)."""
        return self._player._id_for(self._node)

    def set_parameter(self, pid: str, value, at: Optional[int] = None):
        """Schedule a parameter change (sample-accurate).  ``at`` defaults to
        'now' (the current playback position)."""
        self._player._set_parameter(self._node, pid, value, at)

    def set_parameters(self, values: dict, at: Optional[int] = None):
        for pid, v in values.items():
            self.set_parameter(pid, v, at)

    def set_parameter_normalized(self, pid: str, normalized: float,
                                 at: Optional[int] = None):
        """Normalized 0..1 update through the parameter's scaling
        (reference: ParameterValueUpdate::Normalized)."""
        self._player._set_parameter_normalized(self._node, pid, normalized, at)

    def send_message(self, message, at: Optional[int] = None):
        """Deliver a node-specific message (reference: send_message on the
        effect/generator handles); applies at the block containing ``at``
        (default: the current playback position)."""
        with self._player._control_lock:
            self._node.handle_message(message, time=self._player._when(at))


class _ContextMixin:
    """Opaque status-event context, settable after play (reference:
    FileSource::playback_status_context / set_playback_status_context,
    src/source/file.rs:254-256)."""

    def playback_status_context(self):
        return self._player._contexts.get(self._node)

    def set_playback_status_context(self, context):
        with self._player._control_lock:
            if context is None:
                self._player._contexts.pop(self._node, None)
            else:
                self._player._contexts[self._node] = context


class PlaybackHandle(_Handle, _ContextMixin):
    """File/synth playback control (reference: src/player/handles/file.rs)."""

    def stop(self, at: Optional[int] = None):
        self._player._stop_source(self._node, at, kill=False)

    def kill(self, at: Optional[int] = None):
        self._player._stop_source(self._node, at, kill=True)

    def set_volume(self, volume: float, at: Optional[int] = None):
        self.set_parameter("VOLU", volume, at)

    def set_panning(self, panning: float, at: Optional[int] = None):
        self.set_parameter("PANN", panning, at)

    def set_speed(self, speed: float, glide: Optional[float] = None,
                  at: Optional[int] = None):
        """Set playback speed; with ``glide`` (semitones/second) the speed
        ramps toward the target like the reference's glided set_speed
        (src/player/handles/file.rs:150-176)."""
        if glide is None or glide <= 0.0:
            self.set_parameter("SPED", speed, at)
        else:
            self._player._set_parameter_glide(self._node, "SPED", speed, glide, at)

    def seek(self, to_source_frame: float, at: Optional[int] = None):
        """Seek a file source (reference: FilePlaybackHandle::seek)."""
        with self._player._control_lock:
            self._node.seek(self._player._when(at), to_source_frame)

    def is_playing(self) -> bool:
        return self._player._is_playing(self._node)

    def cpu_load(self) -> Optional["CpuLoad"]:
        """Per-source CPU-load probe; None unless played with
        measure_cpu_load=True (reference: FilePlaybackHandle::cpu_load,
        src/player/handles/file.rs:70-74)."""
        return self._player.source_cpu_load(self._node)


class GeneratorPlaybackHandle(_Handle, _ContextMixin):
    """reference: src/player/handles/generator.rs:200-460."""

    def note_on(self, note: int, volume: float = 1.0, panning: float = 0.0,
                at: Optional[int] = None, context=None) -> int:
        """With ``context``, the note's opaque context is recorded and
        retrievable via ``note_context`` (reference: note_on_with_context,
        src/player/handles/generator.rs:212-240 — there it rides the per-
        voice status channel; here generators emit one status stream, so
        per-note contexts are exposed by lookup instead)."""
        with self._player._control_lock:
            note_id = self._node.note_on(note, volume, panning,
                                         self._player._when(at))
            if context is not None:
                ncs = self._player._note_contexts
                ncs[(id(self._node), note_id)] = context
                while len(ncs) > 4096:  # notes end device-side; stay bounded
                    ncs.pop(next(iter(ncs)))
            return note_id

    def note_context(self, note_id: int):
        """The context passed to ``note_on(..., context=...)``, if any."""
        return self._player._note_contexts.get((id(self._node), note_id))

    def note_off(self, note_id: int, at: Optional[int] = None):
        with self._player._control_lock:
            self._node.note_off(note_id, self._player._when(at))

    def all_notes_off(self, at: Optional[int] = None):
        with self._player._control_lock:
            self._node.all_notes_off(self._player._when(at))

    def set_note_volume(self, note_id: int, volume: float,
                        at: Optional[int] = None):
        """Per-note volume (reference: generator.rs set_note_volume)."""
        self._node.set_note_volume(note_id, volume, self._player._when(at))

    def set_note_panning(self, note_id: int, panning: float,
                         at: Optional[int] = None):
        self._node.set_note_panning(note_id, panning, self._player._when(at))

    def set_note_speed(self, note_id: int, speed: float,
                       glide: Optional[float] = None,
                       at: Optional[int] = None):
        """Per-note speed; with ``glide`` ramps at semitones/second
        (reference: GeneratorPlaybackEvent::SetSpeed)."""
        self._node.set_note_speed(note_id, speed, glide,
                                  self._player._when(at))

    def set_modulation(self, source: str, target: str, amount: float,
                       bipolar: bool = True):
        self._node.set_modulation(source, target, amount, bipolar)

    def clear_modulation(self, source: str, target: str):
        self._node.clear_modulation(source, target)

    def cpu_load(self) -> Optional["CpuLoad"]:
        """Per-generator CPU-load probe; None unless played with
        measure_cpu_load=True (reference:
        src/player/handles/generator.rs:75-79)."""
        return self._player.source_cpu_load(self._node)


class EffectHandle(_Handle):
    @property
    def effect_name(self) -> str:
        """The effect's display name (reference:
        EffectHandle::effect_name, src/player/handles/effect.rs:57-60)."""
        return getattr(self._node, "name", type(self._node).__name__)

    @property
    def mixer_id(self) -> int:
        """Id of the mixer this effect runs on (reference:
        EffectHandle::mixer_id, src/player/handles/effect.rs:52-55)."""
        parent = self._player.main_mixer.find_parent_of(self._node)
        return self._player._id_for(parent if parent is not None else
                                    self._player.main_mixer)


class MixerHandle:
    """reference: src/player/handles/mixer.rs — observability probes."""

    def __init__(self, player: "Player", mixer: Mixer):
        self._player = player
        self.mixer = mixer

    @property
    def id(self) -> int:
        """Stable numeric id (reference: MixerHandle::id,
        src/player/handles/mixer.rs:37-40)."""
        return self._player._id_for(self.mixer)

    def add_effect(self, effect: Effect, index=None) -> EffectHandle:
        return self._player.add_effect(effect, mixer=self.mixer, index=index)

    def add_mixer(self) -> "MixerHandle":
        return self._player.add_mixer(parent=self.mixer)

    def remove_source(self, source_or_handle):
        self._player.remove_source(source_or_handle)

    def remove_mixer(self, mixer_or_handle):
        self._player.remove_mixer(mixer_or_handle)

    def remove(self):
        """Detach this mixer (and its subtree) from the graph."""
        self._player.remove_mixer(self.mixer)

    def cpu_load(self) -> CpuLoad:
        return self._player.cpu_load()

    def cpu_load_state(self):
        """Pollable CpuLoad accessor (reference: MixerHandle::cpu_load_state,
        src/player/handles/mixer.rs:55-59)."""
        return lambda: self._player.cpu_load()

    def audio_level(self) -> AudioLevel:
        return self._player.mixer_audio_level(self.mixer)

    def audio_level_state(self):
        """Pollable AudioLevel accessor (reference:
        MixerHandle::audio_level_state, src/player/handles/mixer.rs:72-76)."""
        return lambda: self._player.mixer_audio_level(self.mixer)


class Player:
    def __init__(self, output: OutputDevice,
                 config: Optional[PlayerConfig] = None,
                 device: Optional[Union[str, torch.device]] = None):
        """Renders on the CUDA card unless ``device`` says otherwise; raises
        without a card."""
        self.output = output
        self.config = config or PlayerConfig()
        self.device = resolve_device("cuda" if device is None else device)
        channels = 2 if self.config.enforce_stereo_playback else output.channel_count
        self.engine_config = EngineConfig(
            sample_rate=output.sample_rate,
            channels=channels,
            block_frames=self.config.block_frames,
            max_events_per_block=self.config.max_events_per_block,
            meter_mixers=True,
            auto_bypass=True,
            device=self.device,
        )
        self.main_mixer = Mixer("main")
        # master gain (the analog of the player's smoothed master volume,
        # reference src/output/cpal.rs:717)
        self._master = self.main_mixer.add_effect(GainEffect(name="master"))
        self._program: Optional[RenderProgram] = None
        self._state = None
        self._position = 0
        # rendered-but-unwritten audio left over from a non-block-aligned
        # run(): the engine renders whole blocks (so _position stays
        # block-aligned and the state/lowering never desync); the Player
        # edge serves this tail before rendering anything new — the analog
        # of the reference's pull-any-amount MixedSource::write loop
        self._tail: Optional[np.ndarray] = None
        self._pending: list = []  # deferred control ops before the first build
        self.rebuilds = 0  # topology rebuilds that adopted a running state
        self._carry = None  # (program, state) stashed across topology edits
        self._cpu = CpuLoad()
        self._level = AudioLevel(np.zeros(channels), np.zeros(channels))
        self._pump_thread: Optional[threading.Thread] = None
        self._pump_stop = threading.Event()
        # Control plane vs render pump: the reference decouples them with
        # lock-free queues drained at block boundaries (src/source/mixed.rs:
        # 233-234); here a single reentrant lock serializes control
        # mutations against the block step — worst-case control latency is
        # one block render, the same bound the reference's queues give.
        self._control_lock = threading.RLock()
        self._cpu_alpha = 0.2
        # GuardedSource analog (reference: src/source/guarded.rs): a
        # non-finite master block is replaced by silence and reported once
        self.panic_handler = None
        self._panicked = False
        self._mixer_levels: dict = {}
        # playback status events (reference: status proxy thread,
        # src/player.rs:1135-1176) — delivered per pumped block
        self.status_handler = None
        self._live_sources: set = set()
        self._last_pos_emit: dict = {}  # path -> output frame of last Position
        # opaque user contexts echoed in status events (reference:
        # PlaybackStatusContext, src/source/status.rs:9-36)
        self._contexts: dict = {}  # node -> context
        self._note_contexts: dict = {}  # (id(generator), note_id) -> context
        # sources with a play_* lifecycle (eligible for auto-retirement);
        # generators added via play_generator live until removed explicitly
        self._transient: set = set()
        # stable numeric ids for handles (reference: PlaybackId/EffectId/
        # MixerId are monotonic usizes, src/source/playback.rs).  Stored on
        # the node itself (not a dict keyed by id(node), which could collide
        # once a dead node's address is reused).
        self._next_id = 1

    def _id_for(self, node) -> int:
        with self._control_lock:
            got = getattr(node, "_phonic_stable_id", None)
            if got is None:
                got = self._next_id
                self._next_id += 1
                node._phonic_stable_id = got
            return got

    # ------------------------------------------------------------------
    # graph building (topology edits invalidate the program)
    # ------------------------------------------------------------------

    def _invalidate(self):
        with self._control_lock:
            if self._program is not None:
                # stash the old program + state: the next _ensure_program
                # adopts timelines, schedules and node states so unrelated
                # sources keep playing through topology edits
                # (reference: src/player.rs)
                self._carry = (self._program, self._state)
                self._program = None
                self._state = None

    def add_mixer(self, parent: Optional[Mixer] = None) -> MixerHandle:
        m = (parent or self.main_mixer).add_mixer()
        self._invalidate()
        return MixerHandle(self, m)

    def add_effect(self, effect: Effect, mixer: Optional[Mixer] = None,
                   index=None) -> EffectHandle:
        target = mixer or self.main_mixer
        # keep the master gain last on the main bus
        if target is self.main_mixer and index is None:
            target.add_effect(effect, index=len(target.effects) - 1)
        else:
            target.add_effect(effect, index)
        self._invalidate()
        return EffectHandle(self, effect)

    def move_effect(self, effect: Effect, movement,
                    mixer: Optional[Mixer] = None):
        """Reorder an effect within its mixer's chain (reference:
        EffectMovement, src/player.rs:75-82).  ``movement`` is an absolute
        index, "start", "end", or ("by", delta) for a relative shift."""
        target = mixer or self.main_mixer
        if effect not in target.effects:
            raise NotFoundError(
                f"effect {effect.name!r} is not on mixer {target.name!r}")
        cur = target.effects.index(effect)
        if movement == "start":
            idx = 0
        elif movement == "end":
            idx = len(target.effects) - 1
        elif isinstance(movement, tuple) and len(movement) == 2 \
                and movement[0] == "by":
            idx = max(min(cur + int(movement[1]),
                          len(target.effects) - 1), 0)
        else:
            idx = int(movement)
        target.move_effect(effect, idx)
        self._invalidate()

    def remove_effect(self, effect: Effect, mixer: Optional[Mixer] = None):
        (mixer or self.main_mixer).remove_effect(effect)
        self._invalidate()

    def remove_source(self, source_or_handle):
        """Detach a playing source/generator from the graph (reference:
        MixerMessage::RemoveSource, src/source/mixed.rs:47-194).  Unrelated
        sources keep playing through the rebuild (adopt()); further handle
        calls on the removed source raise NotFoundError, like the
        reference's Err on a dropped source."""
        node = getattr(source_or_handle, "_node", source_or_handle)
        with self._control_lock:
            self._remove_source_locked(node)

    def remove_generator(self, generator_or_handle):
        """Remove a generator added via add_generator/play_generator without
        stopping its voices first (reference: Player::remove_generator,
        src/player.rs:747-772 — a RemoveSource on the generator's playback)."""
        self.remove_source(generator_or_handle)

    def _remove_source_locked(self, node, emit: bool = True):
        parent = self.main_mixer.find_parent_of(node)
        if parent is None:
            raise NotFoundError(
                f"source {getattr(node, 'name', node)!r} not in graph")
        if self._program is not None:
            try:
                path = self._program._resolve(node)
                self._last_pos_emit.pop(path, None)
            except NotFoundError:
                pass
        parent.remove_source(node)
        self._transient.discard(node)
        self._pending = [(n, fn) for n, fn in self._pending if n is not node]
        if node in self._live_sources:
            self._live_sources.discard(node)
            if emit and self.status_handler is not None:
                self.status_handler(PlaybackStatusEvent(
                    "stopped", node, exhausted=False,
                    context=self._contexts.get(node)))
        self._contexts.pop(node, None)
        self._note_contexts = {k: v for k, v in self._note_contexts.items()
                               if k[0] != id(node)}
        self._invalidate()

    def remove_mixer(self, mixer_or_handle):
        """Detach a sub-mixer and its whole subtree (reference:
        MixerMessage::RemoveMixer, src/source/mixed.rs:47-194)."""
        mixer = getattr(mixer_or_handle, "mixer", mixer_or_handle)
        with self._control_lock:
            if mixer is self.main_mixer:
                raise PhonicError("cannot remove the main mixer")
            parent = self.main_mixer.find_parent_of(mixer)
            if parent is None:
                raise NotFoundError(f"mixer {mixer.name!r} not in graph")
            # the subtree's sources die with it: emit their Stopped events
            # and drop their bookkeeping
            for _path, kind, obj in mixer.walk():
                if kind != "source":
                    continue
                self._transient.discard(obj)
                self._pending = [(n, fn) for n, fn in self._pending
                                 if n is not obj]
                if obj in self._live_sources:
                    self._live_sources.discard(obj)
                    if self.status_handler is not None:
                        self.status_handler(PlaybackStatusEvent(
                            "stopped", obj, exhausted=False,
                            context=self._contexts.get(obj)))
                self._contexts.pop(obj, None)
                self._note_contexts = {
                    k: v for k, v in self._note_contexts.items()
                    if k[0] != id(obj)}
            removed = {id(obj) for _p, k, obj in mixer.walk() if k == "source"}
            if self._program is not None:
                self._last_pos_emit = {
                    p: f for p, f in self._last_pos_emit.items()
                    if id(self._program.nodes.get(p)) not in removed
                }
            parent.remove_mixer(mixer)
            self._invalidate()

    def remove_all_mixers(self, parent: Optional[Mixer] = None):
        """Remove every direct sub-mixer of ``parent`` (default: main) and
        their subtrees (reference: Player::remove_all_mixers,
        src/player.rs:871-886)."""
        target = parent or self.main_mixer
        with self._control_lock:
            for child in list(target.children):
                self.remove_mixer(child)

    def remove_all_effects(self, mixer: Optional[Mixer] = None):
        """Remove every effect on ``mixer`` (default: main) (reference:
        Player::remove_all_effects, src/player.rs:994-1009).  The Player's
        internal master-gain stage is engine plumbing, not a user effect,
        and stays."""
        target = mixer or self.main_mixer
        with self._control_lock:
            for e in list(target.effects):
                if e is self._master:
                    continue
                target.remove_effect(e)
            self._invalidate()

    def stop_all_sources(self):
        """Immediately stop all playing transient sources and drop every
        scheduled event (reference: Player::stop_all_sources,
        src/player.rs:1012-1045 — stop messages to transient sources +
        RemoveAllPendingEvents force-pushed to every mixer)."""
        with self._control_lock:
            self.remove_all_pending_events()
            for node in list(self._transient):
                if self.main_mixer.find_parent_of(node) is None:
                    self._transient.discard(node)
                    continue
                self._stop_source(node, at=None)

    def is_running(self) -> bool:
        """Output playback running (reference: Player::is_running)."""
        return self.output.is_running()

    def start(self):
        """Resume output playback (reference: Player::start)."""
        self.output.resume()

    def pause(self):
        """Pause output playback without dropping sources (the reference's
        Player::stop, src/player.rs:506-509; this Player's ``stop()`` ends
        the async pump instead)."""
        self.output.pause()

    def _retire_exhausted_locked(self):
        """Prune exhausted transient sources in batches (reference retires
        them every block, src/source/mixed.rs:714-715; here each prune is a
        rebuild, so dead sources render masked zeros until the batch
        threshold, then one rebuild drops them all)."""
        if not self.config.auto_retire_sources or not self._transient:
            return
        dead = []
        for node in list(self._transient):
            if self.main_mixer.find_parent_of(node) is None:
                self._transient.discard(node)
                continue
            try:
                if not self._is_playing(node):
                    dead.append(node)
            except NotFoundError:
                self._transient.discard(node)
        if len(dead) < max(self.config.retire_after_dead_sources, 1):
            return
        for node in dead:
            self._remove_source_locked(node, emit=False)

    def play_file(self, file: Union[str, AudioFileBuffer],
                  options: Optional[FilePlaybackOptions] = None,
                  mixer: Optional[Mixer] = None,
                  stream: bool = False,
                  context=None) -> PlaybackHandle:
        """``stream=True`` plays via the O(window)-memory streamed source
        (reference: FilePlaybackOptions::streamed, src/source/file.rs:96).
        A path + stream=True never fully decodes: the source reads through
        the chunked incremental decoder (io/chunked.py).  ``context`` is an
        opaque value echoed in this source's status events (reference:
        play_file_with_context, src/source/file.rs:282-297)."""
        if stream:
            src = StreamedFileSource(file, options)
        else:
            buf = (file if isinstance(file, AudioFileBuffer)
                   else AudioFileBuffer.from_file(file))
            src = FileSource(buf, options)
        return self._play_source(src, mixer, context)

    def play_synth(self, synth: SynthDef,
                   options: Optional[SynthPlaybackOptions] = None,
                   mixer: Optional[Mixer] = None,
                   context=None) -> PlaybackHandle:
        """``context``: see play_file (reference:
        play_synth_source_with_context, src/source/synth.rs)."""
        return self._play_source(SynthSource(synth, options), mixer, context)

    def _play_source(self, src, mixer, context) -> PlaybackHandle:
        (mixer or self.main_mixer).add_source(src)
        self._transient.add(src)
        if context is not None:
            self._contexts[src] = context
        self._invalidate()
        return PlaybackHandle(self, src)

    def play_generator(self, generator: Generator,
                       mixer: Optional[Mixer] = None,
                       context=None) -> GeneratorPlaybackHandle:
        """Samplers, synth generators and the empty generator play; another
        Generator subclass has no renderer in this package and raises."""
        if type(generator) not in SOURCE_TYPES:
            raise NotImplementedError(
                f"{type(generator).__name__} generators have no renderer in "
                "this package")
        (mixer or self.main_mixer).add_source(generator)
        if context is not None:
            self._contexts[generator] = context
        self._invalidate()
        return GeneratorPlaybackHandle(self, generator)

    add_generator = play_generator  # fixed lifecycle differs only in stop semantics

    # ------------------------------------------------------------------
    # control plane
    # ------------------------------------------------------------------

    def _ensure_program(self) -> RenderProgram:
        if self._program is None:
            self._program = RenderProgram(self.main_mixer, self.engine_config,
                                          device=self.device)
            if self._carry is not None:
                old_prog, old_state = self._carry
                self._state = self._program.adopt(old_prog, old_state)
                self._carry = None
                self.rebuilds += 1
            else:
                self._state = self._program.init_state()
            for _node, op in self._pending:
                op(self._program)
            self._pending.clear()
        return self._program

    def _when(self, at: Optional[int]) -> int:
        return self._position if at is None else int(at)

    def _set_parameter(self, node, pid, value, at):
        with self._control_lock:
            when = self._when(at)
            if self._program is None:
                self._pending.append(
                    (node, lambda p: p.set_parameter(node, pid, value, when)))
            else:
                self._program.set_parameter(node, pid, value, when)

    def _set_parameter_normalized(self, node, pid, normalized, at):
        with self._control_lock:
            when = self._when(at)
            if self._program is None:
                self._pending.append(
                    (node,
                     lambda p: p.set_parameter_normalized(node, pid, normalized, when)))
            else:
                self._program.set_parameter_normalized(node, pid, normalized, when)

    def remove_all_pending_events(self, at: Optional[int] = None):
        """Clear every scheduled parameter/stop event at or after ``at``
        (reference: MixerMessage::RemoveAllPendingEvents)."""
        with self._control_lock:
            when = self._when(at)
            if self._program is None:
                self._pending.append(
                    (None, lambda p: p.remove_pending_events(None, when)))
            else:
                self._program.remove_pending_events(None, when)

    def _set_parameter_glide(self, node, pid, value, rate, at):
        with self._control_lock:
            when = self._when(at)
            if self._program is None:
                self._pending.append(
                    (node,
                     lambda p: p.set_parameter_glide(node, pid, value, rate, when)))
            else:
                self._program.set_parameter_glide(node, pid, value, rate, when)

    def _stop_source(self, node, at, kill=False):
        with self._control_lock:
            when = self._when(at)
            if self._program is None:
                self._pending.append(
                    (node, lambda p: p.stop_source(node, when, kill=kill)))
            else:
                self._program.stop_source(node, when, kill=kill)

    def _is_playing(self, node) -> bool:
        if self.main_mixer.find_parent_of(node) is None:
            return False  # removed/retired sources report stopped
        prog = self._ensure_program()
        d = node.duration_frames(prog.ctx)
        path = prog._resolve(node)
        stop = prog.stop_frames.get(path, NEVER)
        kill = prog.kill_frames.get(path, NEVER)
        if stop != NEVER:
            # a scheduled stop plays through the source's fade-out
            # (reference: FilePlaybackHandle::stop fades, then exhausts)
            opts = getattr(node, "options", None)
            fade = getattr(opts, "fade_out_secs", 0.05) if opts else 0.05
            stop += int(fade * prog.ctx.sample_rate) + 1
        limit = min(x for x in (d, stop if stop != NEVER else None,
                                kill if kill != NEVER else None, NEVER)
                    if x is not None)
        return self._position < limit

    @property
    def volume(self) -> float:
        return self._master.gain

    def set_volume(self, volume: float, at: Optional[int] = None):
        self._set_parameter(self._master, "GAIN", volume, at)

    # -- output-device introspection (reference: src/player.rs:407-441) --

    @property
    def output_sample_rate(self) -> int:
        """The output device's sample rate (player.rs:412-414)."""
        return self.output.sample_rate

    @property
    def output_channel_count(self) -> int:
        """Main-mixer channel count: 2 under enforce_stereo_playback, else
        the device's (player.rs:416-422)."""
        return 2 if self.config.enforce_stereo_playback else self.output.channel_count

    @property
    def output_sample_frame_position(self) -> int:
        """The device's actual playhead in sample frames — may lag
        `position` by the device buffer (player.rs:425-432)."""
        return self.output.sample_position

    @property
    def output_suspended(self) -> bool:
        """True while the output device is paused/suspended
        (player.rs:407-409)."""
        return not self.output.is_running()

    @property
    def output_volume(self) -> float:
        """The device-edge global volume factor (player.rs:435-437)."""
        return self.output.volume

    def set_output_volume(self, volume: float):
        """Set the device-edge global volume (smoothed at the device
        boundary; player.rs:439-441 + cpal.rs:717-720)."""
        if volume < 0.0:
            raise ParameterError("output volume must be >= 0")
        self.output.set_volume(volume)

    @property
    def position(self) -> int:
        """Output frames delivered so far (the device's own playhead may lag;
        see OutputDevice.sample_position).  The engine itself always renders
        whole blocks; frames rendered past a non-aligned run() end sit in a
        tail buffer and are not counted until written."""
        tail = 0 if self._tail is None else self._tail.shape[1]
        return self._position - tail

    def cpu_load(self) -> CpuLoad:
        return self._cpu

    def cpu_load_state(self):
        """A zero-arg callable returning the latest CpuLoad — the analog of
        the reference's lock-free SharedCpuLoadState handle that can be
        polled from UI threads without going through the Player
        (player.rs:457-461)."""
        return lambda: self._cpu

    def audio_level_state(self):
        """A zero-arg callable returning the latest master AudioLevel
        (reference: Player::audio_level_state, player.rs:474-478)."""
        return lambda: self._level

    def set_panic_handler(self, handler) -> None:
        """Install (or clear, with None) the callback invoked once when the
        NaN guard trips (reference: Player::set_panic_handler,
        player.rs:487-489)."""
        self.panic_handler = handler

    def source_cpu_load(self, node, iters: int = 8) -> Optional[CpuLoad]:
        """Per-source CPU-load probe (reference: MeasuredSource wall-clock
        probes around the inner write, src/source/measured.rs:90-104 +
        the measure_cpu_load play option, src/source/file.rs:85).

        A block step renders every source of a bank or pool in one batched
        call, so one source's time cannot be read off it.  The probe renders
        the source alone, as a one-lane bank (a file source) or a pool of
        it (a sampler), with its current parameter values and state, and
        times that on the program's device (CUDA events on the card).
        Returns None unless the source was played with
        measure_cpu_load=True."""
        prog = self._ensure_program()
        path = prog._resolve(node)
        node = prog.nodes[path]
        if not getattr(getattr(node, "options", None), "measure_cpu_load",
                       False):
            return None
        ctx, dev = prog.ctx, prog.device
        n = ctx.block_frames
        pos = self._position
        # the probe's bank or pool holds the source's buffer on the device:
        # built once per program and source
        if not hasattr(prog, "_cpu_probe_cache"):
            prog._cpu_probe_cache = {}
        unit = prog._cpu_probe_cache.get(path)
        if unit is None:
            unit = (FileBatch([node], [path], ctx) if isinstance(node, FileSource)
                    else LeafBatch([node], [path], ctx))
            prog._cpu_probe_cache[path] = unit
        values = {p.id: torch.full(
            (1, n), float(prog.timelines[(path, p.id)].value_at(pos)),
            dtype=torch.float32, device=dev) for p in node.PARAMS}
        groups, loc = ((prog._bank_lane, "file_batches")
                       if isinstance(unit, FileBatch)
                       else (prog._pool_lane, "pools"))
        if self._state is not None and path in groups:
            g, lane = groups[path]
            st = tree_map(lambda a: a[lane:lane + 1], self._state[loc][g])
        else:
            st = unit.init_state()
        if isinstance(unit, FileBatch):
            def frames(v):
                return torch.full((1,), min(v, NEVER), dtype=torch.int64,
                                  device=dev)
            extra = node.lower_block_inputs(pos, n)
            args = (frames(prog.stop_frames[path]),
                    frames(prog.kill_frames[path]),
                    torch.full((1,), float(extra["_seek_flag"]), device=dev),
                    torch.full((1,), float(extra["_seek_pos"]), device=dev))

            def fn():
                return unit.render(st, pos, values["VOLU"], values["PANN"],
                                   values["SPED"], *args)
        else:
            flat, layout, smax, live = unit.stack([bank_inputs(
                node, node.lower_block_inputs(pos, n),
                prog.stop_frames[path], prog.kill_frames[path])])
            voices = unit.voices(None if flat is None else
                                 torch.as_tensor(flat, device=dev), layout)

            def fn():
                return unit.render(st, values, voices, smax, live, pos)
        fn()  # warm-up
        block_secs = n / ctx.sample_rate
        times = []
        for _ in range(max(iters, 1)):
            if dev.type == "cuda":
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn()
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end) / 1e3)
            else:
                t0 = time.perf_counter()
                fn()
                times.append(time.perf_counter() - t0)
        return CpuLoad(average=sum(times) / len(times) / block_secs,
                       peak=max(times) / block_secs)

    def audio_level(self) -> AudioLevel:
        return self._level

    def mixer_audio_level(self, mixer: Mixer) -> AudioLevel:
        """Per-mixer peak/RMS (reference: MixerHandle::audio_level)."""
        for path, kind, obj in self.main_mixer.walk():
            if obj is mixer:
                return self._mixer_levels.get(path, self._level)
        raise NotFoundError(f"mixer {mixer.name!r} not in graph")

    # ------------------------------------------------------------------
    # transport: the render pump
    # ------------------------------------------------------------------

    def render_block(self) -> np.ndarray:
        """Render exactly one block, updating metrics, and advance time.
        Thread-safe against the control-plane methods (see _control_lock)."""
        with self._control_lock:
            return self._render_block_locked()

    def _render_block_locked(self) -> np.ndarray:
        audio = self._finish_block_locked(self._dispatch_block_locked())
        if self._tail is not None and self._tail.shape[1]:
            # a previous non-aligned run() left delivered-position behind the
            # engine: return the stream-contiguous window (tail + head of the
            # fresh block) and keep the remainder as the new tail
            audio = np.concatenate([self._tail, audio], axis=1)
            n = audio.shape[1] - self._tail.shape[1]
            self._tail = audio[:, n:]
            audio = audio[:, :n]
        return audio

    def _dispatch_block_locked(self):
        """Lower, copy and queue one block WITHOUT waiting for the device:
        the inputs go to the card in one asynchronous copy, the step is
        queued, then the copies of its audio and levels into fresh pinned
        host buffers, and an event after them.  The pump overlaps block
        k+1's host lowering with block k's render (see run/run_async).

        A pinned buffer is never written while a copy may still read it:
        each block takes fresh ones, and PyTorch's pinned-memory cache
        reuses a buffer only after the copy recorded on it has completed."""
        prog = self._ensure_program()
        block_index = self._position // prog.ctx.block_frames
        with tracing.timed("player.dispatch", block_index) as clock:
            self._state, (audio, levels) = prog.step_packed(
                self._state, prog.packed_block_inputs(block_index))
            if prog.device.type == "cuda":
                host = tuple(torch.empty(t.shape, dtype=t.dtype,
                                         pin_memory=True)
                             for t in (audio, levels.stats))
                for h, t in zip(host, (audio, levels.stats)):
                    h.copy_(t, non_blocking=True)
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(prog.device))
            else:
                host, done = (audio, levels.stats), None
            self._position += prog.ctx.block_frames
        # carry the host time spent dispatching (not a wall-clock start):
        # in the pipelined pumps, other blocks' finish/write interleave
        # between dispatch and finish, and must not count as OUR load
        return prog, (host, list(levels), done), clock.ns, self._position

    def _finish_block_locked(self, pending) -> np.ndarray:
        prog, (host, paths, done), dispatch_ns, pos_after = pending
        n = prog.ctx.block_frames
        with tracing.timed("player.finish", pos_after // n - 1) as clock:
            with tracing.span("player.wait"):
                if done is not None:  # this block's copies, nothing after
                    done.synchronize()
            audio = host[0].numpy().copy()
            stats = host[1].numpy().copy()
            self._mixer_levels = {path: AudioLevel(stats[0, i], stats[1, i])
                                  for i, path in enumerate(paths)}
            if not np.isfinite(audio).all():
                audio = np.zeros_like(audio)
                if not self._panicked:
                    self._panicked = True
                    if self.panic_handler is not None:
                        self.panic_handler(
                            "non-finite samples in master output")
        # active processing time for THIS block: host lowering/dispatch +
        # materialization (device wait), the player.dispatch and
        # player.finish spans' own clock reads — the analog of the
        # reference's processing_time / rendered_audio_time
        # (measured.rs:13-19)
        if self.config.measure_cpu_load:
            load = (dispatch_ns + clock.ns) / 1e9 / (n / prog.ctx.sample_rate)
            self._cpu.peak = max(self._cpu.peak * 0.95, load)
            self._cpu.average = (1 - self._cpu_alpha) * self._cpu.average + self._cpu_alpha * load
        self._level = AudioLevel(
            peak=np.max(np.abs(audio), axis=-1),
            rms=np.sqrt(np.mean(np.square(audio), axis=-1)),
        )
        if self.status_handler is not None:
            self._emit_status(prog)
        self._retire_exhausted_locked()
        return audio

    def _emit_status(self, prog):
        sr = prog.ctx.sample_rate
        for path in prog.source_paths:
            node = prog.nodes[path]
            was_live = node in self._live_sources
            playing = self._is_playing(node)
            opts = getattr(node, "options", None)
            start = getattr(opts, "start_time", 0)
            if playing and self._position > start:
                self._live_sources.add(node)
                # throttle Position events to the source's emit rate
                # (reference: playback_pos_emit_rate, src/source/file.rs:92)
                rate = getattr(opts, "playback_pos_emit_rate", 1.0)
                if rate is None:
                    continue
                interval = max(int(rate * sr), 1)
                last = self._last_pos_emit.get(path)
                if last is not None and self._position - last < interval:
                    continue
                self._last_pos_emit[path] = self._position
                self.status_handler(PlaybackStatusEvent(
                    "position", node, position=self._position - start,
                    context=self._contexts.get(node)))
            elif was_live and not playing:
                self._live_sources.discard(node)
                self._last_pos_emit.pop(path, None)
                self.status_handler(PlaybackStatusEvent(
                    "stopped", node, exhausted=True,
                    context=self._contexts.get(node)))

    def run(self, duration_frames: Optional[int] = None):
        """Pump blocks into the output device until the graph exhausts (or
        for an explicit duration).  The analog of the reference's offline
        WavOutput loop (src/output/wav.rs:210-250)."""
        prog = self._ensure_program()
        with self._control_lock:
            tail, self._tail = self._tail, None
        tail_len = 0 if tail is None else tail.shape[1]
        if duration_frames is None:
            duration_frames = prog.natural_duration_frames()
            if duration_frames is None:
                raise PhonicError(
                    "graph has endless sources; pass duration_frames or use run_async"
                )
            duration_frames += tail_len  # natural duration counts from the
            # engine position; the tail was rendered but not yet delivered
        if duration_frames <= 0:
            with self._control_lock:
                self._tail = tail
            return
        # serve the tail left over from a previous non-aligned run first
        if tail_len:
            take = min(tail_len, duration_frames)
            self.output.write(tail[:, :take])
            if take < tail_len:
                with self._control_lock:
                    self._tail = tail[:, take:]
            duration_frames -= take
            if duration_frames == 0:
                return
        end = self._position + duration_frames
        # depth-D pipeline: up to D blocks are lowered and dispatched before
        # the oldest is materialized, so host lowering, the device render
        # AND the device-to-host copy (started at dispatch) overlap the wait
        depth = max(1, int(self.config.pipeline_depth))
        pending = deque()
        while True:
            while len(pending) < depth and self._position < end:
                with self._control_lock:
                    pending.append(self._dispatch_block_locked())
            if not pending:
                break
            oldest = pending.popleft()
            with self._control_lock:
                audio = self._finish_block_locked(oldest)
            excess = oldest[3] - end
            if excess > 0:
                # keep the over-rendered remainder: the engine state stays
                # at the block boundary, so the next run/pump must deliver
                # these frames before rendering anything new
                valid = audio.shape[1] - excess
                with self._control_lock:
                    self._tail = audio[:, valid:]
                audio = audio[:, :valid]
            self.output.write(audio)

    def run_async(self) -> threading.Thread:
        """Start a background pump (realtime devices pace it via their
        blocking write)."""
        self._pump_stop.clear()

        def pump():
            with self._control_lock:
                tail, self._tail = self._tail, None
            if tail is not None and tail.shape[1]:
                self.output.write(tail)
            pending = None
            while not self._pump_stop.is_set():
                with self._control_lock:
                    nxt = self._dispatch_block_locked()
                if pending is not None:
                    with self._control_lock:
                        audio = self._finish_block_locked(pending)
                    self.output.write(audio)
                pending = nxt
            if pending is not None:
                # drain: the last dispatched block was already rendered —
                # write it so stop() never drops audio vs the unpipelined pump
                with self._control_lock:
                    audio = self._finish_block_locked(pending)
                self.output.write(audio)

        self._pump_thread = threading.Thread(target=pump, daemon=True,
                                             name="phonic_render_pump")
        self._pump_thread.start()
        return self._pump_thread

    def stop(self):
        self._pump_stop.set()
        if self._pump_thread is not None:
            self._pump_thread.join(timeout=5.0)
            self._pump_thread = None

    def close(self):
        self.stop()
        self.output.close()

    # ------------------------------------------------------------------
    # introspection (reference: Display for Player, src/player.rs:1324-1414)
    # ------------------------------------------------------------------

    def __str__(self) -> str:
        lines = [f"Player @{self.engine_config.sample_rate}Hz "
                 f"{self.engine_config.channels}ch block={self.engine_config.block_frames}"]

        def walk(m: Mixer, depth: int):
            pad = "  " * depth
            lines.append(f"{pad}Mixer '{m.name}' (weight {m.total_weight()})")
            for s in m.sources:
                lines.append(f"{pad}  Source '{s.name}' ({type(s).__name__})")
            for e in m.effects:
                lines.append(f"{pad}  Effect '{e.name}' ({type(e).__name__})")
            for c in m.children:
                walk(c, depth + 1)

        walk(self.main_mixer, 0)
        return "\n".join(lines)

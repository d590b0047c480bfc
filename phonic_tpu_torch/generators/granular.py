"""Granular playback engine for the Sampler (port of
``phonic_tpu/generators/granular.py``).

Behavioural spec: reference src/generator/sampler/granular.rs —
  * 8 window shapes in a 2048-entry LUT with lerp lookup (:112-215);
  * Cloud mode: density phase accumulator triggers grains (:788-809);
    Sequential mode: next grain at the primary grain's window crossfade
    point (:78-94, 541-555);
  * per-trigger randomisation: spray (+-1 s), variation -> volume 0..1 /
    size 25..400% / two +-0.5 st pitch draws, pan spread (:813-897);
  * grains advance analytically: normalized position += speed/file_len,
    window phase += 1/size, loop-range or global wrap (:1081-1120);
  * Catmull-Rom 4-point read with circular index wrap (:899-933);
  * playhead advances by step*(1+speed_mod)/file_len with a loop-entry
    latch (:605-640); linear (not constant-power) grain pan law (:715-718).

A grain's whole evolution is analytic in its activation parameters, so
rendering is a ``[G, n]`` windowed read with no per-sample machinery.  Only
trigger *allocation* is sequential (a grain must land in a free slot): a
short loop over at most ``max_triggers`` candidates per chunk.  Every
function here runs all voices of a sampler at once: slot state is
``[V, POOL]``, per-voice values ``[V]``, per-sample values ``[V, n]`` (or
``[n]`` where no voice differs), and an allocation step is a handful of
tensor operations with no host synchronisation.  RNG is deterministic
counter hashing (the reference is OS-seeded).

Numerics: the trigger phase and the playhead are running sums; they are
summed in float64 and rounded once to float32, so that the card and the CPU
cross the same ``floor()`` steps (the JAX package sums in float32, equal
where the steps are dyadic).  The grain pitch ``exp2`` is evaluated in
float64 and rounded, for the same reason.  Where the JAX package divides
by a constant the port multiplies by its float32 reciprocal
(ops/precision.recip32), and grain positions, spray offsets, grain volumes
and pans are fused multiply-adds (:func:`_fma`): that is how XLA's CPU code
evaluates them, and it rounds the same on the card and the CPU.  Every
gather index is clamped: PyTorch raises (CPU) or asserts (CUDA) where JAX
clamps.

Deviation (as in the JAX package): the playhead's loop-entry latch is
evaluated per chunk with a cumulative-entry approximation (fold once
entered anywhere in the chunk).
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np
import torch

from ..ops import rampread
from ..ops.lfo import _hash_random
from ..ops.precision import recip32

POOL_SIZE = 100  # grains per voice (voice.rs:33)
WINDOW_N = 2048
NEVER = np.iinfo(np.int32).max
ENVELOPE_THRESHOLD = 1e-5

WINDOW_MODES = ("Hann", "Blackman", "Triangle", "Tukey", "Trapezoid",
                "Exponential", "RampUp", "RampDown")
# sequential crossfade points per window (granular.rs:78-94)
CROSSFADE_POINTS = (0.5, 0.5, 0.5, 0.5, 0.9, 0.8, 0.8, 0.8)
DIRECTIONS = ("Forward", "Backward", "Random")
OVERLAP_MODES = ("Cloud", "Sequential")

# slot fields: integer ones (held as int64 inside a chunk, int32 in the
# state, as the JAX package keeps them) and float32 ones
INT_SLOTS = ("g_trig", "g_dur", "g_wmode")
FLOAT_SLOTS = ("g_pos0", "g_inc", "g_winc", "g_vol", "g_pan", "g_loop")


@lru_cache(maxsize=1)
def grain_windows():
    """float32 [8, 2048] window LUTs (granular.rs:112-196)."""
    n = WINDOW_N
    phase = np.arange(n) / n
    luts = np.zeros((8, n), np.float32)
    luts[0] = 0.5 * (1.0 - np.cos(2 * np.pi * phase))  # Hann
    luts[1] = 0.42 - 0.5 * np.cos(2 * np.pi * phase) + 0.08 * np.cos(4 * np.pi * phase)
    luts[2] = np.where(phase < 0.5, 2 * phase, 2 * (1 - phase))  # Triangle
    w = 0.25  # Tukey alpha 0.5 -> width 0.25
    luts[3] = np.where(
        phase < w, 0.5 * (1 - np.cos(np.pi * phase / w)),
        np.where(phase > 1 - w, 0.5 * (1 - np.cos(np.pi * (1 - phase) / w)), 1.0),
    )
    rw = 0.1
    luts[4] = np.where(
        phase < rw, phase / rw, np.where(phase > 1 - rw, (1 - phase) / rw, 1.0)
    )
    luts[5] = np.exp(-6.0 * np.abs(phase - 0.5))  # Exponential (Poisson)
    luts[6] = np.where(
        phase < 0.9, phase / 0.9, 0.5 * (1 + np.cos(np.pi * (phase - 0.9) / 0.1))
    )
    luts[7] = np.where(
        phase < 0.1, 0.5 * (1 - np.cos(np.pi * phase / 0.1)), 1.0 - (phase - 0.1) / 0.9
    )
    luts.flags.writeable = False
    return luts


@lru_cache(maxsize=8)
def window_table(device) -> torch.Tensor:
    """The flat window LUT [8 * WINDOW_N] on ``device``, copied there once."""
    return torch.tensor(grain_windows().reshape(-1), device=device)


@lru_cache(maxsize=8)
def _crossfade_table(device) -> torch.Tensor:
    return torch.tensor(CROSSFADE_POINTS, dtype=torch.float32, device=device)


def window_sample(mode, phase, table=None):
    """Lerp LUT lookup (granular.rs:201-215).  ``mode`` int, ``phase``
    float32, broadcasting together; ``table`` the flat LUT on the phases'
    device (:func:`window_table` by default)."""
    if table is None:
        table = window_table(phase.device)
    idx_f = torch.clamp(phase, 0.0, 1.0) * (WINDOW_N - 1)
    idx = torch.clamp(idx_f.to(torch.int64), max=WINDOW_N - 2)
    frac = idx_f - idx
    lin = torch.clamp(torch.as_tensor(mode, device=phase.device).to(torch.int64),
                      0, 7) * WINDOW_N + idx
    return table[lin] * (1.0 - frac) + table[lin + 1] * frac


@dataclasses.dataclass
class GranularConfig:
    """Static granular options; the matching FourCC parameters modulate at
    runtime (sampler.rs:219-296).

    ``max_read_speed`` bounds a grain's source read rate (samples advanced
    per output sample; grain speeds above it clamp), as in the JAX package,
    where it sizes the read windows of its TPU path (deviation: the
    reference has no such cap)."""

    overlap_mode: str = "Cloud"
    window: str = "Hann"
    size_ms: float = 100.0
    density_hz: float = 10.0
    variation: float = 0.0
    spray: float = 0.0
    pan_spread: float = 0.0
    direction: str = "Forward"
    position: float = 0.5
    step: float = 0.0
    max_read_speed: float = 4.0


def _fma(a, b, c):
    """``a * b + c`` rounded once to float32, as a fused multiply-add
    (evaluated in float64, where the product of two float32 values is
    exact).  XLA's CPU backend contracts these expressions into FMAs; the
    port computes them so on every device."""
    return (torch.as_tensor(a).to(torch.float64) * b + c).to(torch.float32)


def _col(x, dims: int, dtype=None):
    """A loop-range value as a column: a per-voice ``[V]`` as ``[V]`` +
    ``dims`` ones, to broadcast against per-voice arrays; a scalar as it
    is."""
    x = torch.as_tensor(x, dtype=dtype)
    return x if x.dim() == 0 else x.reshape(x.shape + (1,) * dims)


def _running_sum(start, steps):
    """``start + cumsum(steps)`` along the last dimension, summed in float64
    and rounded once to float32 (module docstring)."""
    return (start.to(torch.float64)[..., None]
            + torch.cumsum(steps.to(torch.float64), dim=-1)).to(torch.float32)


def playhead_trajectory(playhead0, in_loop0, steps, loop_range):
    """Analytic playhead with the loop-entry latch (granular.rs:605-640).

    playhead0/in_loop0: [...] per voice; steps: [..., n] per-sample
    normalized increments (already masked to the active region);
    loop_range: (on, start, end) scalars, 0-d tensors or ``[V]`` per
    voice.  Returns (playhead [..., n], entered [..., n]).

    As in the JAX package, ``entered`` latches on the prefix of the RAW
    (unfolded) trajectory's loop membership, and the folded branch folds
    that raw trajectory."""
    ph_raw = _running_sum(playhead0, steps)
    loop_on = _col(loop_range[0], 1) > 0.5
    ls = _col(loop_range[1], 1, torch.float32)
    le = _col(loop_range[2], 1, torch.float32)
    ll = torch.clamp(le - ls, min=1e-9)
    wrapped = torch.remainder(ph_raw, 1.0)
    in_range = (wrapped >= ls) & (wrapped < le) & loop_on
    entered = ((torch.cumsum(in_range.to(torch.int32), dim=-1) > 0)
               | (in_loop0 > 0.5)[..., None]) & loop_on
    folded = ls + torch.remainder(ph_raw - ls, ll)
    return torch.where(entered, folded, wrapped), entered


def grain_state_init(pool: int = POOL_SIZE, voices: int = 1, device="cpu"):
    """A fresh grain pool per voice: slot fields [voices, pool], the rest
    [voices]."""
    def z(dt, shape=(voices, pool)):
        return torch.zeros(shape, dtype=dt, device=device)

    st = {k: z(torch.int32) for k in INT_SLOTS}
    st["g_trig"].fill_(NEVER)  # global trigger frame; NEVER = free
    st.update({k: z(torch.float32) for k in FLOAT_SLOTS})  # g_loop 1 = fold
    st.update({
        # start() arms an immediate trigger
        "trigger_phase": torch.ones(voices, dtype=torch.float32, device=device),
        "playhead": z(torch.float32, (voices,)),
        "in_loop": z(torch.float32, (voices,)),
        "rng_count": z(torch.int32, (voices,)),
        # sequential mode: next trigger frame (global)
        "seq_next": z(torch.int32, (voices,)),
    })
    return st


def _at(x, t):
    """x[..., t] per voice: x [V, n] (or [V, F, n]), t [V] int64."""
    if x.dim() == 2:
        return torch.gather(x, 1, t[:, None])[:, 0]
    return torch.gather(x, 2, t[:, None, None].expand(-1, x.shape[1], 1))[..., 0]


# per-sample values gathered at each trigger, stacked along dim 1
_PICK = ("held", "speed", "vol", "pan", "size_ms", "variation", "spray",
         "pan_spread", "window_mode", "direction", "base_position", "entered")


def granular_voice_alloc(
    state: dict,
    *,
    frame0,  # global frame of the chunk's start: a host int, or int [V]
    n: int,
    sr: int,
    frames: int,  # source length in frames (positions fold on this circle)
    loop_range,  # (on, start_norm, end_norm) scalars or [V]; on <= 0.5 = off
    note_start,  # int [V]: global frame of the current note-on (NEVER: none)
    held,  # bool [V, n]: may trigger new grains (note held, pre-release)
    speed,  # [V, n]: effective voice speed (note * transpose * finetune)
    vol,  # [V, n]: effective voice volume (base * velocity)
    pan,  # [V, n]: effective voice panning
    # per-sample granular parameters ([V, n] or [n]) with modulation
    # offsets applied by the caller:
    size_ms, density, variation, spray, pan_spread, position, pos_mod, step,
    speed_mod,
    overlap_mode,  # int, 0-d tensor or [V]: 0 cloud, 1 sequential
    window_mode,  # int [n] or [V, n]
    window_table=None,  # the flat window LUT on the device
    direction,  # int [n] or [V, n]
    seed,  # int [V] tensor (or an int): the voices' RNG seeds
    max_triggers: int,
    max_read_speed: float = 4.0,
):
    """Trigger, allocate and evolve every voice's grain pool for a chunk of
    ``n`` frames, up to (but excluding) the source read.  Returns
    ``(new_state, fidx [V, POOL, n], g [V, POOL, n])``: per-grain read
    positions in source frames and the per-sample grain weights (window
    envelope x grain volume, gated by activity)."""
    dev = held.device
    v = held.shape[0]
    f32 = torch.float32
    ii = torch.arange(n, dtype=torch.int64, device=dev)
    # per-voice start frames (lanes that start at different frames) broadcast
    # as [V, 1] against [V, P] and [V, 1, n] against the grains' [V, P, n]
    per_row = isinstance(frame0, torch.Tensor)
    f0_col = frame0[:, None] if per_row else frame0
    gframes = f0_col + ii  # [n] or [V, n]
    gframes3 = gframes[:, None, :] if per_row else gframes
    note_start = torch.as_tensor(note_start, device=dev).to(torch.int64)
    seed = torch.as_tensor(seed, device=dev).to(torch.int64).expand(v)

    def per_voice(x):
        return torch.as_tensor(x, device=dev).expand(v, n)

    # --- note (re)start: reset pool bookkeeping at note_start -------------
    fresh = note_start > frame0 - 1  # note started at/after this chunk start
    restart_here = (note_start >= frame0) & (note_start < frame0 + n)
    start_idx = torch.clamp(note_start - frame0, 0, n - 1)
    trigger_phase = torch.where(restart_here | (note_start == frame0), 1.0,
                                state["trigger_phase"])
    playhead0 = torch.where(restart_here, _at(per_voice(position), start_idx),
                            state["playhead"])
    in_loop0 = torch.where(restart_here, 0.0, state["in_loop"])

    # --- playhead trajectory (granular.rs:605-640) ------------------------
    # constant divisors as XLA evaluates them (ops/precision.recip32)
    inv_frames = recip32(frames)
    step_inc = step * (1.0 + speed_mod) * inv_frames
    active_after_start = gframes >= note_start[:, None]
    playhead, entered = playhead_trajectory(
        playhead0, in_loop0, torch.where(active_after_start, step_inc, 0.0),
        loop_range)
    ls = torch.as_tensor(loop_range[1], dtype=f32)
    ll = torch.clamp(torch.as_tensor(loop_range[2], dtype=f32) - ls, min=1e-9)
    base_position = torch.where(step == 0.0, position, playhead) + pos_mod

    # --- cloud-mode trigger times -----------------------------------------
    dens = torch.clamp(density, 1.0, 100.0)
    tp = _running_sum(trigger_phase,
                      torch.where(active_after_start, dens * recip32(sr), 0.0))
    tp_prev = torch.cat([trigger_phase[:, None], tp[:, :-1]], dim=1)
    # start() arms trigger_phase at exactly 1.0 so the first held sample
    # fires immediately (granular.rs:484): that never crosses a floor step
    armed = ((ii == torch.clamp(note_start - frame0, min=0)[:, None])
             & (trigger_phase >= 1.0)[:, None])
    trig_mask = (((torch.floor(tp) > torch.floor(tp_prev)) | armed) & held
                 & active_after_start)
    cloud_times = torch.topk(torch.where(trig_mask, ii, n),
                             min(max_triggers, n), dim=1, largest=False).values
    new_trigger_phase = tp[:, -1] - torch.floor(tp[:, -1])

    is_seq = torch.as_tensor(overlap_mode, device=dev) == 1
    cf_points = _crossfade_table(dev)
    inv_file_secs = recip32(np.float32(frames / sr))
    ms_to_frames = float(np.float32(np.float32(sr) * np.float32(recip32(1000.0))))

    # the per-sample values each trigger reads, gathered in one operation
    picks = torch.stack([per_voice(x).to(f32) for x in (
        held, speed, vol, pan, size_ms, variation, spray, pan_spread,
        window_mode, direction, base_position, entered)], dim=1)
    col = {k: i for i, k in enumerate(_PICK)}

    # --- allocation over trigger candidates --------------------------------
    ints = torch.stack([state[k] for k in INT_SLOTS], dim=1).to(torch.int64)
    floats = torch.stack([state[k] for k in FLOAT_SLOTS], dim=1)  # [V, 6, P]
    rng = state["rng_count"].to(torch.int64)
    seq_next = torch.where((state["seq_next"] < frame0) | fresh,
                           torch.maximum(note_start, frame0) if per_row
                           else torch.clamp(note_start, min=frame0),
                           state["seq_next"].to(torch.int64))
    # a step's 7 draws hash (seed, rng * 8 + i), and rng advances by at most
    # one per step: draw every counter the chunk can reach at once, and
    # let each step pick its row
    rng0 = rng
    draws = _hash_random(seed[:, None, None], (
        rng0[:, None, None] + torch.arange(max_triggers, device=dev)[:, None]
    ) * 8 + torch.arange(7, device=dev))  # [V, max_triggers, 7]
    for k in range(max_triggers):
        # JAX clamps cloud_times[k] where a chunk has fewer samples than
        # candidates
        t_cloud = cloud_times[:, min(k, cloud_times.shape[1] - 1)]
        t_seq = torch.clamp(seq_next - frame0, 0, n)
        t = torch.where(is_seq, t_seq, t_cloud)
        t_safe = torch.clamp(t, max=n - 1)
        p = _at(picks, t_safe)  # [V, len(_PICK)]

        def pk(name):
            return p[:, col[name]]

        valid = (t < n) & torch.where(
            is_seq, (pk("held") > 0.5) & (frame0 + t_safe >= note_start), True)
        gt = frame0 + t_safe  # global trigger frame

        draw = torch.gather(draws, 1, (rng - rng0)[:, None, None].expand(
            -1, 1, 7))[:, 0]  # [V, 7]: this step's counter
        u = (draw + 1.0) * 0.5  # [0, 1)

        var = torch.clamp(pk("variation"), 0.0, 1.0)
        vol_scale = _fma(-var, u[:, 0], 1.0)
        sem1 = var * (u[:, 1] - 0.5)
        size_scale = (1.0 - 0.75 * var) + (2.75 * var) * u[:, 2]
        size = torch.clamp(pk("size_ms"), 1.0, 1000.0)
        dur = torch.clamp((size * size_scale * ms_to_frames).to(torch.int64),
                          min=2)
        pspread = torch.clamp(pk("pan_spread"), 0.0, 1.0)
        gpan = torch.clamp(_fma(pspread, draw[:, 3], pk("pan")), -1.0, 1.0)
        sem2 = var * draw[:, 4] * 0.5
        d = pk("direction")
        reverse = torch.where(d == 0, False,
                              torch.where(d == 1, True, draw[:, 5] > 0.0))
        spr = torch.clamp(pk("spray"), 0.0, 1.0)

        gpos = _fma(spr * draw[:, 6], inv_file_secs, pk("base_position"))
        lm = pk("entered") > 0.5
        gpos = torch.where(lm, ls + torch.remainder(gpos - ls, ll), gpos)
        gpos = torch.remainder(gpos, 1.0)

        # read-speed cap (GranularConfig.max_read_speed)
        pitch = torch.exp2(((sem1 + sem2) * recip32(12.0)).to(torch.float64)
                           ).to(f32)
        gspeed = torch.clamp(pk("speed") * pitch, max=float(np.float32(
            max_read_speed)))
        ginc = gspeed * inv_frames * torch.where(reverse, -1.0, 1.0)
        gvol = torch.clamp(pk("vol") * vol_scale, 0.0, 100.0)
        wm = pk("window_mode").to(torch.int64)
        winc = 1.0 / dur.to(f32)

        # first free slot (granular.rs:823).  The whole chunk renders AFTER
        # allocation, so a slot is only reusable if its grain expired
        # BEFORE this chunk: otherwise the overwrite would erase an
        # unrendered grain.
        g_trig = ints[:, 0]
        free = (g_trig == NEVER) | (g_trig + ints[:, 1] <= f0_col)
        do = valid & free.any(dim=1)
        slot = (free & (torch.cumsum(free.to(torch.int32), dim=1) == 1)
                & do[:, None])[:, None, :]  # [V, 1, P]
        ints = torch.where(slot, torch.stack([gt, dur, wm], dim=1)[..., None],
                           ints)
        floats = torch.where(slot, torch.stack(
            [gpos, ginc, winc, gvol, gpan, lm.to(f32)], dim=1)[..., None],
            floats)
        rng = rng + valid.to(torch.int64)
        # sequential: chain the next trigger at the crossfade point
        cf = cf_points[torch.clamp(wm, 0, 7)]
        seq_step = torch.clamp((cf / winc).to(torch.int64), min=1)
        seq_next = torch.where(is_seq & do, gt + seq_step,
                               torch.where(is_seq & valid, seq_next + 1,
                                           seq_next))

    # --- render all grain slots [V, P, n] ----------------------------------
    g_trig, g_dur, g_wmode = ints.unbind(1)
    g_pos0, g_inc, g_winc, g_vol, g_pan, g_loop = floats.unbind(1)
    local = gframes3 - g_trig[..., None]
    g_active = (local >= 0) & (local < g_dur[..., None])
    # hard-cut grains of the previous note at a steal (voice reset)
    ns = note_start[:, None, None]
    g_active &= ~((g_trig[..., None] < ns) & (gframes3 >= ns))

    localf = local.to(f32)
    wphase = torch.clamp(localf * g_winc[..., None], 0.0, 1.0)
    env = window_sample(g_wmode[..., None], wphase, window_table) \
        * g_vol[..., None]
    pos = _fma(localf, g_inc[..., None], g_pos0[..., None])
    pos_folded = _col(ls, 2) + torch.remainder(pos - _col(ls, 2), _col(ll, 2))
    pos = torch.where(g_loop[..., None] > 0.5, pos_folded,
                      torch.remainder(pos, 1.0))
    fidx = pos * np.float32(frames - 1)
    g = torch.where(g_active & (env > ENVELOPE_THRESHOLD), env, 0.0)

    ints = ints.to(torch.int32)
    new_state = {k: ints[:, i] for i, k in enumerate(INT_SLOTS)}
    new_state.update({k: floats[:, i] for i, k in enumerate(FLOAT_SLOTS)})
    new_state.update({
        "trigger_phase": torch.where(held.any(dim=-1), new_trigger_phase,
                                     trigger_phase),
        "playhead": playhead[:, -1],
        "in_loop": entered[:, -1].to(f32),
        "rng_count": rng.to(torch.int32),
        "seq_next": seq_next.to(torch.int32),
    })
    return new_state, fidx, g


def grain_mix(s, g, g_pan):
    """Weighted equal-power-less pan mix of grain streams: s [..., G, n]
    source reads, g [..., G, n] grain weights, g_pan [..., G] -> [..., 2, n]
    (granular.rs:933-941), as a [2, G] @ [G, n] float32 product."""
    w = torch.stack([(1.0 - g_pan) * 0.5, (1.0 + g_pan) * 0.5], dim=-2)
    return torch.matmul(w, s * g)


def source_table(mono: np.ndarray) -> np.ndarray:
    """The circularly extended source the grains read, as one planar table
    row [1, 1, frames + 2]: ext[k] = buf[k - 1], with buf[-1] = buf[frames-1]
    and buf[frames] = buf[0] (the file-circle tap wrap), so a read at
    ``fidx + 1`` reproduces the reference's wrapped Catmull-Rom taps."""
    mono = np.asarray(mono, np.float32)
    return np.concatenate([mono[-1:], mono, mono[:1]])[None, None, :]


def read_grains(table, fidx):
    """Every grain's source read in one ``ramp_read``: table [1, 1, E] from
    :func:`source_table`, fidx [..., n] -> [..., n]."""
    n = fidx.shape[-1]
    pos = fidx.reshape(-1, n) + 1.0
    smap = torch.zeros(pos.shape[0], dtype=torch.int32, device=pos.device)
    return rampread.ramp_read(table, smap, pos).reshape(fidx.shape)


def granular_voice_block(state: dict, *, mono_table, frames: int, **kwargs):
    """Render every voice's granular output for a chunk -> (state,
    [V, 2, n]): :func:`granular_voice_alloc`, the read
    (:func:`read_grains`) and :func:`grain_mix`.  ``kwargs`` are
    :func:`granular_voice_alloc`'s.  The sampler hoists the read of a whole
    block out of its chunk loop instead (generators/sampler.py)."""
    new_state, fidx, g = granular_voice_alloc(state, frames=frames, **kwargs)
    s = read_grains(mono_table, fidx)
    return new_state, grain_mix(s, g, new_state["g_pan"])

"""GPU smoke test of the PyTorch port: build the CUDA kernels, check each
against its plain PyTorch version on the card, then render the headline
mixer graph, the mastering chain, the 64-voice sampler, the play_file path
(preloaded and streamed), the granular sampler, the live Player, the
synth path and the headline graph as 8 batched lanes, shared and with
per-lane inputs, and the headline and mastering graphs split over a
two-entry mesh, at full width on the card, render the port's examples and
drive its output devices, and check them.

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``; exits non-zero without them or when any
phase fails.  Phases:

1. build ``phonic_tpu_torch/csrc/*.cu`` (sm_90a, one nvcc per source, in
   parallel) and print the build time, the compiler's register /
   shared-memory report and, for the gate, iir2, iir1 and ramp_read
   kernels, a summary of their machine code
   (``cuobjdump -sass``): shared and global loads and stores by width
   (``cp.async`` is LDGSTS), and how far ahead of its first use each shared
   load of the chain loops is issued;
2. each kernel against its plain version on the same inputs, at the render
   paths' shapes and at ragged ones, with its time beside the plain
   version's (CUDA events around the wrapper).  The ramp read also runs
   unaligned rows with a ragged end (B=3, ch=2, N=4097), bench.py's 64
   sampler voices over one shared 48000-frame tone (B=64, N=131072), the
   granular path's grains (B=1000 lanes over one 96002-frame row: a
   96000-frame tone extended by one frame each side, folded ramps forward
   and backward with their wrap jumps, N=131072), and lanes whose source
   index is out of range with NaN positions (both read silence); the
   recurrences run at one and two segments and one off, odd lengths (rows
   that start unaligned), one row and forty, and iir2 at the synth path's
   shapes (R=64 for sub3's SVF over 64 voices, R=2 for the bank's filter,
   T=131072).  The follower and
   the gate must agree with their plain versions exactly; at 131072
   samples their plain versions (a Python loop over time) run on a CPU
   copy of the card's inputs.  The gate also runs edge cases: lengths at
   its tile and target-ring sizes and one off, holds of 0 and 1 samples, a
   gate that flips on every sample, and holds that run out just before, at
   and after a tile boundary.  The smoother kernel must agree with its
   plain version bit for bit (values and every field of the new state) in
   every case of ``smooth_cases`` at n = 8192 and 131072, then at each
   path's largest group (``SMOOTH_PATHS``), timed; the delay's kernel
   against its plain loop (every output to -90 dB of its peak; the card
   test ``tests/test_torch_delay_cuda.py`` holds it closer) at the
   mastering chain's shape (one lane, 131072 samples, b = 8192, W =
   50432), the mastering lanes cell's (8 lanes) and at b = 1024, each timed
   beside the plain loop; kernels 10 and 11, with iir2 between them,
   against their plain version at the synth cell's shape (8 lanes of 64
   voices, K = 8 trigger slots), each timed beside its bytes bound;
3. the headline graph (16 file sources -> 4 sub-mixers with EQ5 + chorus ->
   reverb + gain, 131072-frame blocks at 48 kHz stereo) rendered on the card
   through ``RenderProgram.render``: the launch counters of its kernels
   (ramp read, iir2, iir1) must grow, the audio must be finite and not
   silent, and its first two blocks must match the same program rendered
   on the CPU to -90 dB of peak;
4. the mastering chain (4 looping file sources -> gate -> compressor ->
   delay -> distortion -> limiter, 131072-frame blocks at 48 kHz stereo),
   checked the same way; the counters of ramp_read, the follower, the gate,
   the smoothers and the delay must grow, the delay's by exactly one launch
   per block, and iir2 and iir1 must not launch (the delay's feedback loop
   is kernel 7);
5. the sampler (bench.py's config 2: 64 voices with AHDSR envelopes over
   one 48000-frame tone, 64 notes 480 frames apart, 131072-frame blocks at
   48 kHz stereo), checked the same way; its generator pool reads every
   voice in one ramp_read per block;
6. the play_file path: (a) bench.py's config 1 (one endless 48000-frame
   mono tone at speed 1.09, the default read, 262144-frame blocks) checked
   the same way, one ramp_read per block; (b) a decoded file at the size
   users play: a 180 s stereo 44.1 kHz 16-bit WAV written with the port's
   ``write_wav`` from a fixed seed, loaded with
   ``AudioFileBuffer.from_file`` (decode time logged) and rendered once at
   ``resampling_quality="high"`` (the polyphase sinc read) to its natural
   length with ``render(None)`` (rate logged) and through ``render_file``;
   the WAV read back must hold exactly the natural length (computed here
   from the source's span, rate and speed), be finite and not silent, and
   its first two blocks must match the same program on the CPU to -90 dB;
   the sinc read's time at that shape is logged; then the same WAV played
   from disk as a ``StreamedFileSource`` at the default quality, 8 blocks
   of 131072 frames (rate and the host's window assembly per block
   logged), blocks 0-3 against the streamed CPU render to -90 dB, against
   the preloaded ``FileSource`` on the card to -90 dB at a step of exactly
   one source frame per output frame (both reads exact), and at speed 1
   within the bound of their float32 read positions (the preloaded read's
   absolute positions lose precision as the file position grows);
   (c) the granular sampler
   (bench.py's config 4: 10 voices, each keeping a pool of 100 one-second
   grains full at 100 Hz density, over a 96000-frame tone, 131072-frame
   blocks at 48 kHz stereo), checked the same way; every grain of a block
   reads in exactly one ramp_read, and float32 matrix products must not
   run in TF32 (the grain mix is one); (d) player_rt_8192 (bench.py's
   ``config_player_rt``: the headline's 16 sources, sub-mixers and effects
   in a ``Player`` at 8192-frame blocks, metering and auto-bypass on):
   blocks 0-3 through ``render_block``, with the launch counters set to 0
   just before (each of ramp_read, iir2 and iir1 must launch, ramp_read
   exactly once per block); the audio and every mixer's peak and RMS
   against the same Player on the CPU to -90 dB; 8 sources removed at
   block 4 on both (a rebuild that adopts the running state) and blocks
   4-5 compared the same way; then ``Player.run(8 * n)`` timed as bench.py
   times it (at least 10 blocks and 1 s, host clock) at pipeline depth 1
   and 3, with the number of retirement rebuilds it ran; and one file
   source's ``cpu_load()`` (timed alone with CUDA events); (e)
   synth_64v (``synth64.synth_program``: a 64-voice ``SynthGenerator`` of
   sub3 with bench.py's config 2 notes, a bank of 16 dx7
   ``SynthSource``s in a sub-mixer with a lowpass ``FilterEffect``, a
   ``PanningEffect`` on the master; 131072-frame blocks) rendered as
   phases 3-5 render theirs, iir2 exactly twice per block; every
   unautomated note's frequency multiplier exactly 1 on the card; then the
   same graph in a Player (``play_generator``, ``play_synth``) at
   8192-frame blocks, blocks 0-3 against the CPU Player to -90 dB;
   (f) the headline graph as 8 independent lanes of one
   ``BatchedRenderProgram`` (the lanes folded into every bank): one warm
   block, then 4 blocks timed with the launch counters set to 0 just
   before, exactly 1 ramp_read (B=128), 9 iir2 (R=64) and 1 iir1 (R=16)
   per block, as one lane makes; every lane against phase 3's program
   rendered on the card within 1e-6, lane 0 against phase 3's CPU render
   to -90 dB, ``mixdown`` against 8 x the single lane within 1e-4,
   ``render_scan`` against ``render`` bit for bit, and the aggregate rate
   (lanes x audio seconds per wall second); (g) every port example
   (``phonic_tpu_torch.examples``) rendered offline with ``-o`` on the
   card and on the CPU (equal frame counts, -90 dB of peak), 1 s of a
   render played through ``RtOutput`` (ALSA when present, else its paced
   sink; its ``sample_position`` and wall time logged), and a
   ``WebOutput`` on 127.0.0.1 serving its WAV header and the written
   frames to one read with a timeout; (h) the headline graph as 8 lanes
   whose inputs are per lane, each lowered by its own CPU program with its
   own schedule (lane 0 plain; every other lane its own master-gain ramp
   and a volume event on a source of its own; lane 3 a speed glide, lane
   5 a stop, lane 6 a seek, lane 7 an EQ5 band and the chorus depth): one
   warm block, then 4 blocks timed with the launch counters set to 0 just
   before, exactly 1 ramp_read, 9 iir2 and 1 iir1 per block; the lanes
   must differ by more than 0.05 of peak, every lane equal its own
   single-lane program on the card within 1e-6, lanes 0 and 7 their CPU
   renders to -90 dB; the host lowering per block of 8 lanes and of one,
   and one lane and the 8 lanes timed back to back (1, 8, 8, 1); then
   the sampler (config 2) as 4 lanes with its notes transposed by 0, 7,
   -5 and 12 semitones, 1 ramp_read per block, each lane equal to its own
   card render within 1e-6; and 3 headline lanes (schedules 0, 6 and 7)
   whose last two start one block later, each equal to its own program on
   the card over the same blocks within 1e-6; (i) one graph's banks split
   over a mesh (``GraphShardedProgram``): the headline graph and the
   mastering chain at full width, 4 blocks on ``[cuda:0, cuda:0]`` (and on
   ``data_mesh(2)`` when two cards are present) with the launch counters
   set to 0 just before and read just after (ramp_read exactly once per
   shard per block), each equal to its unsharded program on the card bit
   for bit, the current CUDA device unchanged after every step, wall per
   block beside the unsharded program's; the headline at 8192-frame blocks
   on ``[cuda:0, "cpu"]`` within -90 dB of the card (a tensor left on the
   wrong device raises); 4 headline lanes on a 2D mesh (2 lane shards x 2
   entries) equal to the 4 lanes on the card bit for bit;
7. under ``torch.profiler``, after every timed render (a profiler session
   slows the launches that follow it in the process): one more block of
   each path, which gives the device operations, the host-to-device
   copies, the ``cudaStreamSynchronize`` calls and the device time per
   block and the device's busy share (device time over that block's wall
   time, both under the profiler); each Player's block is one
   ``render_block`` (packed inputs, step, copies back), and the
   synchronising calls PyTorch reports in it (its sync debug mode) are
   logged with where they come from: the synth Player fails the run on a
   ``cudaStreamSynchronize`` or a reported call;
   the batched headline's block is one step of its 8 lanes, the per-lane
   headline's one step of 8 lanes' own inputs, a graph-sharded path's one
   step of its split program on ``[cuda:0, cuda:0]``;
   each kernel's kernel-only device time (the profiler's events of its own
   launches, and their number per call) and its share of its bound, at
   each path's shape (``batched_headline``: B=128, R=64, R=16, 8 reverbs
   and 32 choruses; ``graph_sharded``: a shard's B=8, R=4 and 2 choruses,
   the master chains' shapes otherwise) and at the
   byte-bound shapes off the paths (iir2 and iir1 at R=40, the delay at 8
   lanes with b = 8192 and b = 1024); and the
   headline graph's rate once more, after the profiler.

The line before the last is a JSON object with each kernel's numbers from
this run: at top level those of the mastering chain (iir2's and iir1's:
the headline's, since the mastering chain runs neither), under
``by_path`` those of each path (a path's second shape as ``path/what``,
sharing the path's launches) and under ``off_path`` those of the shapes
timed off the paths.  The last line is
``{"ok": true, "device": {...}}``.
"""

import collections
import contextlib
import functools
import io
import json
import re
import runpy
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
import warnings
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from phonic_tpu_torch import kernels, tracing
from phonic_tpu_torch.effects import chorus as chorus_fx
from phonic_tpu_torch.effects import delay as delay_fx
from phonic_tpu_torch.effects import reverb as reverb_fx
from phonic_tpu_torch.generators.granular import source_table
from phonic_tpu_torch.granular1k import granular_program
from phonic_tpu_torch.headline import mixer_graph_program, tone
from phonic_tpu_torch.io import wav as wav_io
from phonic_tpu_torch.io.decoder import AudioFileBuffer
from phonic_tpu_torch.mastering import mastering_program
from phonic_tpu_torch.ops import (
    chorusline, delayline, follower, rampread, resample, reverbnet, scan,
    smoothing, synthvoice,
)
from phonic_tpu_torch import synths as synth_defs
from phonic_tpu_torch.modulation.config import (
    EnvelopeSource, LfoSource, ModulationConfig, VelocitySource,
)
from phonic_tpu_torch.play_file import (
    BLOCK_FRAMES as PLAY_BLOCK, file_program, play_file_program, render_file,
)
from phonic_tpu_torch.outputs.null import NullOutput
from phonic_tpu_torch.outputs.rt import RtOutput
from phonic_tpu_torch.outputs.web import WebOutput, _wav_stream_header
from phonic_tpu_torch.parallel.mesh import (
    BatchedRenderProgram, GraphShardedProgram, data_mesh,
)
from phonic_tpu_torch.player import Player, PlayerConfig
from phonic_tpu_torch.player_rt import (
    BLOCK_FRAMES as PLAYER_BLOCK, player_rt_player,
)
from phonic_tpu_torch.generators.synth import note_speed
from phonic_tpu_torch.generators import synth as synth_gen
from phonic_tpu_torch.generators.sampler import voice_rows
from phonic_tpu_torch.graph.batching import stack_states
from phonic_tpu_torch.graph.mixer import Mixer
from phonic_tpu_torch.graph.engine import RenderProgram
from phonic_tpu_torch.graph.nodes import BuildCtx
from phonic_tpu_torch.config import EngineConfig
from phonic_tpu_torch.sampler64 import sampler_program
from phonic_tpu_torch.sources.file import FilePlaybackOptions, FileSource
from phonic_tpu_torch.sources.streamed import StreamedFileSource
from phonic_tpu_torch.synth64 import synth_player, synth_program

BLOCK = 131072
SR = 48000
# the batched headline's lanes (phase 6f)
LANES = 8
# the decoded file of phase 6b: seconds, rate, channels
FILE_SECS, FILE_SR, FILE_CH = 180, 44100, 2
DB90 = 10.0 ** (-90.0 / 20.0)
RAMP_TOL = 1e-5  # unit-scale data; FMA contraction vs the plain x-form
# published H100 SXM peaks (NVIDIA data sheet): device memory rate, and the
# float32 rate outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
# the longest loop-carried path per sample of the follower's and the gate's
# serial chains (csrc/follower.cu), at ~4 cycles of latency each: the
# follower's env (compare, select, multiply, add; the subtract runs beside
# the compare) is 4 deep.  The gate carries three chains, each depending
# only on its own previous value and this sample's inputs: env, 4 deep; the
# hold counter (subtract, max, select), 3 deep; the gain (compare, select,
# multiply, add over target[i], which is computed from env[i] off the
# gain's loop), 4 deep.  So 4, not their sum.
CHAIN_OPS = {"follower": 4, "gate": 4}
CYCLES_PER_OP = 4
# all operations per sample (compares, selects and arithmetic)
OPS_PER_SAMPLE = {"follower": 5, "gate": 15}

# launch counters: kernel -> its counter in phonic_tpu_torch.tracing
COUNTERS = {k: f"kernel.{k}" for k in
            ("ramp_read", "iir2", "iir1", "follower", "gate", "smooth",
             "delay", "reverb", "chorus", "synth_voice", "synth_mix")}
# the kernels whose machine code phase 1 summarises
SASS_KERNELS = ("gate_kernel", "iir2_kernel", "iir1_kernel", "ramp_read_kernel")
SOURCES = {"ramp_read": ("phonic_tpu_torch/csrc/rampread.cu",
                         "phonic_tpu/ops/rampread.py:176"),
           "iir2": ("phonic_tpu_torch/csrc/scan.cu",
                    "phonic_tpu/ops/pallas_scan.py:112"),
           "iir1": ("phonic_tpu_torch/csrc/scan.cu",
                    "phonic_tpu/ops/pallas_scan.py:74"),
           "follower": ("phonic_tpu_torch/csrc/follower.cu",
                        "phonic_tpu/ops/follower.py:54"),
           "gate": ("phonic_tpu_torch/csrc/follower.cu",
                    "phonic_tpu/ops/follower.py:140"),
           # the JAX package's smoothers are plain jnp: no TPU kernel
           "smooth": ("phonic_tpu_torch/csrc/smooth.cu", None),
           # the JAX package's delay, reverb and chorus loops are lax.scans
           # of jnp operations
           "delay": ("phonic_tpu_torch/csrc/delay.cu", None),
           "reverb": ("phonic_tpu_torch/csrc/reverb.cu", None),
           "chorus": ("phonic_tpu_torch/csrc/chorus.cu", None),
           # the JAX package's synth render is plain jnp
           "synth_voice": ("phonic_tpu_torch/csrc/synthvoice.cu", None),
           "synth_mix": ("phonic_tpu_torch/csrc/synthvoice.cu", None)}


def log(*args):
    print(*args, flush=True)


START = time.perf_counter()


def phase(title):
    """Log a phase's title with the seconds the script has run so far."""
    log(f"phase {title} ({time.perf_counter() - START:.1f} s in)")


def time_ms(fn, reps):
    """Mean device time of ``fn`` over ``reps`` runs after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_time(name, fn, reps):
    """Kernel-only device time of one call of ``fn``, from the profiler's
    device events whose name holds the kernel's (every device function of
    a kernel does) over ``reps`` calls after one warm-up.  Returns (ms,
    launches per call)."""
    fn()
    torch.cuda.synchronize()
    by_fn = {}
    for _ in range(3):  # a short window now and then comes back empty
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        for e in prof.events():
            if (e.device_type == DeviceType.CUDA
                    and name in e.name.lower()):
                by_fn.setdefault(e.name, []).append(e.time_range.elapsed_us())
        if by_fn:
            break
    else:
        raise RuntimeError(f"{name}: the profiler saw no launch of its kernel")
    # per device function: its mean time x its launches per call (the
    # profiler may drop a launch at the window's edge)
    per_call = {f: max(1, round(len(us) / reps)) for f, us in by_fn.items()}
    ms = sum(sum(us) / len(us) * per_call[f] for f, us in by_fn.items()) / 1e3
    return ms, sum(per_call.values())


def bound(nbytes, ops):
    """(ms, "bytes" or "operations"): the least time the card could take to
    move ``nbytes`` and do ``ops`` float32 operations."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def compare(name, kernel_fn, plain_fn, tol, relative, reps=(20, 3)):
    """Run a kernel and its plain version on the same inputs; raise if they
    disagree.  Returns (max_abs_err, kernel ms, plain ms)."""
    got, want = kernel_fn(), plain_fn()
    torch.cuda.synchronize()
    if not isinstance(got, tuple):
        got, want = (got,), (want,)
    err, peak = 0.0, 0.0
    for g, w in zip(got, want):
        if g.shape != w.shape or not torch.isfinite(g).all():
            raise RuntimeError(f"{name}: bad output {tuple(g.shape)}")
        err = max(err, float((g - w).abs().max()))
        peak = max(peak, float(w.abs().max()))
    bound = tol * peak if relative else tol
    ms = time_ms(kernel_fn, reps[0])
    plain_ms = time_ms(plain_fn, reps[1])
    log(f"  {name}: max_abs_err {err:.3e} (bound {bound:.3e}, peak "
        f"{peak:.3f})  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms")
    if not err <= bound:
        raise RuntimeError(f"{name}: kernel disagrees with its plain version")
    return err, ms, plain_ms


def ramp_positions(rng, lanes, n, frames):
    """Ramps at speeds 0.5..2 per lane: plain, looped, pingpong, and with
    jumps out of range, by lane."""
    p = np.cumsum(rng.uniform(0.5, 2.0, (lanes, n)), axis=-1)
    p += rng.uniform(0, frames / 2, (lanes, 1))
    for b in range(lanes):
        ls, le = 0.1 * frames, 0.9 * frames
        if b % 4 == 1:  # forward loop
            p[b] = np.where(p[b] < ls, p[b], ls + np.mod(p[b] - ls, le - ls))
        elif b % 4 == 2:  # pingpong
            c = np.mod(p[b] - ls, 2 * (le - ls))
            p[b] = np.where(p[b] < ls, p[b],
                            ls + np.where(c < le - ls, c, 2 * (le - ls) - c))
        elif b % 4 == 3:  # wraps, with jumps out of range on both sides
            p[b] = np.mod(p[b], frames)
            jumps = rng.integers(0, n, max(n // 100, 1))
            p[b, jumps] = rng.choice([-50.0, frames + 50.0], jumps.size)
    return p.astype(np.float32)


def grain_positions(rng, lanes, n, frames, dev):
    """Grain read positions as the granular path gives them (``fidx + 1``):
    per lane a ramp at 0.5..2 source frames per sample, forward or
    backward, folded on the file circle, so it jumps at each wrap; in
    [1, frames + 1).  Made on the card: [1000, 131072] is 0.5 GB."""
    speed = rng.uniform(0.5, 2.0, lanes) * rng.choice([-1.0, 1.0], lanes)
    start = rng.uniform(0, frames, lanes)
    t = torch.arange(n, dtype=torch.float64, device=dev)
    ramp = (torch.as_tensor(start, device=dev)[:, None]
            + torch.as_tensor(speed, device=dev)[:, None] * t)
    return (torch.remainder(ramp, frames) + 1.0).to(torch.float32)


def ramp_expected(src, smap, pos):
    """The plain version with the kernel's guards: a lane whose source index
    is outside [0, S), and a NaN position, read silence."""
    ok = (smap >= 0) & (smap < src.shape[0])
    want = rampread.ramp_read_plain(src, torch.where(ok, smap, 0),
                                    torch.nan_to_num(pos, nan=-1e9))
    return torch.where(ok[:, None, None], want, 0.0)


# ramp_read cases: lanes, channels, sources, table frames (longest buffer +
# guard), outputs, path, kind ("ramps": lane b reads source b, random
# tables; "tone": every lane reads one 48000-frame tone, as the sampler
# path's 64 voices do; "loop": one lane reads one 48000-frame tone looped
# at speed 1.09, as config 1 does; "grains": every lane reads one 96000-frame
# tone extended by one frame each side, as the granular path's 1000 grain
# slots do; "bad": lanes 1 and B-1 read sources out of range, 5 % of the
# positions are NaN)
RAMP_CASES = (
    (1, 1, 1, 48001, PLAY_BLOCK, "play_file", "loop"),
    (16, 1, 16, 26656, BLOCK, "headline", "ramps"),
    (16 * LANES, 1, 16, 26656, BLOCK, "batched_headline", "ramps"),
    (8, 1, 8, 26656, BLOCK, "graph_sharded", "ramps"),
    (16, 1, 16, 26656, PLAYER_BLOCK, "player", "ramps"),
    (4, 1, 4, 48001, BLOCK, "mastering", "ramps"),
    (16, 1, 16, 26656, 1000, None, "ramps"),
    (16, 2, 16, 26656, BLOCK, None, "ramps"),
    (16, 2, 16, 26656, 1000, None, "ramps"),
    (3, 2, 3, 26656, 4097, None, "ramps"),
    (64, 1, 1, 48001, BLOCK, "sampler", "tone"),
    (1000, 1, 1, 96002, BLOCK, "granular", "grains"),
    (4, 2, 3, 5000, 4096, None, "bad"),
    (4, 2, 3, 5000, 4097, None, "bad"))


def check_kernels(dev):
    """Each kernel against its plain version at the shape each render path
    gives it and at ragged ones.  Returns {kernel: {path: numbers}},
    {kernel: {shape: numbers}} of the shapes phase 7 times off the paths,
    and the calls whose kernel-only time phase 7 takes: (kernel, shape,
    call, numbers)."""
    rng = np.random.default_rng(0)
    results = {name: {} for name in COUNTERS}
    off_path = {name: {} for name in COUNTERS}
    calls = []

    def record(name, path, res, moved, ops, fn, label, timed=False, **extra):
        bound_ms, bound_by = bound(moved, ops)
        nums = dict(max_abs_err=res[0], ms=res[1], plain_ms=res[2],
                    bound_ms=bound_ms, bound_by=bound_by, shape=label, **extra)
        if path is not None:
            results[name][path] = nums
        elif timed:
            off_path[name][label] = nums
        if path is not None or timed:
            calls.append((name, label, fn, nums))

    for lanes, ch, sources, frames, n, path, kind in RAMP_CASES:
        if kind in ("tone", "loop"):
            tone = np.sin(2 * np.pi * 440 / SR * np.arange(frames - 1))
            src = np.append(tone, 0.0).reshape(1, 1, frames)
        elif kind == "grains":
            tone = np.sin(2 * np.pi * 220 / SR * np.arange(frames - 2))
            src = source_table(tone)
        else:
            src = rng.normal(size=(sources, ch, frames))
        src = torch.as_tensor(src.astype(np.float32), device=dev)
        smap = torch.arange(lanes, dtype=torch.int32, device=dev) % sources
        if kind == "loop":
            pos = np.mod(np.arange(n) * 1.09, frames - 1)[None]
        elif kind == "grains":
            pos = grain_positions(rng, lanes, n, frames - 2, dev)
        else:
            pos = ramp_positions(rng, lanes, n, frames)
        pos = torch.as_tensor(pos, dtype=torch.float32, device=dev)
        plain = rampread.ramp_read_plain
        if kind == "bad":
            smap[1], smap[-1] = sources + 2, -1
            pos[torch.as_tensor(rng.random(pos.shape) < 0.05, device=dev)] = np.nan
            plain = ramp_expected
        label = f"B={lanes} ch={ch} F={frames} N={n}"
        fn = functools.partial(rampread.ramp_read, src, smap, pos)
        res = compare(f"ramp_read {label} {kind}", fn,
                      functools.partial(plain, src, smap, pos), RAMP_TOL,
                      relative=False)
        # each output: a position, 4 taps and the Hermite sum
        record("ramp_read", path, res, nbytes(src, smap, pos) + 4 * lanes * ch * n,
               20 * lanes * ch * n, fn, label)

    def uniform(lo, hi, shape):
        return torch.as_tensor(rng.uniform(lo, hi, shape).astype(np.float32),
                               device=dev)

    def normal(shape):
        return torch.as_tensor(rng.normal(size=shape).astype(np.float32),
                               device=dev)

    # stable coefficients: every row sum of |A| stays below 1.  Beside the
    # paths' shapes: one segment (4096 samples) and one off, odd lengths
    # (rows that start unaligned), one row and forty
    for r, t, path in ((8, BLOCK, "headline"),
                       (8 * LANES, BLOCK, "batched_headline"),
                       (4, BLOCK, "graph_sharded"), (2, 8192, None),
                       (8, PLAYER_BLOCK, "player"), (64, BLOCK, "synth_64v"),
                       (2, BLOCK, "synth_64v/filter"),
                       (1, 4095, None), (1, 4096, None),
                       (1, 4097, None), (2, 4097, None), (8, 4097, None),
                       (3, 12289, None), (40, BLOCK, None), (40, 4097, None)):
        args = (uniform(0.7, 0.95, (r, t)), uniform(-0.04, 0.04, (r, t)),
                uniform(-0.04, 0.04, (r, t)), uniform(0.7, 0.95, (r, t)),
                normal((r, t)), normal((r, t)), normal(r), normal(r))
        fn = functools.partial(scan.iir2, *args)
        res = compare(f"iir2 R={r} T={t}", fn,
                      lambda: scan.chunked_second(*args), DB90, relative=True)
        # s = A s + b: 8 operations per sample; 2 outputs
        record("iir2", path, res, nbytes(*args) + 2 * 4 * r * t, 8 * r * t,
               fn, f"R={r} T={t}", timed=r == 40 and t == BLOCK)
    # beside the paths' shapes: two segments (2 x 4096 samples) and one off,
    # rows that start unaligned and cross a segment, forty rows
    for r, t, path in ((2, BLOCK, "headline"),
                       (2 * LANES, BLOCK, "batched_headline"),
                       (2, 8192, None),
                       (2, PLAYER_BLOCK, "player"), (2, 999, None),
                       (7, BLOCK, None), (7, 999, None),
                       (1, 8191, None), (1, 8192, None), (1, 8193, None),
                       (1, 16385, None), (3, 8193, None), (40, BLOCK, None)):
        a, b, y0 = uniform(0.7, 0.999, (r, t)), normal((r, t)), normal(r)
        fn = functools.partial(scan.iir1, a, b, y0)
        res = compare(f"iir1 R={r} T={t}", fn,
                      lambda: scan.chunked_first(a, b, y0), DB90,
                      relative=True)
        record("iir1", path, res, nbytes(a, b, y0) + 4 * r * t, 2 * r * t,
               fn, f"R={r} T={t}", timed=r == 40)
    check_dynamics(dev, rng, record)
    check_smoothers(dev, rng, record)
    check_delay(dev, record)
    check_effect_lines(dev, record)
    check_synth_voice(dev, record)
    return results, off_path, calls


def dynamics_streams(rng, dev, b, n):
    """tests/test_follower.py's streams per row: input dB uniform in
    [-90, 0], attack 0.05, release 0.002; the gate's threshold -40 dB (-30
    in the second half), range -60 dB, hold 441 samples."""
    def full(v):
        return torch.full((b, n), v, dtype=torch.float32, device=dev)
    x = torch.as_tensor(rng.uniform(-90, 0, (b, n)).astype(np.float32),
                        device=dev)
    thr = full(-40.0)
    thr[:, n // 2:] = -30.0
    return x, full(0.05), full(0.002), thr, full(-60.0), full(441.0)


def exact(name, got, want):
    """Max abs difference of the kernel's outputs from the plain version's;
    raises unless it is 0 (bit for bit, shapes included)."""
    for g, w in zip(got, want):
        g, w = g.cpu(), w.cpu()
        if g.shape != w.shape:
            raise RuntimeError(f"{name}: shape {tuple(g.shape)}, plain "
                               f"{tuple(w.shape)}")
        if not torch.equal(g, w):
            raise RuntimeError(f"{name}: kernel differs from its plain version"
                               f" (max_abs_err {float((g - w).abs().max()):.3e})")
    return 0.0


def check_dynamics(dev, rng, record):
    """Kernels 4 and 5 against their plain versions, exactly: at the
    mastering chain's shape (B=1, n=131072; the plain version, a Python
    loop over time, on a CPU copy of the inputs, timed on the host clock)
    and at a ragged one (B=3, n=4097; the plain version on the card); then
    the gate's edge cases (plain version on the card)."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    sm_hz = float(smi.stdout.strip().splitlines()[0]) * 1e6
    for b, n in ((1, BLOCK), (3, 4097)):
        x, aa, ra, thr, rng_db, hs = dynamics_streams(rng, dev, b, n)
        env0 = torch.full((b,), -120.0, device=dev)
        st0 = torch.stack([env0, torch.zeros_like(env0),
                           torch.full_like(env0, -60.0)], dim=-1)
        plain_dev = torch.device("cpu") if n == BLOCK else dev
        cases = {
            "follower": (functools.partial(follower.follower, x, aa, ra, env0),
                         follower.follower_plain, (x, aa, ra, env0)),
            "gate": (functools.partial(follower.gate, x, aa, ra, thr, rng_db,
                                       hs, st0),
                     follower.gate_plain,
                     (x, aa, ra, thr, rng_db, hs, *st0.unbind(-1))),
        }
        for name, (kernel_fn, plain_fn, args) in cases.items():
            got = kernel_fn()
            args = [a.to(plain_dev) for a in args]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = plain_fn(*args)
            if plain_dev.type == "cuda":
                torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            err = exact(f"{name} B={b} n={n}", got, plain_outputs(name, want))
            ms = time_ms(kernel_fn, 20)
            log(f"  {name} B={b} n={n}: max_abs_err {err:.3e} (bit for bit)  "
                f"kernel {ms:.4f} ms  plain {plain_ms:.1f} ms on {plain_dev.type}")
            serial_ms = n * CHAIN_OPS[name] * CYCLES_PER_OP / sm_hz * 1e3
            log(f"    serial-chain bound {serial_ms:.3f} ms "
                f"({CHAIN_OPS[name]} dependent operations x {CYCLES_PER_OP} "
                f"cycles x {n} samples at {sm_hz / 1e6:.0f} MHz)")
            # inputs read once, outputs written once; OPS_PER_SAMPLE
            # operations per sample and row
            record(name, "mastering" if n == BLOCK else None,
                   (err, ms, plain_ms),
                   nbytes(x, *got) + sum(nbytes(a) for a in args[1:]),
                   OPS_PER_SAMPLE[name] * b * n, kernel_fn, f"B={b} n={n}",
                   plain_device=plain_dev.type, serial_chain_ms=serial_ms)
    for b, n, kind in GATE_EDGES:
        streams = gate_edge_streams(rng, dev, b, n, kind)
        st0 = torch.stack([torch.linspace(-120.0, -20.0, b, device=dev),
                           torch.linspace(0.0, 3.0, b, device=dev),
                           torch.full((b,), -60.0, device=dev)], dim=-1)
        got = follower.gate(*streams, st0)
        want = follower.gate_plain(*streams, *st0.unbind(-1))
        exact(f"gate B={b} n={n} {kind}", got, plain_outputs("gate", want))
        log(f"  gate B={b} n={n} {kind}: bit for bit")


# the smoother groups as the engine keys them, (kind, arg): the default
# inertia and a fast one, the default linear step, the default spring and
# one that settles inside a block, the stepped targets with glides
SMOOTH_KINDS = (("exponential", 1.0 / 256.0), ("exponential", 0.05),
                ("linear", 0.01), ("spring", 4410.0), ("spring", 300.0),
                ("step", 0.0))
SMOOTH_K = 16  # event slots per block (EngineConfig.max_events_per_block)
SMOOTH_LANES = 3
# the largest group of each render path: (rows, n, kind, arg, path)
SMOOTH_PATHS = ((106, BLOCK, "exponential", 1.0 / 256.0, "headline"),
                (8 * 106, BLOCK, "exponential", 1.0 / 256.0,
                 "batched_headline"),
                (19, BLOCK, "exponential", 1.0 / 256.0, "mastering"),
                (8 * 19, BLOCK, "exponential", 1.0 / 256.0, "mastering_lanes"),
                (25, BLOCK, "step", 0.0, "mastering/step"),
                (106, PLAYER_BLOCK, "exponential", 1.0 / 256.0, "player"))
# float32 operations per sample of each kind's closed form (segment search
# included, a transcendental counted as one)
SMOOTH_OPS = {"exponential": 14, "linear": 10, "spring": 30, "step": 8}


def smooth_events(rng, rows, n, k=SMOOTH_K):
    """One block's [rows, k] event times (int64, unused slots at n),
    values and glide flags: row 0 none, row 1 one event at sample 0, row 2
    one at n - 1, row 3 all k slots valid (two at the same time), row 4 two
    events and then masked slots past the block (n + 3), the rest 0-5
    events at random."""
    times = np.full((rows, k), n, np.int64)
    for r in range(rows):
        c = (0, 1, 1, k, 2)[r] if r < 5 else int(rng.integers(0, 6))
        times[r, :c] = np.sort(rng.integers(0, n, c))
    times[1, 0] = 0
    times[2, 0] = n - 1
    times[3, 1] = times[3, 0]
    times[4, 2:] = n + 3
    values = rng.uniform(-2.0, 3.0, (rows, k)).astype(np.float32)
    ramps = (rng.uniform(size=(rows, k)) < 0.5).astype(np.float32)
    return times, values, ramps


def smooth_init(kind, arg, values):
    """A group's initial state, as ``RenderProgram.init_state`` makes it."""
    if kind == "exponential":
        return smoothing.exp_smoother_init(values)
    if kind == "linear":
        return smoothing.lin_smoother_init(values, arg, SR)
    if kind == "spring":
        return smoothing.spring_smoother_init(values)
    return values


def smooth_cases(dev, n, rng, rows=12):
    """Inputs of kernel 6 and its plain version on ``dev``, for each kind
    of :data:`SMOOTH_KINDS`: two blocks from the initial state (the first
    with int32 times, the second from the plain version's state after the
    first: exponential ramps past their freeze point, linear counts that
    run out inside a segment, springs in flight or settling), then the
    lanes' two widening cases: per-lane events over that shared state,
    and shared events over the per-lane state that block left.  Yields
    (label, kind, arg, state, events, ramps)."""
    for kind, arg in SMOOTH_KINDS:
        state = smooth_init(kind, arg, torch.as_tensor(
            rng.uniform(-1.0, 2.0, rows).astype(np.float32), device=dev))
        for label, event_rows in (("block 0 int32", rows), ("block 1", rows),
                                  (f"per-lane events L={SMOOTH_LANES}",
                                   SMOOTH_LANES * rows),
                                  (f"shared events L={SMOOTH_LANES}", rows)):
            t, v, r = smooth_events(rng, event_rows, n)
            ev = smoothing.segment_events(t, v, n, dev)
            if "int32" in label:
                ev = ev._replace(times=ev.times.to(torch.int32))
            ramps = torch.as_tensor(r, device=dev)
            yield (f"smooth {kind} {arg:g} n={n} {label}", kind, arg, state,
                   ev, ramps)
            state, _ = smoothing.smooth_group_plain(kind, arg, SR, state, ev,
                                                    n, ramps)
            # the plain version's targets are column views; the kernel's
            # state, as the engine carries it, is contiguous
            state = (state.contiguous() if kind == "step" else
                     type(state)(*(a.contiguous() for a in state)))


def smooth_outputs(res):
    """(new state, values) -> the state's fields and the values, flat."""
    state, values = res
    fields = (state,) if isinstance(state, torch.Tensor) else tuple(state)
    return fields + (values,)


def ulps(got, want):
    """The largest distance in float32 units in the last place between two
    tensors of the same shape (0: equal bit for bit)."""
    def ordered(x):
        i = x.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    if got.numel() == 0:
        return 0
    return int((ordered(got) - ordered(want)).abs().max())


def smooth_differences(label, got, want):
    """Each output's largest difference in ulps, kernel against plain;
    raises on a shape that differs."""
    out = []
    for g, w in zip(smooth_outputs(got), smooth_outputs(want)):
        if g.shape != w.shape:
            raise RuntimeError(f"{label}: shape {tuple(g.shape)}, plain "
                               f"{tuple(w.shape)}")
        out.append(ulps(g, w))
    return out


def check_smoothers(dev, rng, record):
    """Kernel 6 against its plain version on the card: every case of
    :func:`smooth_cases` at n = 8192 and 131072 must agree bit for bit,
    values and every field of the new state; then each path's largest
    group (:data:`SMOOTH_PATHS`), compared with bound 0 and timed."""
    bad = []
    for n in (PLAYER_BLOCK, BLOCK):
        for label, kind, arg, state, ev, ramps in smooth_cases(dev, n, rng):
            got = smoothing.smooth_kernel(kind, arg, SR, state, ev, n, ramps)
            want = smoothing.smooth_group_plain(kind, arg, SR, state, ev, n,
                                                ramps)
            diff = smooth_differences(label, got, want)
            log(f"  {label}: ulps {diff} (state fields, values)")
            if any(diff):
                bad.append(label)
    if bad:
        raise RuntimeError(f"smooth: kernel differs from its plain version "
                           f"in {bad}")
    for rows, n, kind, arg, path in SMOOTH_PATHS:
        t, v, r = smooth_events(rng, rows, n)
        ev = smoothing.segment_events(t, v, n, dev)
        ramps = torch.as_tensor(r, device=dev)
        state = smooth_init(kind, arg, torch.as_tensor(
            rng.uniform(-1.0, 2.0, rows).astype(np.float32), device=dev))
        fn = functools.partial(smoothing.smooth_kernel, kind, arg, SR, state,
                               ev, n, ramps)
        res = compare(f"smooth {kind} P={rows} n={n}",
                      lambda: smooth_outputs(fn()),
                      lambda: smooth_outputs(smoothing.smooth_group_plain(
                          kind, arg, SR, state, ev, n, ramps)), 0.0,
                      relative=False)
        # the values written once, the events and the state read once
        record("smooth", path, res, 4 * rows * n + nbytes(ev.times, ev.values)
               + 8 * rows, SMOOTH_OPS[kind] * rows * n, fn,
               f"{kind} P={rows} n={n}")


# kernel 7's shapes: (lanes, minimum delay in ms -> the sub-block b at 48
# kHz, path): the mastering chain's delay, the mastering lanes cell's 8
# (b = 8192, W = 50432) and the default minimum delay (b = 1024)
DELAY_SHAPES = ((1, 250.0, "mastering"), (LANES, 250.0, None),
                (LANES, 40.0, None))
# float32 operations per channel and sample: the read (4), the SVF map and
# its step (12), the taps and mix (9), the saturation (10), the DC blocker
# (3), the clamp (2) and the feedback mix (3)
DELAY_OPS = 43


def delay_operands(dev, lanes, min_ms, n=BLOCK):
    """Operands of the feedback loop's second block for ``lanes`` delays
    at the mastering chain's settings (300 ms, feedback 0.4, a 1000 ms
    window) with the LFO on the delay time, over tones; the first block
    rendered by the plain loop.  Returns (operands, sub-block, window)."""
    ctx = BuildCtx(SR, 2, n, 16, torch.float32, dev)
    fx = [delay_fx.DelayEffect(delay_ms=300.0, feedback=0.4, wet=0.3,
                               min_delay_ms=min_ms,
                               max_delay_capacity_ms=1000.0, lfo_to_time=0.5)
          for _ in range(lanes)]
    params = {k: torch.full((lanes, n), float(v), device=dev)
              for k, v in fx[0].param_initials().items()}
    t = torch.arange(2 * n, device=dev, dtype=torch.float64) / SR
    hz = 110.0 * (1.0 + torch.arange(2 * lanes, device=dev)).reshape(lanes, 2, 1)
    tones = (0.4 * torch.sin(2 * np.pi * hz * t)).float()
    seen = []

    def spy(*args):
        seen.append(args)
        return delayline.feedback_loop_plain(*args)

    state = stack_states([e.init_state(ctx) for e in fx])
    loop, delay_fx.feedback_loop = delay_fx.feedback_loop, spy
    try:
        for k in range(2):
            state, _ = fx[0].process(
                {key: (type(v)(*(f.contiguous() for f in v))
                       if isinstance(v, tuple) else v.contiguous())
                 for key, v in state.items()},
                tones[..., k * n:(k + 1) * n].contiguous(), params, ctx)
    finally:
        delay_fx.feedback_loop = loop
    args = seen[-1]
    return args, fx[0]._subblock(ctx), args[1].shape[-1]


def delay_outputs(res):
    wet, line, svf, dc, fb = res
    return (wet, line, *svf, *dc, fb)


def check_delay(dev, record):
    """Kernel 7 against the plain loop on the card at :data:`DELAY_SHAPES`
    (every output, -90 dB of its peak as the other kernels; the card test
    holds it closer), timed with the plain loop beside it.  The bytes: the
    input, the nine per-sample streams and the old window read once, the
    wet signal and the new window written once."""
    for lanes, min_ms, path in DELAY_SHAPES:
        args, b, w = delay_operands(dev, lanes, min_ms)
        fn = functools.partial(delayline.feedback_loop_kernel, *args)
        res = compare(f"delay G={lanes} n={BLOCK} b={b} W={w}",
                      lambda: delay_outputs(fn()),
                      lambda: delay_outputs(
                          delayline.feedback_loop_plain(*args)),
                      DB90, relative=True, reps=(20, 2))
        moved = 4 * lanes * (2 * BLOCK + 9 * BLOCK + 2 * w + 2 * BLOCK + 2 * w)
        record("delay", path, res, moved, DELAY_OPS * 2 * lanes * BLOCK, fn,
               f"G={lanes} n={BLOCK} b={b} W={w}", timed=path is None)


# kernels 8 and 9's shapes: (kernel, lanes, frames, path): the Player's
# master reverb and its 4 sub-mixers' choruses at its block and the
# headline's, the batched headline's LANES of each, the split headline's
# 2 choruses a shard (its master reverb runs unsplit), and 8 lanes
LINE_SHAPES = (("reverb", 1, PLAYER_BLOCK, "player"),
               ("reverb", 1, BLOCK, "headline"),
               ("reverb", LANES, BLOCK, "batched_headline"),
               ("reverb", LANES, PLAYER_BLOCK, None),
               ("chorus", 4, PLAYER_BLOCK, "player"),
               ("chorus", 4, BLOCK, "headline"),
               ("chorus", 4 * LANES, BLOCK, "batched_headline"),
               ("chorus", 2, BLOCK, "graph_sharded"),
               ("chorus", LANES, PLAYER_BLOCK, None))
# float32 operations per channel and sample (a float64 sine counted as one):
# the reverb's allpasses (16), 8 lines' vibrato read, mix, feedback and
# write (8 x 19) and the sums over the lines (11); the chorus's read (6)
# and the line's input (2)
LINE_OPS = {"reverb": 179, "chorus": 8}


def line_operands(dev, kind, lanes, n):
    """Arguments of the effect's plain network (reverb) or line (chorus)
    at its second block for ``lanes`` instances at the Player's settings,
    over tones; the first block rendered by the plain version too."""
    ctx = BuildCtx(SR, 2, n, 16, torch.float32, dev)
    if kind == "reverb":
        fx = reverb_fx.ReverbEffect(room_size=0.6, wet=0.2, min_room_size=0.55)
        mod, name, plain = reverb_fx, "network", reverbnet.network_plain
    else:
        fx = chorus_fx.ChorusEffect()
        mod, name, plain = chorus_fx, "line", chorusline.line_plain
    params = {k: torch.full((lanes, n), float(v), device=dev)
              for k, v in fx.param_initials().items()}
    params["_reset"] = np.zeros(lanes, np.float32)
    t = torch.arange(2 * n, device=dev, dtype=torch.float64) / SR
    hz = 110.0 * (1.0 + torch.arange(2 * lanes, device=dev)).reshape(lanes, 2, 1)
    tones = (0.4 * torch.sin(2 * np.pi * hz * t)).float()
    seen = []

    def spy(*args):
        seen.append(args)
        return plain(*args)

    state = stack_states([fx.init_state(ctx) for _ in range(lanes)])
    routed = getattr(mod, name)
    setattr(mod, name, spy)
    try:
        for k in range(2):
            state, _ = fx.process(state, tones[..., k * n:(k + 1) * n]
                                  .contiguous(), params, ctx)
    finally:
        setattr(mod, name, routed)
    # the kernel's operands as its router hands them on
    return tuple(a.contiguous() if isinstance(a, torch.Tensor) else a
                 for a in seen[-1])


def check_effect_lines(dev, record):
    """Kernels 8 and 9 against their plain versions on the card at
    :data:`LINE_SHAPES` (every output, -90 dB of its peak; the card tests
    hold them bit for bit), timed with the plain versions beside them.  The
    bytes: the streams and old windows read once, the wet signal and new
    windows written once."""
    for kind, lanes, n, path in LINE_SHAPES:
        args = line_operands(dev, kind, lanes, n)
        if kind == "reverb":
            fn = functools.partial(reverbnet.network_kernel, *args[:9])
            plain = functools.partial(reverbnet.network_plain, *args)
            w = args[6].shape[-1] * 4 + args[7].shape[-1] * 8
            per_ch = 3 * n + 2 * w
        else:
            fn = functools.partial(chorusline.line_kernel, *args)
            plain = functools.partial(chorusline.line_plain, *args)
            w = args[3].shape[-1]
            per_ch = 3.5 * n + 2 * w
        label = f"G={lanes} n={n} W={w}"
        res = compare(f"{kind} {label}", fn, plain, DB90, relative=True,
                      reps=(20, 2))
        record(kind, path, res, 4 * 2 * lanes * per_ch,
               LINE_OPS[kind] * 2 * lanes * n, fn, label, timed=path is None)


# kernels 10 and 11 at the synth cell's shape (portbench synth_64v.offline:
# 8 lanes of 64 sub3 voices, 131072-frame blocks, K = 8 trigger slots)
SYNTH_LANES, SYNTH_VOICES, SYNTH_K = 8, 64, 8
# float32 operations per voice sample of kernel 10 at the cell's patch
# (its plain version's elementwise steps: ~150 for the three oscillators,
# ~80 for the two envelopes, ~40 for the LFO and the matrix, ~60 for the
# note, the cutoff, the SVF's coefficients, the operands and the gains),
# and of kernel 11 per row and sample (the tap, two products and sums)
SYNTH_VOICE_OPS, SYNTH_MIX_OPS = 330, 6


def synth_voice_operands(dev, lanes=SYNTH_LANES, voices=SYNTH_VOICES,
                         n=BLOCK, k=SYNTH_K, seed=0):
    """The synth cell's generator (sub3, its LFO / velocity / envelope
    patch) and one block of its inputs on the card: each voice a
    continuing note and k trigger slots, 6 of them used, the cutoff ramped
    across the block.  Returns (generator, state rows, params [L, n],
    lowered inputs [L, V, ...], live)."""
    gen = synth_gen.SynthGenerator(
        synth_defs.sub3(), synth_gen.GeneratorPlaybackOptions(
            voices=voices, volume=0.5), release_secs=0.3)
    gen.with_modulation(ModulationConfig(
        sources=(LfoSource("LFO1", rate=2.0),
                 EnvelopeSource("ENV2", attack=0.005, decay=0.4,
                                sustain=0.2, release=0.3),
                 VelocitySource()), targets=("CUTF", "SHAP")))
    for route in (("LFO1", "CUTF", 0.3, True), ("VELM", "CUTF", 0.4, False),
                  ("ENV2", "SHAP", 0.5, False)):
        gen.set_modulation(*route)
    g = torch.Generator().manual_seed(seed)
    rows = lanes * voices
    t = torch.sort(torch.randint(0, n, (rows, k), generator=g), dim=1).values
    t[:, 6:] = n
    note = torch.randint(36, 85, (rows, k), generator=g).float()
    cont_note = torch.randint(36, 85, (rows,), generator=g).float()
    vs = {"_trig_time": t.to(torch.int32), "_trig_note": note,
          "_trig_vol": 0.3 + 0.7 * torch.rand(rows, k, generator=g),
          "_trig_pan": torch.rand(rows, k, generator=g) - 0.5,
          "_trig_rel": torch.randint(2000, 40000, (rows, k),
                                     generator=g).float(),
          "_trig_spd": torch.exp2((note.double() - 60.0) / 12.0).float(),
          "_cont_active": (torch.rand(rows, generator=g) < 0.8).float(),
          "_cont_note": cont_note,
          "_cont_vol": 0.3 + 0.7 * torch.rand(rows, generator=g),
          "_cont_pan": torch.rand(rows, generator=g) - 0.5,
          "_cont_age0": torch.randint(0, 200000, (rows,),
                                      generator=g).to(torch.int32),
          "_cont_rel": torch.where(torch.rand(rows, generator=g) < 0.5,
                                   float("inf"), 150000.0),
          "_cont_spd": torch.exp2((cont_note.double() - 60.0) / 12.0).float()}
    inputs = {key: a.reshape((lanes, voices) + a.shape[1:]).to(dev)
              for key, a in vs.items()}
    for key, a in (("_mod_amt", gen.modulation.amounts),
                   ("_mod_bip", gen.modulation.bipolar)):
        inputs[key] = torch.as_tensor(a, device=dev).expand(
            lanes, -1, -1).contiguous()
    initial = gen.param_initials()
    params = {q.id: torch.full((lanes, n), float(initial.get(q.id, q.default)),
                               device=dev) for q in gen.PARAMS}
    params["CUTF"] = torch.linspace(400.0, 6000.0, n, device=dev).expand(
        lanes, -1).contiguous()
    ctx = BuildCtx(SR, 2, n, 16, torch.float32, dev)
    state = gen.synth.init(ctx, rows)
    state["phase"] = torch.rand(rows, 3, generator=g).to(dev)
    return gen, state, params, inputs, {}


def synth_plain(gen, state, params, inputs, live, n):
    """The plain version of kernels 10, 2 and 11 on the card: (new state,
    audio [L, 2, n])."""
    lanes, nv = params["SVOL"].shape[0], gen.options.voices
    p, vs = voice_rows(params, inputs, nv)
    voice_no = torch.arange(1, nv + 1, device=params["SVOL"].device).repeat(
        lanes)
    notes = synthvoice.note_logic(vs, live, n, SR, gen.glide_secs)
    return synthvoice.render_plain(
        gen.synth.kernel, state, p, notes,
        (gen.mod_config, vs["_mod_amt"], vs["_mod_bip"]), voice_no, SR,
        lanes, 2, "SVOL", "SPAN")


def check_synth_voice(dev, record):
    """Kernels 10 and 11 (with iir2 between them) against their plain
    version on the card at the synth cell's shape (the lane output and the
    new state, -90 dB of the peak as the other kernels; the card test
    ``tests/test_torch_synthvoice_cuda.py`` holds them to -110 dB of each
    lane's RMS), each kernel timed alone beside its bytes bound and the
    chain beside the plain version.  The bytes: kernel 10 reads the 6
    parameter rows per lane and writes 6 operands and 2 gains per voice
    sample; kernel 11 reads a state and 2 gains per voice sample and
    writes the lanes' stereo output."""
    n = BLOCK
    gen, state, params, inputs, live = synth_voice_operands(dev)
    voice = gen.synth.kernel
    rows = SYNTH_LANES * SYNTH_VOICES
    slots = synthvoice.slot_rows(inputs, live, n)
    mod = synthvoice.sources(voice, gen.mod_config, params,
                             inputs["_mod_amt"], inputs["_mod_bip"], SR)
    args = (voice, state, params, slots, mod, SR, 0.0, 2, "SVOL", "SPAN")

    def outputs(res):
        new, audio = res
        return audio, new["phase"], new["svf"].ic1, new["svf"].ic2

    chain = functools.partial(synthvoice.render_kernels, *args)
    plain = functools.partial(synth_plain, gen, state, params, inputs, live, n)
    label = f"L={SYNTH_LANES} V={SYNTH_VOICES} K={SYNTH_K} n={n}"
    err, chain_ms, plain_ms = compare(
        f"synth_voice + iir2 + synth_mix {label}", lambda: outputs(chain()),
        lambda: outputs(plain()), DB90, relative=True, reps=(10, 2))
    p = {pid: params[pid].contiguous() for pid in (
        voice.shape, voice.detune, voice.cutoff, voice.resonance, "SVOL",
        "SPAN")}
    voice_fn = functools.partial(
        synthvoice.voice_kernel, voice, state["phase"].contiguous(), p,
        slots, mod, SR, 0.0, 2, "SVOL", "SPAN")
    kv = voice_fn()
    s1, s2 = scan.iir2(*kv.operands, state["svf"].ic1, state["svf"].ic2)
    mix_fn = functools.partial(synthvoice.mix_kernel, s1, s2, state["svf"],
                               kv.gains, SYNTH_LANES, 2)
    for name, fn, moved, ops in (
            ("synth_voice", voice_fn,
             4 * (6 * SYNTH_LANES * n + 8 * rows * n),
             SYNTH_VOICE_OPS * rows * n),
            ("synth_mix", mix_fn,
             4 * (3 * rows * n + 2 * SYNTH_LANES * n),
             SYNTH_MIX_OPS * rows * n)):
        ms = time_ms(fn, 10)
        log(f"  {name} {label}: wrapper {ms:.4f} ms")
        record(name, "synth_64v", (err, ms, plain_ms), moved, ops, fn, label,
               chain_ms=chain_ms)


def plain_outputs(name, want):
    """The plain version's outputs in the kernel wrapper's layout."""
    if name == "gate":  # ((env, hold, gain), gains) -> (state [B, 3], gains)
        return torch.stack(want[0], dim=-1), want[1]
    return tuple(want)  # (env_end, env)


# the gate kernel's tile and its target ring of two tiles (csrc/follower.cu)
GATE_TILE = 1024
GATE_EDGES = [(1, n, "random") for n in (
    3, 5, GATE_TILE - 1, GATE_TILE, GATE_TILE + 1,
    2 * GATE_TILE - 1, 2 * GATE_TILE, 2 * GATE_TILE + 1)] + [
    (2, 1100, "hold 0"), (2, 1100, "hold 1"), (1, 1101, "flip"),
    (1, 1100, "expire -1"), (1, 1100, "expire 0"), (1, 1100, "expire +1")]


def gate_edge_streams(rng, dev, b, n, kind):
    """The gate's six streams [b, n] for one edge case: "random" (the
    dynamics_streams inputs), "hold H" (hold_samples H), "flip" (an instant
    follower over 0 / -90 dB on alternate samples, no hold: open and closed
    on consecutive samples), "expire D" (an instant follower open up to a
    sample whose 100-sample hold ends D samples from the second tile's
    start: the range first applies at sample GATE_TILE + D)."""
    x, aa, ra, thr, rng_db, hs = dynamics_streams(rng, dev, b, n)
    if kind.startswith("hold"):
        hs.fill_(float(kind.split()[1]))
    elif kind == "flip":
        x = torch.where(torch.arange(n, device=dev) % 2 == 0, 0.0, -90.0
                        ).expand(b, n).contiguous()
        aa.fill_(1.0), ra.fill_(1.0), hs.fill_(0.0)
    elif kind.startswith("expire"):
        hold = 100
        last_open = GATE_TILE + int(kind.split()[1]) - hold - 1
        x = torch.full((b, n), -90.0, device=dev)
        x[:, :last_open + 1] = 0.0
        aa.fill_(1.0), ra.fill_(1.0), hs.fill_(float(hold))
    return x, aa, ra, thr, rng_db, hs


SASS_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z0-9_.]+)\s*([^;]*);")
SASS_REG = re.compile(r"\bR(\d+)\b")
CHAIN_OPCODES = ("FSETP", "FSEL", "FMUL", "FADD")


def sass_summary(lib_path):
    """One line per kernel of SASS_KERNELS from ``cuobjdump -sass``: its
    shared and global loads and stores by width and, over the innermost
    loops whose body holds the floating-point chain operations (compare,
    select, multiply, add), the fewest instructions from a shared load to the first
    instruction that reads it (through register moves, across the loop's
    back edge).  A load issued that far ahead of its first use
    keeps its latency off the dependent floating-point path as long as
    those instructions take longer to issue than the load takes to land."""
    cuobjdump = Path(kernels._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(lib_path)],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    out = []
    for chunk in text.split("Function : ")[1:]:
        fname = chunk.split(None, 1)[0]
        kernel = next((k for k in SASS_KERNELS if k in fname), None)
        if kernel is None:
            continue
        insns = [(int(m[1], 16), m[3], m[4]) for m in SASS_INSN.finditer(chunk)]
        counts = {}
        for _, op, _ in insns:
            if op.startswith(("LDS", "STS", "LDG", "STG")):
                counts[op] = counts.get(op, 0) + 1
        loops = []
        for addr, op, args in insns:
            target = re.match(r"0x([0-9a-f]+)", args.strip())
            if op == "BRA" and target and int(target[1], 16) < addr:
                loops.append((int(target[1], 16), addr))
        innermost = [(lo, hi) for lo, hi in loops
                     if not any(lo <= a < b <= hi and (a, b) != (lo, hi)
                                for a, b in loops)]
        chain_loops, loads, nearest = 0, 0, None
        for lo, hi in innermost:
            body = [x for x in insns if lo <= x[0] <= hi]
            if not all(any(o.startswith(c) for _, o, _ in body)
                       for c in CHAIN_OPCODES):
                continue
            chain_loops += 1
            for k, (_, o, _) in enumerate(body):
                if o.startswith("LDS"):
                    loads += 1
                    d = _first_use(body, k)
                    if d is not None and (nearest is None or d < nearest):
                        nearest = d
        out.append(f"  {kernel} SASS: {len(insns)} instructions, memory "
                   f"{dict(sorted(counts.items()))}; {chain_loops} innermost "
                   f"chain loops with {loads} shared loads, the nearest use "
                   f"{nearest} instructions after its load")
    return out or [f"  none of {SASS_KERNELS} in the library"]


def _first_use(body, k):
    """Instructions from the shared load body[k] to the first instruction
    that reads what it loaded (directly or through register moves), going
    round the loop body once; None if none does before the registers are
    overwritten."""
    _, op, args = body[k]
    first = SASS_REG.search(args)
    if first is None:
        return None
    width = {"LDS.64": 2, "LDS.128": 4}.get(op.replace(".U", ""), 1)
    regs = {int(first[1]) + w for w in range(width)}
    for d in range(1, len(body)):
        _, o, a = body[(k + d) % len(body)]
        found = [int(r) for r in SASS_REG.findall(a)]
        # the first operand is written when it is a register (stores:
        # an address, read)
        dest = SASS_REG.fullmatch(a.split(",")[0].strip())
        if dest and not o.startswith("ST"):
            reads, writes = set(found[1:]), {found[0]}
        else:
            reads, writes = set(found), set()
        if regs & reads and o.startswith("MOV"):
            regs |= writes
        elif regs & reads:
            return d
        else:
            regs -= writes
        if not regs:
            return None
    return None


def reset_counters():
    """Zero the launch counters and count from now on."""
    tracing.reset()
    tracing.enable()


def read_counters():
    """The launches since :func:`reset_counters`, which stops counting."""
    counts = tracing.counters()
    tracing.disable()
    launches = {k: counts.get(name, 0) for k, name in COUNTERS.items()}
    log(f"    launches {launches}")
    return launches


def render_path(name, make_program, dev, kernels_used, blocks=4,
                once_per_block=(), per_block=None, refs=None):
    """Render ``blocks`` blocks of a program on the card after one warm-up
    block, with the launch counters set to 0 just before; check that each
    kernel of the path launched at least once per block (those of
    ``once_per_block`` exactly once, those of ``per_block`` exactly that
    many times), the audio, and blocks 0-1 against the same program on the
    CPU (kept in ``refs[name]`` when given).  Returns the launches of this
    run and the program."""
    prog = make_program(dev)
    n = prog.ctx.block_frames
    prog.render(n)  # warm-up: allocator and library start-up
    reset_counters()
    audio = timed_render(prog, blocks)
    launches = read_counters()
    idle = [k for k in kernels_used if launches[k] < blocks]
    if idle:
        raise RuntimeError(f"{name}: kernels of the path launched fewer "
                           f"times than the {blocks} blocks: {idle}")
    want = {k: 1 for k in once_per_block} | dict(per_block or {})
    extra = [k for k, c in want.items() if launches[k] != c * blocks]
    if extra:
        raise RuntimeError(f"{name}: kernels not launched exactly "
                           f"{[want[k] for k in extra]} times per block: "
                           f"{extra}")
    check_audio(name, audio, (2, blocks * n))
    ref = against_cpu(name, audio, make_program("cpu"))
    if refs is not None:
        refs[name] = ref
    return launches, prog


def check_audio(name, audio, shape):
    """Raise unless ``audio`` has ``shape``, is finite and is not silent."""
    if audio.shape != shape or not np.isfinite(audio).all():
        raise RuntimeError(f"{name}: bad render: shape {audio.shape}")
    peak = float(np.abs(audio).max())
    if peak < 0.05:
        raise RuntimeError(f"{name}: render is silent: peak {peak}")


def against_cpu(name, audio, cpu_prog):
    """Blocks 0-1 of a card render against the same program rendered on
    the CPU, to -90 dB of each block's peak.  Returns the CPU render."""
    n = cpu_prog.ctx.block_frames
    t0 = time.perf_counter()
    ref = cpu_prog.render(2 * n)
    log(f"  CPU reference render of 2 blocks: {time.perf_counter() - t0:.1f} s")
    for b in range(2):
        sl = slice(b * n, (b + 1) * n)
        err = float(np.abs(audio[:, sl] - ref[:, sl]).max())
        rpeak = float(np.abs(ref[:, sl]).max())
        log(f"  block {b}: max_abs_err {err:.3e} vs CPU, peak {rpeak:.4f}, "
            f"{20 * np.log10(max(err, 1e-30) / rpeak):.1f} dB")
        if not err <= DB90 * rpeak:
            raise RuntimeError(f"{name}: block {b} disagrees with the CPU render")
    return ref


def timed_render(prog, blocks=None):
    """Render ``blocks`` blocks (the natural length if None) on the host
    clock and log the rate."""
    n = prog.ctx.block_frames
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    audio = prog.render(None if blocks is None else blocks * n)
    wall = time.perf_counter() - t0
    log(f"  rendered {audio.shape[-1]} frames ({n}-frame blocks) in "
        f"{wall:.3f} s: {audio.shape[-1] / SR / wall:.1f} audio-seconds per "
        "second")
    return audio


def decoded_file(dev, tmp):
    """Phase 6b: write a FILE_SECS s stereo 16-bit WAV at FILE_SR (partials
    with slow sweeps from a fixed seed), decode it, render it at high
    quality to its natural length, and check the render written through
    ``render_file``.  Returns the program."""
    rng = np.random.default_rng(6)
    frames = FILE_SECS * FILE_SR
    t = np.arange(frames) / FILE_SR
    x = np.zeros((FILE_CH, frames), np.float32)
    for c in range(FILE_CH):
        for f0, sweep, amp in zip(rng.uniform(110, 880, 4),
                                  rng.uniform(-1.0, 1.0, 4),
                                  rng.uniform(0.05, 0.2, 4)):
            x[c] += (amp * np.sin(2 * np.pi * (f0 * t + 0.5 * sweep * t * t))
                     ).astype(np.float32)
    src = Path(tmp) / "in.wav"
    wav_io.write_wav(src, x, FILE_SR, bits=16, float_format=False)
    log(f"  wrote {src.stat().st_size / 1e6:.1f} MB: {FILE_SECS} s, "
        f"{FILE_CH} channels, {FILE_SR} Hz, 16-bit")
    t0 = time.perf_counter()
    buf = AudioFileBuffer.from_file(src)
    log(f"  decoded in {time.perf_counter() - t0:.3f} s: {buf.frames} frames")
    options = FilePlaybackOptions(resampling_quality="high", repeat=0)
    prog = file_program(buf, options, PLAY_BLOCK, dev)
    # FileSource.duration_frames from its definition: the span in source
    # frames over the step per output frame, rounded up
    want = int(np.ceil(frames / (FILE_SR / SR * max(options.speed, 1e-6))))
    if prog.natural_duration_frames() != want:
        raise RuntimeError(f"natural length {prog.natural_duration_frames()}, "
                           f"expected {want}")
    prog.render(PLAY_BLOCK)  # warm-up
    reset_counters()
    audio = timed_render(prog)
    read_counters()
    check_audio("decoded file", audio, (2, want))
    pos = torch.as_tensor(np.arange(PLAY_BLOCK, dtype=np.float32)
                          * np.float32(FILE_SR / SR), device=dev)[None]
    table = prog.file_batches[0].sinc
    ms = time_ms(lambda: resample.sinc_read(prog.file_batches[0].buffers, pos,
                                            table), 20)
    log(f"  sinc_read [1, {FILE_CH}, {buf.frames + 1}] at {PLAY_BLOCK} "
        f"positions: {ms:.4f} ms (CUDA events, plain tensor operations)")
    out = Path(tmp) / "out.wav"
    t0 = time.perf_counter()
    written = render_file(src, out, options, PLAY_BLOCK, dev)
    log(f"  render_file (decode, render, write) in "
        f"{time.perf_counter() - t0:.3f} s")
    back, info = wav_io.read_wav(out)
    log(f"  read back {back.shape[-1]} frames at {info.sample_rate} Hz; "
        f"natural length {want}")
    if written != want or info.sample_rate != SR:
        raise RuntimeError(f"render_file wrote {written} frames at "
                           f"{info.sample_rate} Hz")
    check_audio("render_file", back, (2, want))
    against_cpu("decoded file", back, file_program(buf, options, PLAY_BLOCK,
                                                   "cpu"))
    return prog, src, buf


def lone_program(source, dev):
    """One source on the master at 131072-frame blocks, 48 kHz stereo."""
    main = Mixer("main")
    main.add_source(source)
    return RenderProgram(main, EngineConfig(sample_rate=SR, block_frames=BLOCK),
                         device=dev)


def blocks_against(name, audio, ref, blocks, bounds):
    """Blocks 0..blocks-1 of ``audio`` against ``ref``; block b must stay
    within ``bounds[b]`` x the block's peak of ``ref``."""
    for b in range(blocks):
        sl = slice(b * BLOCK, (b + 1) * BLOCK)
        err = float(np.abs(audio[:, sl] - ref[:, sl]).max())
        rpeak = float(np.abs(ref[:, sl]).max())
        log(f"  block {b}: max_abs_err {err:.3e} vs {name}, peak {rpeak:.4f}, "
            f"{20 * np.log10(max(err, 1e-30) / rpeak):.1f} dB (bound "
            f"{20 * np.log10(bounds[b]):.1f} dB)")
        if not err <= bounds[b] * rpeak:
            raise RuntimeError(f"block {b} disagrees with {name}")


def ulp32(x):
    return float(np.spacing(np.float32(x)))


def streamed_file(dev, path, buf):
    """Phase 6b, streamed: the decoded file's WAV played from disk as a
    ``StreamedFileSource`` at the default quality, 8 blocks of 131072
    frames, timed; the host's window assembly timed alone.  Blocks 0-3
    against the streamed render on the CPU and against the preloaded
    ``FileSource`` on the card.  Returns the streamed program."""
    options = FilePlaybackOptions(repeat=0)
    prog = lone_program(StreamedFileSource(path, options), dev)
    prog.render(BLOCK)  # warm-up
    node = next(iter(prog.nodes.values()))
    t0 = time.perf_counter()
    for b in range(8):
        node.lower_block_inputs(b * BLOCK, BLOCK)
    assemble_ms = (time.perf_counter() - t0) / 8 * 1e3
    w = node._window_frames_cached
    log(f"  window assembly on the host: {assemble_ms:.2f} ms per block "
        f"({w} frames x {FILE_CH} channels, {w * FILE_CH * 4 / 1e6:.2f} MB)")
    audio = timed_render(prog, 8)
    check_audio("streamed", audio, (2, 8 * BLOCK))
    t0 = time.perf_counter()
    ref = lone_program(StreamedFileSource(path, options), "cpu").render(
        4 * BLOCK)
    log(f"  CPU reference render of 4 blocks: {time.perf_counter() - t0:.1f} s")
    blocks_against("the streamed CPU render", audio, ref, 4, [DB90] * 4)
    # against the preloaded source at a step of exactly one source frame
    # per output frame, where both reads are exact: any difference is the
    # window assembly's
    unit = FilePlaybackOptions(repeat=0, speed=SR / FILE_SR)
    step = np.float32(unit.speed) * np.float32(FILE_SR / SR)
    if step != 1.0:
        raise RuntimeError(f"unit step is {step!r}")
    got = lone_program(StreamedFileSource(path, unit), dev).render(4 * BLOCK)
    want = lone_program(FileSource(buf, unit), dev).render(4 * BLOCK)
    log("  streamed against preloaded at a step of exactly 1:")
    blocks_against("the preloaded read", got, want, 4, [DB90] * 4)
    # at the natural speed both read at float32 positions: the preloaded
    # source's absolute ones (its ulp grows with the position in the file)
    # and the streamed source's window-relative ones; bound: their rounding
    # (a half ulp each, and the in-block ramp's) x the file's steepest
    # step x 2 (the Hermite curve's overshoot)
    want = lone_program(FileSource(buf, options), dev).render(4 * BLOCK)
    ratio = FILE_SR / SR
    data = np.asarray(buf.data)
    bounds = []
    for b in range(4):
        end = (b + 1) * BLOCK * ratio
        rnd = 0.5 * ulp32(end) + 2 * ulp32(BLOCK * ratio + 1)
        seg = data[:, int(b * BLOCK * ratio):int(end) + 4]
        slope = float(np.abs(np.diff(seg, axis=-1)).max())
        peak = float(np.abs(want[:, b * BLOCK:(b + 1) * BLOCK]).max())
        bounds.append(2 * rnd * slope / peak)
    log("  streamed against preloaded at speed 1 (float32 position bound):")
    blocks_against("the preloaded read", audio, want, 4, bounds)
    return prog


def synth_phase(dev):
    """Phase 6e: synth_64v through ``RenderProgram.render`` (iir2 exactly
    twice per block: sub3's SVF over 64 voices and the bank's filter),
    ``freq_mult == 1`` on the card for every unautomated note, then the same
    graph in a Player at 8192-frame blocks, blocks 0-3 against the CPU
    Player.  Returns the main path's launches, the program and the
    Player."""
    launches, prog = render_path(
        "synth_64v", lambda d: synth_program(block_frames=BLOCK, device=d),
        dev, ("iir2", "synth_voice", "synth_mix"),
        per_block={"iir2": 2, "synth_voice": 1, "synth_mix": 1})
    notes = torch.arange(128, dtype=torch.float32, device=dev)
    spd = torch.as_tensor(np.float32([2.0 ** ((k - 60) / 12.0)
                                      for k in range(128)]), device=dev)
    exact = int((spd / note_speed(notes) == 1.0).sum())
    log(f"  freq_mult == 1 exactly for {exact} of 128 unautomated notes")
    if exact != 128:
        raise RuntimeError("synth: freq_mult differs from 1 without automation")
    player, cpu = synth_player(device=dev), synth_player(device="cpu")
    reset_counters()
    got = player_blocks(player, 4)
    plaunches = read_counters()
    if plaunches["iir2"] != 2 * 4:
        raise RuntimeError("synth player: iir2 not launched twice per block")
    check_audio("synth player", got[0], (2, 4 * PLAYER_BLOCK))
    against_cpu_player("synth player", got, player_blocks(cpu, 4))
    return launches, prog, player


def batched_phase(dev, prog, single, ref):
    """Phase 6f: the headline graph as LANES independent lanes in one
    ``BatchedRenderProgram``: one warm block, then 4 blocks timed with the
    launch counters set to 0 just before (exactly the single lane's 1
    ramp_read, 9 iir2 and 1 iir1 per block, each over LANES times the
    rows); every lane against the card's single-lane render ``single``
    within 1e-6, lane 0 against the CPU render ``ref`` to -90 dB,
    ``mixdown`` against LANES x the single lane within 1e-4 and
    ``render_scan`` against ``render`` bit for bit.  Then the single-lane
    program ``prog`` and the batched one render 4 blocks each, back to
    back (one lane, lanes, lanes, one lane), for rates measured alike.
    Returns the launches and the batched program."""
    batched = BatchedRenderProgram(
        mixer_graph_program(block_frames=BLOCK, device=dev), lanes=LANES)
    states = batched.init_states()
    batched.step(states, batched.block_inputs(0))  # warm-up
    torch.cuda.synchronize()
    reset_counters()
    t0 = time.perf_counter()
    audio = batched.render(4 * BLOCK)
    wall = time.perf_counter() - t0
    launches = read_counters()
    log(f"  {LANES} lanes x {4 * BLOCK} frames in {wall:.3f} s: aggregate "
        f"{LANES * 4 * BLOCK / SR / wall:.1f} audio-seconds per second")
    want = {"ramp_read": 4, "iir2": 9 * 4, "iir1": 4}
    if {k: launches[k] for k in want} != want:
        raise RuntimeError(f"batched headline: launches {launches}, want "
                           f"{want} over 4 blocks")
    if audio.shape != (LANES, 2, 4 * BLOCK):
        raise RuntimeError(f"batched headline: shape {audio.shape}")
    lane_err = float(np.abs(audio - single[None]).max())
    log(f"  every lane vs the single-lane card render: max_abs_err "
        f"{lane_err:.3e}")
    if not lane_err <= 1e-6:
        raise RuntimeError("batched headline: a lane differs from one lane")
    against_cpu_ref("batched headline lane 0", audio[0], ref)
    mix = BatchedRenderProgram(batched.program, lanes=LANES, mixdown=True)
    _, y = mix.step(mix.init_states(), mix.block_inputs(0))
    mix_err = float(np.abs(y[0].cpu().numpy() - LANES * single[:, :BLOCK]).max())
    log(f"  mixdown vs {LANES} x the single lane: max_abs_err {mix_err:.3e}")
    if y.shape != (1, 2, BLOCK) or not mix_err <= 1e-4:
        raise RuntimeError("batched headline: mixdown disagrees")
    scan = BatchedRenderProgram(
        mixer_graph_program(block_frames=BLOCK, device=dev), lanes=LANES)
    if not np.array_equal(scan.render_scan(4 * BLOCK), audio):
        raise RuntimeError("batched headline: render_scan differs from render")
    log("  render_scan equals render bit for bit")
    for lanes in (1, LANES, LANES, 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (prog if lanes == 1 else batched).render(4 * BLOCK)
        wall = time.perf_counter() - t0
        log(f"  back to back, {lanes} lane(s) x {4 * BLOCK} frames in "
            f"{wall:.3f} s: {lanes * 4 * BLOCK / SR / wall:.2f} audio-seconds "
            "per second")
    return launches, batched


def schedule_lane(prog, k):
    """Lane k's own schedule on a headline program (phase 6h): lane 0 is
    plain; every other lane ramps the master gain and changes one source's
    volume, each its own; lane 3 glides a source's speed (within its step
    bucket), lane 5 stops a source, lane 6 seeks one and lane 7 moves an
    EQ5 band and the chorus depth."""
    if k == 0:
        return
    prog.set_parameter("main/gain", "GAIN", 0.5 + 0.06 * k, at_frame=10000 * k)
    src = f"main/sub{(2 * k) % 4}/src{2 * k}"
    prog.set_parameter(src, "VOLU", 0.1, at_frame=BLOCK // 2 + 1000 * k)
    if k == 3:
        speed = prog.nodes["main/sub1/src1"].options.speed
        top = 2.0 ** np.ceil(np.log2(speed))  # the top of its step bucket
        prog.set_parameter_glide("main/sub1/src1", "SPED",
                                 min(1.15 * speed, top), 6.0, at_frame=20000)
    elif k == 5:
        prog.stop_source("main/sub3/src3", at_frame=BLOCK + 12345)
    elif k == 6:
        prog.nodes["main/sub1/src5"].seek(BLOCK + 100, 3000.0)
    elif k == 7:
        prog.set_parameter("main/sub0/eq", "gan3", 9.0, at_frame=2000)
        prog.set_parameter("main/sub1/chorus", "dpth", 0.9, at_frame=2000)


def headline_lane(k, device):
    prog = mixer_graph_program(block_frames=BLOCK, device=device)
    schedule_lane(prog, k)
    return prog


def lowering_ms(lanes, shard, blocks):
    """Host ms per block to lower the lanes' inputs (each lane program's
    ``block_inputs`` and the batched program's packed copy of them), and
    one lane's alone."""
    def run(progs, prog):
        t0 = time.perf_counter()
        for b in blocks:
            ins = [p.block_inputs(b) for p in progs]
            prog.pack_inputs(ins if len(ins) > 1 else ins[0])
        return (time.perf_counter() - t0) * 1e3 / len(blocks)
    return run(lanes, shard), run(lanes[:1], lanes[0])


def divergent_phase(dev, prog, ref):
    """Phase 6h: the headline graph as LANES lanes of one
    ``BatchedRenderProgram``, each lane's inputs lowered by its own CPU
    program with its own schedule (``schedule_lane``): one warm block,
    then 4 blocks timed with the launch counters set to 0 just before
    (exactly 1 ramp_read, 9 iir2 and 1 iir1 per block); every lane against
    its own single-lane program on the card within 1e-6, lanes 0 and 7
    against their CPU renders to -90 dB (lane 0's is phase 3's, ``ref``),
    the lanes differing by more than
    0.05 of peak; the host lowering per block for LANES lanes and one; the
    single-lane program ``prog`` and the lanes timed back to back; then
    the sampler (config 2) as 4 lanes, each with its notes transposed,
    each against its own card render within 1e-6, 1 ramp_read per block.
    Returns the headline's launches, the batched program, its state after
    the timed blocks and the lane programs."""
    batched = BatchedRenderProgram(
        mixer_graph_program(block_frames=BLOCK, device=dev), lanes=LANES)
    lanes = [headline_lane(k, "cpu") for k in range(LANES)]

    def run(blocks):
        states, outs = batched.init_states(), []
        for b in range(blocks):
            states, y = batched.step(states, [p.block_inputs(b) for p in lanes])
            outs.append(y)
        return states, torch.cat(outs, dim=-1).cpu().numpy()

    run(1)  # warm-up
    torch.cuda.synchronize()
    reset_counters()
    t0 = time.perf_counter()
    states, audio = run(4)
    wall = time.perf_counter() - t0
    launches = read_counters()
    log(f"  {LANES} lanes, each its own inputs, x {4 * BLOCK} frames in "
        f"{wall:.3f} s: aggregate {LANES * 4 * BLOCK / SR / wall:.1f} "
        "audio-seconds per second")
    want = {"ramp_read": 4, "iir2": 9 * 4, "iir1": 4}
    if {k: launches[k] for k in want} != want:
        raise RuntimeError(f"divergent headline: launches {launches}, want "
                           f"{want} over 4 blocks")
    check_audio("divergent headline lane 0", audio[0], (2, 4 * BLOCK))
    if audio.shape != (LANES, 2, 4 * BLOCK):
        raise RuntimeError(f"divergent headline: shape {audio.shape}")
    apart = [float(np.abs(audio[k] - audio[0]).max()) for k in range(LANES)]
    peak = float(np.abs(audio).max())
    log(f"  each lane's largest difference from lane 0: "
        f"{[round(a, 4) for a in apart]}, peak {peak:.4f}")
    if not min(apart[1:]) > 0.05 * peak:
        raise RuntimeError("divergent headline: lanes do not differ")
    errs = []
    for k in range(LANES):
        own = headline_lane(k, dev).render(4 * BLOCK)
        errs.append(float(np.abs(audio[k] - own).max()))
    log(f"  each lane vs its own program on the card: max_abs_err "
        f"{max(errs):.3e} ({[f'{e:.1e}' for e in errs]})")
    if not max(errs) <= 1e-6:
        raise RuntimeError("divergent headline: a lane differs from its own "
                           "program")
    against_cpu_ref("divergent headline lane 0", audio[0], ref)
    t0 = time.perf_counter()
    ref7 = headline_lane(7, "cpu").render(2 * BLOCK)
    log(f"  lane 7's CPU render of 2 blocks: {time.perf_counter() - t0:.1f} s")
    against_cpu_ref("divergent headline lane 7", audio[7], ref7)
    many, one = lowering_ms(lanes, batched.shards[0], range(4, 8))
    log(f"  host lowering per block: {LANES} lanes {many:.2f} ms, one lane "
        f"{one:.2f} ms")
    for k in (1, LANES, LANES, 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if k == 1:
            prog.render(4 * BLOCK)
        else:
            run(4)
        wall = time.perf_counter() - t0
        log(f"  back to back, {k} lane(s) x {4 * BLOCK} frames in "
            f"{wall:.3f} s: {k * 4 * BLOCK / SR / wall:.2f} audio-seconds "
            "per second")

    # the sampler, each lane's notes transposed by its own interval
    shifts = (0, 7, -5, 12)
    pool = BatchedRenderProgram(sampler_program(BLOCK, dev), lanes=len(shifts))
    note_progs = [sampler_program(BLOCK, "cpu", t) for t in shifts]
    st = pool.init_states()
    reset_counters()
    outs = []
    for b in range(3):
        st, y = pool.step(st, [p.block_inputs(b) for p in note_progs])
        outs.append(y)
    got = torch.cat(outs, dim=-1).cpu().numpy()
    slaunches = read_counters()
    if slaunches["ramp_read"] != 3:
        raise RuntimeError(f"sampler lanes: {slaunches['ramp_read']} "
                           "ramp_reads over 3 blocks, want 3")
    serr = [float(np.abs(got[k] - sampler_program(BLOCK, dev, t).render(
        3 * BLOCK)).max()) for k, t in enumerate(shifts)]
    spart = min(float(np.abs(got[k] - got[0]).max()) for k in (1, 2, 3))
    log(f"  sampler, {len(shifts)} lanes transposed {shifts}: each lane vs "
        f"its own card render max_abs_err {max(serr):.3e}; lanes apart by "
        f">= {spart:.3f} (peak {float(np.abs(got).max()):.3f})")
    if not max(serr) <= 1e-6 or not spart > 0.05 * float(np.abs(got).max()):
        raise RuntimeError("sampler lanes: a lane differs from its own "
                           "program, or the lanes do not differ")
    return launches, batched, states, lanes


def frames_later_lanes(dev):
    """Phase 6h, lanes at different frames: the headline graph as 3 lanes
    with schedules 0, 6 and 7, lanes 6 and 7 fed their CPU programs'
    blocks one block later than lane 0's; each lane against its own
    program on the card stepped from ``init_state`` over the same blocks,
    within 1e-6."""
    ks, offsets = (0, 6, 7), (0, 1, 1)
    lanes = [headline_lane(k, "cpu") for k in ks]
    batched = BatchedRenderProgram(
        mixer_graph_program(block_frames=BLOCK, device=dev), lanes=len(ks))
    states, outs = batched.init_states(), []
    for b in range(2):
        states, y = batched.step(states, [p.block_inputs(b + o)
                                          for p, o in zip(lanes, offsets)])
        outs.append(y)
    audio = torch.cat(outs, dim=-1).cpu().numpy()
    errs = []
    for i, (k, o) in enumerate(zip(ks, offsets)):
        own = headline_lane(k, dev)
        st, ys = own.init_state(), []
        for b in range(o, o + 2):
            st, y = own.step(st, own.block_inputs(b))
            ys.append(y)
        want = torch.cat(ys, dim=-1).cpu().numpy()
        check_audio(f"lanes at other frames, lane {i}", want, (2, 2 * BLOCK))
        errs.append(float(np.abs(audio[i] - want).max()))
    log(f"  lanes {ks} starting at blocks {offsets}: each vs its own program "
        f"on the card over the same blocks: max_abs_err {errs}")
    if not max(errs) <= 1e-6:
        raise RuntimeError("lanes at other frames: a lane differs from its "
                           "own program")


def warm(prog):
    """One block from ``init_state``, dropped: allocator and library
    start-up."""
    prog.step(prog.init_state(), prog.block_inputs(0))
    torch.cuda.synchronize()


def sharded_render(prog, blocks):
    """``blocks`` blocks of a program (sharded or not) from its
    ``init_state`` on the host clock; fails unless the current CUDA device
    is the same after each step.  Returns (audio, wall ms per block)."""
    before = torch.cuda.current_device()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, outs = prog.init_state(), []
    for b in range(blocks):
        st, y = prog.step(st, prog.block_inputs(b))
        if torch.cuda.current_device() != before:
            raise RuntimeError(f"a step moved the current device from "
                               f"{before} to {torch.cuda.current_device()}")
        outs.append(y)
    audio = torch.cat(outs, dim=-1).cpu().numpy()
    return audio, (time.perf_counter() - t0) * 1e3 / blocks


GRAPH_SHARDED = {"headline": mixer_graph_program,
                 "mastering": mastering_program}


def graph_sharded_phase(dev):
    """Phase 6i: one graph's banks split over a mesh
    (``GraphShardedProgram``).  The headline graph and the mastering
    chain at full width (131072-frame blocks, 4 blocks) on ``[cuda:0,
    cuda:0]``, each driven with the launch counters set to 0 just before
    and read just after (ramp_read exactly once per shard per block, every
    kernel of the unsharded path launched), and bit for bit equal to its
    unsharded program on the card, with the current device unchanged
    after every step; the same on ``data_mesh(2)`` when two cards are
    present; the headline at 8192-frame blocks on ``[cuda:0, "cpu"]`` (the
    banks' second halves on the CPU: a placement check, where a tensor on
    the wrong device raises) within -90 dB of the unsharded card render;
    and 4 headline lanes on a 2D mesh (2 lane shards, each split over 2
    entries) equal to the 4 lanes on the card.  Logs each path's launches
    and wall per block beside the unsharded program's.  Returns the
    launches of the two full-width paths on ``[cuda:0, cuda:0]`` and their
    sharded programs (profiled in phase 7)."""
    launches, sharded = {}, {}
    meshes = [("[cuda:0, cuda:0]", [dev, dev])]
    if torch.cuda.device_count() >= 2:
        meshes.append(("data_mesh(2)", data_mesh(2)))
    else:
        log("  one card: data_mesh(2) not run")
    for name, make in GRAPH_SHARDED.items():
        ref = make(block_frames=BLOCK, device=dev)
        warm(ref)
        reset_counters()
        want, wall = sharded_render(ref, 4)
        plain = read_counters()
        log(f"  {name} unsharded: {wall:.1f} ms per block")
        for label, mesh in meshes:
            prog = GraphShardedProgram(make(block_frames=BLOCK, device=dev),
                                       mesh)
            warm(prog)
            reset_counters()
            got, wall = sharded_render(prog, 4)
            counts = read_counters()
            split = {k: sorted(v) for k, v in prog._splits.items()}
            log(f"  {name} on {label}: banks split {split}; {wall:.1f} ms "
                f"per block; launches per block "
                f"{ {k: c / 4 for k, c in counts.items()} } against the "
                f"unsharded {({k: c / 4 for k, c in plain.items()})}")
            if counts["ramp_read"] != 4 * len(mesh):
                raise RuntimeError(f"{name} on {label}: {counts['ramp_read']} "
                                   f"ramp_reads over 4 blocks, want "
                                   f"{4 * len(mesh)}")
            idle = [k for k, c in plain.items() if c and not counts[k]]
            if idle:
                raise RuntimeError(f"{name} on {label}: kernels of the path "
                                   f"not launched: {idle}")
            if not np.array_equal(got, want):
                raise RuntimeError(f"{name} on {label}: differs from the "
                                   "unsharded program on the card, max_abs_err "
                                   f"{float(np.abs(got - want).max()):.3e}")
            log(f"  {name} on {label}: equal to the unsharded program bit "
                "for bit; current device unchanged after every step")
            if label.startswith("[cuda:0"):
                launches[name] = counts
                sharded[name] = prog

    small = 8192
    ref = mixer_graph_program(block_frames=small, device=dev)
    warm(ref)
    want, _ = sharded_render(ref, 2)
    mixed = GraphShardedProgram(
        mixer_graph_program(block_frames=small, device=dev), [dev, "cpu"])
    warm(mixed)
    got, wall = sharded_render(mixed, 2)
    err, peak = float(np.abs(got - want).max()), float(np.abs(want).max())
    log(f"  headline on [cuda:0, cpu] at {small}-frame blocks: max_abs_err "
        f"{err:.3e} vs the card, peak {peak:.4f}, "
        f"{20 * np.log10(max(err, 1e-30) / peak):.1f} dB; {wall:.1f} ms per "
        "block")
    if not err <= DB90 * peak:
        raise RuntimeError("headline on [cuda:0, cpu] disagrees with the card")

    lanes = 4
    one = BatchedRenderProgram(mixer_graph_program(block_frames=BLOCK,
                                                   device=dev), lanes=lanes)
    want = one.render(2 * BLOCK)
    two_d = BatchedRenderProgram(
        mixer_graph_program(block_frames=BLOCK, device=dev), lanes=lanes,
        mesh=[[dev, dev], [dev, dev]])
    got = two_d.render(2 * BLOCK)
    if got.shape != (lanes, 2, 2 * BLOCK) or not np.array_equal(got, want):
        raise RuntimeError("2D mesh: the lanes differ from the unsharded "
                           "lanes")
    log(f"  {lanes} headline lanes on a 2D mesh (2 lane shards x 2): equal "
        "to the lanes on one card bit for bit")
    return launches, sharded


def against_cpu_ref(name, audio, ref):
    """Blocks 0-1 of ``audio`` against a CPU render, to -90 dB of each
    block's peak."""
    for b in range(2):
        sl = slice(b * BLOCK, (b + 1) * BLOCK)
        err = float(np.abs(audio[:, sl] - ref[:, sl]).max())
        rpeak = float(np.abs(ref[:, sl]).max())
        log(f"  {name} block {b}: max_abs_err {err:.3e} vs CPU, "
            f"{20 * np.log10(max(err, 1e-30) / rpeak):.1f} dB")
        if not err <= DB90 * rpeak:
            raise RuntimeError(f"{name}: block {b} disagrees with the CPU")


# the port's examples phase 6g renders: name -> arguments
EXAMPLES = {
    "play_file": [], "play_sequence": [], "play_grains": [], "play_synth": [],
    "play_custom": [],
    "play_graph": ["--seconds", "2", "--submixers", "2",
                   "--sources-per-mixer", "2"],
    "play_device": [], "play_web": ["--seconds", "1.5"],
    "play_interactive": ["--selftest"],
}


def run_example(name, out, device):
    """Render a port example offline (``-o``) on ``device``, its printing
    kept; returns the WAV's audio and the seconds it took."""
    argv = [name, "-o", str(out), "--device", device, *EXAMPLES[name]]
    old = sys.argv
    sys.argv = argv
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            runpy.run_module(f"phonic_tpu_torch.examples.{name}",
                             run_name="__main__")
    finally:
        sys.argv = old
    audio, _ = wav_io.read_wav(out)
    return np.asarray(audio), time.perf_counter() - t0


def outputs_phase(tmp):
    """Phase 6g: every port example rendered with ``-o`` on the card and on
    the CPU (equal frame counts, -90 dB of peak); ``RtOutput`` playing 1 s
    of a render; ``WebOutput`` on 127.0.0.1 serving its header and the
    written frames to one read."""
    for name in EXAMPLES:
        card, secs = run_example(name, Path(tmp) / f"{name}.wav", "cuda")
        cpu, cpu_secs = run_example(name, Path(tmp) / f"{name}_cpu.wav", "cpu")
        peak = float(np.abs(cpu).max())
        err = float(np.abs(card - cpu).max()) if card.shape == cpu.shape \
            else float("inf")
        log(f"  example {name}: {card.shape[-1]} frames, card {secs:.2f} s, "
            f"CPU {cpu_secs:.2f} s, max_abs_err {err:.3e}, "
            f"{20 * np.log10(max(err, 1e-30) / peak):.1f} dB of peak "
            f"{peak:.3f}")
        if card.shape != cpu.shape or not np.isfinite(card).all() \
                or peak < 0.05 or not err <= DB90 * peak:
            raise RuntimeError(f"example {name}: card and CPU renders differ")
    block = run_example("play_device", Path(tmp) / "rt.wav", "cuda")[0][:, :SR]
    out = RtOutput(SR, 2)
    try:
        t0 = time.perf_counter()
        for k in range(0, SR, 4800):
            out.write(np.ascontiguousarray(block[:, k:k + 4800]))
        wrote = time.perf_counter() - t0
        time.sleep(0.3)
        log(f"  RtOutput ({'ALSA' if out.uses_alsa else 'paced sink'}, "
            f"{out.sample_format}): 1 s written in {wrote:.3f} s of wall, "
            f"sample_position {out.sample_position} after "
            f"{time.perf_counter() - t0:.3f} s")
        if out.sample_position <= 0:
            raise RuntimeError("RtOutput: no frame played")
    finally:
        out.close()
    web = WebOutput(SR, 2, host="127.0.0.1", port=0, queue_blocks=4)
    try:
        frames = np.ascontiguousarray(block[:, :2048])
        writer = threading.Thread(target=lambda: [web.write(frames)
                                                  for _ in range(4)],
                                  daemon=True)
        writer.start()
        with urllib.request.urlopen(web.url + "stream.wav", timeout=10) as req:
            hdr = req.read(44)
            body = req.read(2048 * 2 * 4)
        writer.join(timeout=10)
        got = np.frombuffer(body, np.float32).reshape(-1, 2).T
        if hdr != _wav_stream_header(SR, 2) or not np.array_equal(got, frames):
            raise RuntimeError("WebOutput: bad header or frames")
        log(f"  WebOutput on {web.url}: header and {got.shape[1]} frames "
            "served back")
    finally:
        web.close()


def profile_block(run):
    """Run one block (``run()``) under ``torch.profiler``.  Returns its
    device operations, host-to-device copies, ``cudaStreamSynchronize``
    calls, device ms, wall ms, ``cudaMemcpyAsync`` calls and the device's
    copies by name."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    ops = [e for e in events if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.time_range.elapsed_us() for e in ops) / 1e3
    h2d = sum("HtoD" in e.name for e in ops)
    host = collections.Counter(e.name for e in events
                               if e.device_type == DeviceType.CPU)
    copies = collections.Counter(e.name for e in ops if "Memcpy" in e.name)
    return (len(ops), h2d, host["cudaStreamSynchronize"], device_ms, wall_ms,
            host["cudaMemcpyAsync"], copies)


def log_busy(name, ops, h2d, syncs, device_ms, wall_ms, memcpy_calls,
             copies):
    log(f"  {name}: one block under the profiler: {ops} device operations "
        f"({h2d} host-to-device copies), {syncs} cudaStreamSynchronize, "
        f"{device_ms:.2f} ms of device time in {wall_ms:.1f} ms of wall: "
        f"device busy {100 * device_ms / wall_ms:.1f} %; "
        f"{memcpy_calls} cudaMemcpyAsync, copies {dict(copies)}")


def device_busy(name, prog):
    """Render one block after a warm-up block under ``torch.profiler`` and
    log its device operations, host-to-device copies, stream
    synchronisations, device time, wall time and busy share."""
    state, _ = prog.step(prog.init_state(), prog.block_inputs(0))
    torch.cuda.synchronize()
    log_busy(name, *profile_block(
        lambda: prog.step(state, prog.block_inputs(1))[1].cpu()))


def player_busy(player, name="player", strict=False):
    """One ``render_block`` of the Player (packed inputs, the step, the
    copies of its audio and levels back) under the profiler, logged as
    ``device_busy`` logs a block; then one more with PyTorch's sync debug
    mode on, logging each synchronising call it reports and where.  With
    ``strict``, a ``cudaStreamSynchronize`` in the profiled block or a
    reported synchronising call fails the run."""
    player.render_block()
    torch.cuda.synchronize()
    busy = profile_block(player.render_block)
    log_busy(name, *busy)
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            player.render_block()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    where = collections.Counter(
        f"{Path(w.filename).name}:{w.lineno} {str(w.message)[:60]}"
        for w in caught)
    log(f"  {name}: {len(caught)} synchronising calls reported in one "
        f"render_block{': ' if where else ''}"
        + "; ".join(f"{k} (x{v})" for k, v in where.items()))
    if strict and (busy[2] or caught):
        raise RuntimeError(f"{name}: render_block synchronises: {busy[2]} "
                           f"cudaStreamSynchronize, {len(caught)} reported")


def player_blocks(player, blocks):
    """Render ``blocks`` blocks through ``render_block``: the audio, and
    per block every mixer's peak and RMS in walk order, [mixers, 2, ch]."""
    audio, levels = [], []
    for _ in range(blocks):
        audio.append(player.render_block())
        levels.append(np.array([
            [player.mixer_audio_level(obj).peak,
             player.mixer_audio_level(obj).rms]
            for _, kind, obj in player.main_mixer.walk() if kind == "mixer"]))
    return np.concatenate(audio, axis=1), levels


def against_cpu_player(name, got, ref, first=0, n=PLAYER_BLOCK):
    """Blocks ``first``, ... of a card Player against the same Player on the
    CPU: the audio and every mixer's levels to -90 dB of the block's
    peak."""
    (audio, levels), (want, want_levels) = got, ref
    for b, (lv, wlv) in enumerate(zip(levels, want_levels)):
        sl = slice(b * n, (b + 1) * n)
        err = float(np.abs(audio[:, sl] - want[:, sl]).max())
        rpeak = float(np.abs(want[:, sl]).max())
        lerr = float(np.abs(lv - wlv).max()) if lv.shape == wlv.shape else np.inf
        log(f"  block {first + b}: max_abs_err {err:.3e} vs CPU, peak "
            f"{rpeak:.4f}, {20 * np.log10(max(err, 1e-30) / rpeak):.1f} dB; levels of "
            f"{len(lv)} mixers {lerr:.3e}")
        if not (err <= DB90 * rpeak and lerr <= DB90 * rpeak):
            raise RuntimeError(f"{name}: block {b} disagrees with the CPU")


def time_player(player, depth, min_blocks=10, min_secs=1.0):
    """bench.py's pump loop: ``run(8 * n)`` until at least ``min_blocks``
    blocks and ``min_secs`` seconds (host clock; ``run`` returns once its
    last block is on the host).  Returns (x realtime, blocks, seconds)."""
    player.config.pipeline_depth = depth
    n = player.engine_config.block_frames
    torch.cuda.synchronize()
    blocks, t0 = 0, time.perf_counter()
    while True:
        player.run(8 * n)
        blocks += 8
        if blocks >= min_blocks and time.perf_counter() - t0 > min_secs:
            break
    dt = time.perf_counter() - t0
    return blocks * n / SR / dt, blocks, dt


def player_phase(dev):
    """Phase 6d.  Returns the launches of the main path's run and a warm
    player_rt Player for phase 7."""
    player = player_rt_player(device=dev)
    cpu = player_rt_player(device="cpu")
    reset_counters()
    t0 = time.perf_counter()
    got = player_blocks(player, 4)
    log(f"  blocks 0-3 through render_block in "
        f"{time.perf_counter() - t0:.3f} s (block 0 builds the program)")
    launches = read_counters()
    idle = [k for k in ("ramp_read", "iir2", "iir1") if launches[k] < 4]
    if idle or launches["ramp_read"] != 4:
        raise RuntimeError(f"player: kernels of the path idle {idle}, or "
                           "not one ramp_read per block")
    check_audio("player", got[0], (2, 4 * PLAYER_BLOCK))
    t0 = time.perf_counter()
    ref = player_blocks(cpu, 4)
    log(f"  CPU reference of 4 blocks: {time.perf_counter() - t0:.1f} s")
    against_cpu_player("player", got, ref)
    # a topology rebuild mid-render that adopts the running state
    for p in (player, cpu):
        for src in [o for _, k, o in p.main_mixer.walk() if k == "source"][::2]:
            p.remove_source(src)
    got, ref = player_blocks(player, 2), player_blocks(cpu, 2)
    log(f"  8 of 16 sources removed at block 4: {player.rebuilds} rebuild, "
        f"{len(player._program.source_paths)} sources left")
    if player.rebuilds != 1:
        raise RuntimeError("player: the removal did not rebuild once")
    against_cpu_player("player after the rebuild", got, ref, first=4)
    # bench.py's timing, on the full graph: depths in turns
    player = player_rt_player(device=dev)
    player.render_block()
    for depth in (1, 3, 3, 1):
        rate, blocks, secs = time_player(player, depth)
        log(f"  Player.run at pipeline depth {depth}: {blocks} blocks in "
            f"{secs:.3f} s: {rate:.2f}x realtime")
    log(f"  retirement rebuilds during the timed runs: {player.rebuilds} "
        "(the sources are endless, repeat=None)")
    # the per-source CPU-load probe: one source alone, timed with CUDA
    # events on the card
    probe = Player(NullOutput(SR, 2), PlayerConfig(block_frames=PLAYER_BLOCK),
                   device=dev)
    handle = probe.play_file(tone(frames=26655), FilePlaybackOptions(
        repeat=None, measure_cpu_load=True))
    probe.render_block()
    load = handle.cpu_load()
    log(f"  source_cpu_load of one file source: average {load.average:.2e}, "
        f"peak {load.peak:.2e} of a block's {PLAYER_BLOCK / SR:.3f} s")
    if not 0.0 < load.average <= load.peak:
        raise RuntimeError(f"source_cpu_load: {load}")
    return launches, player


def kernel_times(calls, reps=20):
    """Each recorded call's kernel-only time (``kernel_time``) and share of
    its bound, logged and kept with its numbers."""
    for name, label, fn, nums in calls:
        ms, per_call = kernel_time(name, fn, reps)
        nums.update(kernel_ms=ms, launches_per_call=per_call)
        log(f"  {name} {label}: kernel-only {ms:.4f} ms, {per_call} launches "
            f"per call, {100 * nums['bound_ms'] / ms:.1f} % of its "
            f"{nums['bound_by']} bound ({nums['bound_ms']:.4f} ms)")


def kernel_report(measured, off_path, paths):
    """The kernels JSON object.  Top-level numbers are the mastering
    chain's (iir2's and iir1's the headline's: the mastering chain runs
    neither): its launches and each kernel's numbers at its shape;
    ``by_path`` holds each path's and ``off_path`` those of the shapes
    timed off the paths."""
    report = {"kernels": []}
    for name in COUNTERS:
        by_path = measured[name]
        if "batched_headline" in by_path and "divergent_headline" in paths:
            # per-lane inputs: the same kernels at the same shapes
            by_path["divergent_headline"] = dict(by_path["batched_headline"])
        if "graph_sharded" not in by_path and "graph_sharded" in paths:
            # the split keeps the master chains whole on the first device:
            # the mastering chain's dynamics and the headline's iir1 and
            # reverb run at their unsharded shapes
            by_path["graph_sharded"] = dict(
                by_path["headline" if name in ("iir1", "iir2", "reverb")
                        else "mastering"])
        for key, nums in by_path.items():
            # a path's second shape ("synth_64v/filter") shares its launches
            launches = paths.get(key.split("/")[0])
            if launches is not None:
                nums["launches"] = launches[name]
        report["kernels"].append({
            "name": name, "route": "cuda", "source": SOURCES[name][0],
            "replaces": SOURCES[name][1],
            **{k: (by_path.get("mastering") or by_path.get("headline")
                   or next(iter(by_path.values())))[k] for k in (
                "launches", "max_abs_err", "ms", "kernel_ms", "plain_ms",
                "bound_ms", "bound_by")},
            # no single PyTorch call computes any of these functions;
            # "replaces" is None for the smoothers and the delay, which had
            # no TPU kernel
            "library_ms": None, "by_path": by_path,
            "off_path": off_path[name]})
    return report


def main():
    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
        check=True)
    log(smi.stdout.strip().splitlines()[0])
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}")

    phase("1: build")
    t0 = time.perf_counter()
    path = kernels.library_path()
    kernels.library()
    log(f"  built {path.name} in {time.perf_counter() - t0:.1f} s")
    log((path.parent / "build.log").read_text().strip())
    for line in sass_summary(path):
        log(line)

    phase("2: kernels against their plain versions")
    measured, off_path, calls = check_kernels(dev)
    paths, progs, refs = {}, {}, {}
    phase("3: headline graph on the card")
    paths["headline"], progs["headline"] = render_path(
        "headline", lambda d: mixer_graph_program(block_frames=BLOCK, device=d),
        dev, ("ramp_read", "iir2", "iir1"),
        per_block={"reverb": 1, "chorus": 1}, refs=refs)
    phase("4: mastering chain on the card")
    paths["mastering"], progs["mastering"] = render_path(
        "mastering", lambda d: mastering_program(block_frames=BLOCK, device=d),
        dev, ("ramp_read", "follower", "gate", "smooth", "delay"),
        per_block={"delay": 1, "iir2": 0, "iir1": 0})
    phase("5: the 64-voice sampler on the card")
    paths["sampler"], progs["sampler"] = render_path(
        "sampler", lambda d: sampler_program(block_frames=BLOCK, device=d),
        dev, ("ramp_read",))
    phase("6a: play_file, bench.py's config 1, on the card")
    paths["play_file"], progs["play_file"] = render_path(
        "play_file", lambda d: play_file_program(device=d), dev, ("ramp_read",))
    phase("6b: play_file, a decoded 180 s file at high quality, on the card")
    # the streamed program reads the file again in phase 7
    tmp = tempfile.TemporaryDirectory()
    progs["decoded_file"], src, buf = decoded_file(dev, tmp.name)
    phase("6b: the same file streamed from disk, on the card")
    progs["streamed"] = streamed_file(dev, src, buf)
    phase("6c: granular_1k, bench.py's config 4, on the card")
    # the grain mix is a float32 matrix product: TF32 would put the card
    # some 60 dB from the CPU
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError("float32 matrix products are set to run in TF32")
    paths["granular"], progs["granular"] = render_path(
        "granular", lambda d: granular_program(block_frames=BLOCK, device=d),
        dev, ("ramp_read",), once_per_block=("ramp_read",))
    phase("6d: player_rt_8192, bench.py's config_player_rt, on the card")
    paths["player"], player = player_phase(dev)
    phase("6e: synth_64v, the synth path, on the card")
    paths["synth_64v"], progs["synth_64v"], synth_pl = synth_phase(dev)
    phase(f"6f: the headline graph as {LANES} lanes of one batched program")
    single = progs["headline"].render(4 * BLOCK)
    paths["batched_headline"], batched = batched_phase(
        dev, progs["headline"], single, refs["headline"])
    phase("6g: the port's examples, RtOutput and WebOutput on the card")
    outputs_phase(tmp.name)
    phase(f"6h: the headline graph as {LANES} lanes, each its own inputs")
    paths["divergent_headline"], divergent, div_states, div_lanes = \
        divergent_phase(dev, progs["headline"], refs["headline"])
    frames_later_lanes(dev)
    phase("6i: one graph's banks split over a mesh (GraphShardedProgram)")
    split_launches, split_progs = graph_sharded_phase(dev)
    paths["graph_sharded"] = {k: sum(c[k] for c in split_launches.values())
                              for k in COUNTERS}
    # a profiler session leaves launches slower for the rest of the process,
    # so every profiled number comes after the timed renders
    phase("7: under the profiler")
    for name, prog in progs.items():
        device_busy(name, prog)
    device_busy("batched_headline", batched.shards[0])
    for name, prog in split_progs.items():
        device_busy(f"graph_sharded_{name} on [cuda:0, cuda:0]", prog)
    # a per-lane block after the timed ones: the smoothers already per lane
    log_busy("divergent_headline", *profile_block(lambda: divergent.step(
        div_states, [p.block_inputs(4) for p in div_lanes])[1].cpu()))
    player_busy(player)
    player_busy(synth_pl, "synth player", strict=True)
    kernel_times(calls)
    log("  the headline graph again, after the profiler:")
    timed_render(progs["headline"], 4)
    tmp.cleanup()

    log(f"done in {time.perf_counter() - START:.1f} s")
    # the card's name and power limit again, beside the numbers (a caller
    # that keeps only the end of the output still sees them)
    log(smi.stdout.strip().splitlines()[0])
    log(json.dumps(kernel_report(measured, off_path, paths)))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

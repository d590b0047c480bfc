"""GPU smoke test of the PyTorch port: build the CUDA kernels, check each
against its plain PyTorch version on the card, then render the headline
mixer graph, the mastering chain, the 64-voice sampler, the play_file path
and the granular sampler at full width on the card and check them.

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
   that start unaligned), one row and forty.  The follower and
   the gate must agree with their plain versions exactly; at 131072
   samples their plain versions (a Python loop over time) run on a CPU
   copy of the card's inputs.  The gate also runs edge cases: lengths at
   its tile and target-ring sizes and one off, holds of 0 and 1 samples, a
   gate that flips on every sample, and holds that run out just before, at
   and after a tile boundary;
3. the headline graph (16 file sources -> 4 sub-mixers with EQ5 + chorus ->
   reverb + gain, 131072-frame blocks at 48 kHz stereo) rendered on the card
   through ``RenderProgram.render``: the launch counters of its kernels
   (ramp read, iir2, iir1) must grow, the audio must be finite and not
   silent, and its first two blocks must match the same program rendered
   on the CPU to -90 dB of peak;
4. the mastering chain (4 looping file sources -> gate -> compressor ->
   delay -> distortion -> limiter, 131072-frame blocks at 48 kHz stereo),
   checked the same way; all five kernels' counters must grow.  It also
   times one roll of the delay's window at its shapes;
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
   the sinc read's time at that shape is logged; (c) the granular sampler
   (bench.py's config 4: 10 voices, each keeping a pool of 100 one-second
   grains full at 100 Hz density, over a 96000-frame tone, 131072-frame
   blocks at 48 kHz stereo), checked the same way; every grain of a block
   reads in exactly one ramp_read, and float32 matrix products must not
   run in TF32 (the grain mix is one);
7. under ``torch.profiler``, after every timed render (a profiler session
   slows the launches that follow it in the process): one more block of
   each path, which gives the device operations, the host-to-device
   copies and the device time per block and the device's busy share
   (device time over that block's wall time, both under the profiler);
   each kernel's kernel-only device time (the profiler's events of its own
   launches, and their number per call) and its share of its bound, at
   each path's shape and at the byte-bound shapes off the paths (iir2 and
   iir1 at R=40); and the headline graph's rate once more, after the
   profiler.

The line before the last is a JSON object with each kernel's numbers from
this run: at top level those of the mastering chain, which runs all five
kernels, under ``by_path`` those of each path and under ``off_path`` those
of the shapes timed off the paths.  The last line is
``{"ok": true, "device": {...}}``.
"""

import functools
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from phonic_tpu_torch import kernels
from phonic_tpu_torch.effects.delay import DelayEffect
from phonic_tpu_torch.generators.granular import source_table
from phonic_tpu_torch.granular1k import granular_program
from phonic_tpu_torch.headline import mixer_graph_program
from phonic_tpu_torch.io import wav as wav_io
from phonic_tpu_torch.io.decoder import AudioFileBuffer
from phonic_tpu_torch.mastering import mastering_program
from phonic_tpu_torch.ops import chrono, follower, rampread, resample, scan
from phonic_tpu_torch.play_file import (
    BLOCK_FRAMES as PLAY_BLOCK, file_program, play_file_program, render_file,
)
from phonic_tpu_torch.sampler64 import sampler_program
from phonic_tpu_torch.sources.file import FilePlaybackOptions

BLOCK = 131072
SR = 48000
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

# launch counters: kernel -> (module, attribute)
COUNTERS = {"ramp_read": (rampread, "launches"),
            "iir2": (scan, "iir2_launches"),
            "iir1": (scan, "iir1_launches"),
            "follower": (follower, "follower_launches"),
            "gate": (follower, "gate_launches")}
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
                    "phonic_tpu/ops/follower.py:140")}


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
    for r, t, path in ((8, BLOCK, "headline"), (2, 8192, "mastering"),
                       (2, BLOCK, None), (1, 4095, None), (1, 4096, None),
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
    for r, t, path in ((2, BLOCK, "headline"), (2, 8192, "mastering"),
                       (2, 999, None), (7, BLOCK, None), (7, 999, None),
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
    for mod, attr in COUNTERS.values():
        setattr(mod, attr, 0)


def read_counters():
    launches = {k: getattr(mod, attr) for k, (mod, attr) in COUNTERS.items()}
    log(f"    launches {launches}")
    return launches


def render_path(name, make_program, dev, kernels_used, blocks=4,
                once_per_block=()):
    """Render ``blocks`` blocks of a program on the card after one warm-up
    block, with the launch counters set to 0 just before; check that each
    kernel of the path launched at least once per block (those of
    ``once_per_block`` exactly once), the audio, and blocks 0-1 against the
    same program on the CPU.  Returns the launches of this run and the
    program."""
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
    extra = [k for k in once_per_block if launches[k] != blocks]
    if extra:
        raise RuntimeError(f"{name}: kernels not launched exactly once per "
                           f"block: {extra}")
    check_audio(name, audio, (2, blocks * n))
    against_cpu(name, audio, make_program("cpu"))
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
    the CPU, to -90 dB of each block's peak."""
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
    return prog


def device_busy(name, prog):
    """Render one block after a warm-up block under ``torch.profiler`` and
    log its device operations, host-to-device copies, device time, wall
    time and busy share."""
    state, _ = prog.step(prog.init_state(), prog.block_inputs(0))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, y = prog.step(state, prog.block_inputs(1))
        y.cpu()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.time_range.elapsed_us() for e in ops) / 1e3
    h2d = sum("HtoD" in e.name for e in ops)
    log(f"  {name}: one block under the profiler: {len(ops)} device operations "
        f"({h2d} host-to-device copies), {device_ms:.2f} ms of device time in "
        f"{wall_ms:.1f} ms of wall: device busy {100 * device_ms / wall_ms:.1f} %")


def roll_cost(prog, dev, reps=200):
    """Log the host and device time of one roll of the delay's window
    (``chrono.roll``) at the shapes the render gives it."""
    delay = next(n for n in prog.nodes.values() if isinstance(n, DelayEffect))
    win = delay.init_state(prog.ctx)["line"].hist[None]
    writes = torch.ones(win.shape[:-1] + (delay._subblock(prog.ctx),),
                        device=dev)
    chrono.roll(win, writes)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        win = chrono.roll(win, writes)
    end.record()
    host_us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    log(f"  delay window roll {list(win.shape)} <- {list(writes.shape)}: "
        f"device {start.elapsed_time(end) / reps * 1e3:.1f} us, host "
        f"{host_us:.1f} us per call")


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
    chain's, the path that runs all five kernels: its launches and each
    kernel's numbers at its shape; ``by_path`` holds each path's and
    ``off_path`` those of the shapes timed off the paths."""
    report = {"kernels": []}
    for name in COUNTERS:
        by_path = measured[name]
        for path, launches in paths.items():
            if path in by_path:
                by_path[path]["launches"] = launches[name]
        report["kernels"].append({
            "name": name, "route": "cuda", "source": SOURCES[name][0],
            "replaces": SOURCES[name][1],
            **{k: by_path["mastering"][k] for k in (
                "launches", "max_abs_err", "ms", "kernel_ms", "plain_ms",
                "bound_ms", "bound_by")},
            # no single PyTorch call computes any of these functions
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
    paths, progs = {}, {}
    phase("3: headline graph on the card")
    paths["headline"], progs["headline"] = render_path(
        "headline", lambda d: mixer_graph_program(block_frames=BLOCK, device=d),
        dev, ("ramp_read", "iir2", "iir1"))
    phase("4: mastering chain on the card")
    paths["mastering"], progs["mastering"] = render_path(
        "mastering", lambda d: mastering_program(block_frames=BLOCK, device=d),
        dev, tuple(COUNTERS))
    roll_cost(progs["mastering"], dev)
    phase("5: the 64-voice sampler on the card")
    paths["sampler"], progs["sampler"] = render_path(
        "sampler", lambda d: sampler_program(block_frames=BLOCK, device=d),
        dev, ("ramp_read",))
    phase("6a: play_file, bench.py's config 1, on the card")
    paths["play_file"], progs["play_file"] = render_path(
        "play_file", lambda d: play_file_program(device=d), dev, ("ramp_read",))
    phase("6b: play_file, a decoded 180 s file at high quality, on the card")
    with tempfile.TemporaryDirectory() as tmp:
        progs["decoded_file"] = decoded_file(dev, tmp)
    phase("6c: granular_1k, bench.py's config 4, on the card")
    # the grain mix is a float32 matrix product: TF32 would put the card
    # some 60 dB from the CPU
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError("float32 matrix products are set to run in TF32")
    paths["granular"], progs["granular"] = render_path(
        "granular", lambda d: granular_program(block_frames=BLOCK, device=d),
        dev, ("ramp_read",), once_per_block=("ramp_read",))
    # a profiler session leaves launches slower for the rest of the process,
    # so every profiled number comes after the timed renders
    phase("7: under the profiler")
    for name, prog in progs.items():
        device_busy(name, prog)
    kernel_times(calls)
    log("  the headline graph again, after the profiler:")
    timed_render(progs["headline"], 4)

    log(f"done in {time.perf_counter() - START:.1f} s")
    log(json.dumps(kernel_report(measured, off_path, paths)))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

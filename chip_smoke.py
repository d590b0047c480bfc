"""GPU smoke test of the PyTorch port: build the CUDA kernels, check each
against its plain PyTorch version on the card, then render the headline
mixer graph and the mastering chain at full width on the card and check
them.

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``; exits non-zero without them or when any
phase fails.  Phases:

1. build ``phonic_tpu_torch/csrc/*.cu`` (sm_90a, one nvcc per source, in
   parallel) and print the build time and the compiler's register /
   shared-memory report;
2. each kernel against its plain version on the same inputs, at the render
   paths' shapes and at ragged ones, with its time beside the plain
   version's (CUDA events).  The follower and the gate must agree with
   their plain versions exactly; at 131072 samples their plain versions
   (a Python loop over time) run on a CPU copy of the card's inputs;
3. the headline graph (16 file sources -> 4 sub-mixers with EQ5 + chorus ->
   reverb + gain, 131072-frame blocks at 48 kHz stereo) rendered on the card
   through ``RenderProgram.render``: the launch counters of its kernels
   (ramp read, iir2, iir1) must grow, the audio must be finite and not
   silent, and its first two blocks must match the same program rendered
   on the CPU to -90 dB of peak.  One more block, rendered under
   ``torch.profiler``, gives the device operations and device time per
   block and the device's busy share (device time over that block's wall
   time, both under the profiler);
4. the mastering chain (4 looping file sources -> gate -> compressor ->
   delay -> distortion -> limiter, 131072-frame blocks at 48 kHz stereo),
   checked the same way; all five kernels' counters must grow.  It also
   times one roll of the delay's window at its shapes.

The line before the last is a JSON object with each kernel's numbers from
this run: at top level those of the mastering chain, which runs all five
kernels, and under ``by_path`` those of each path.  The last line is
``{"ok": true, "device": {...}}``.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from phonic_tpu_torch import kernels
from phonic_tpu_torch.effects.delay import DelayEffect
from phonic_tpu_torch.headline import mixer_graph_program
from phonic_tpu_torch.mastering import mastering_program
from phonic_tpu_torch.ops import chrono, follower, rampread, scan

BLOCK = 131072
SR = 48000
DB90 = 10.0 ** (-90.0 / 20.0)
RAMP_TOL = 1e-5  # unit-scale data; FMA contraction vs the plain x-form
# published H100 SXM peaks (NVIDIA data sheet): device memory rate, and the
# float32 rate outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
# dependent operations per sample on the follower's and the gate's serial
# chain (csrc/follower.cu), at ~4 cycles of latency each
CHAIN_OPS = {"follower": 4, "gate": 10}
CYCLES_PER_OP = 4
# all operations per sample (compares, selects and arithmetic)
OPS_PER_SAMPLE = {"follower": 5, "gate": 15}

# launch counters: kernel -> (module, attribute)
COUNTERS = {"ramp_read": (rampread, "launches"),
            "iir2": (scan, "iir2_launches"),
            "iir1": (scan, "iir1_launches"),
            "follower": (follower, "follower_launches"),
            "gate": (follower, "gate_launches")}
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


def check_kernels(dev):
    """Each kernel against its plain version at the shape each render path
    gives it and at ragged ones.  Returns {kernel: {path: numbers}}."""
    rng = np.random.default_rng(0)
    results = {name: {} for name in COUNTERS}

    def record(name, path, res, moved, ops, **extra):
        if path is not None:
            bound_ms, bound_by = bound(moved, ops)
            results[name][path] = dict(
                max_abs_err=res[0], ms=res[1], plain_ms=res[2],
                bound_ms=bound_ms, bound_by=bound_by, **extra)

    # lanes, channels, table frames (longest buffer + guard), outputs, path
    for lanes, ch, frames, n, path in (
            (16, 1, 26656, BLOCK, "headline"), (4, 1, 48001, BLOCK, "mastering"),
            (16, 1, 26656, 1000, None), (16, 2, 26656, BLOCK, None),
            (16, 2, 26656, 1000, None)):
        src = torch.as_tensor(rng.normal(size=(lanes, ch, frames)).astype(
            np.float32), device=dev)
        smap = torch.arange(lanes, dtype=torch.int32, device=dev)
        pos = torch.as_tensor(ramp_positions(rng, lanes, n, frames), device=dev)
        res = compare(f"ramp_read B={lanes} ch={ch} F={frames} N={n}",
                      lambda: rampread.ramp_read(src, smap, pos),
                      lambda: rampread.ramp_read_plain(src, smap, pos),
                      RAMP_TOL, relative=False)
        # each output: a position, 4 taps and the Hermite sum
        record("ramp_read", path, res, nbytes(src, smap, pos) + 4 * lanes * ch * n,
               20 * lanes * ch * n, shape=f"B={lanes} ch={ch} F={frames} N={n}")

    def uniform(lo, hi, shape):
        return torch.as_tensor(rng.uniform(lo, hi, shape).astype(np.float32),
                               device=dev)

    def normal(shape):
        return torch.as_tensor(rng.normal(size=shape).astype(np.float32),
                               device=dev)

    # stable coefficients: every row sum of |A| stays below 1
    for r, t, path in ((8, BLOCK, "headline"), (2, 8192, "mastering"),
                       (2, BLOCK, None), (2, 4097, None), (8, 4097, None),
                       (40, BLOCK, None), (40, 4097, None)):
        args = (uniform(0.7, 0.95, (r, t)), uniform(-0.04, 0.04, (r, t)),
                uniform(-0.04, 0.04, (r, t)), uniform(0.7, 0.95, (r, t)),
                normal((r, t)), normal((r, t)), normal(r), normal(r))
        res = compare(f"iir2 R={r} T={t}", lambda: scan.iir2(*args),
                      lambda: scan.chunked_second(*args), DB90, relative=True)
        # s = A s + b: 8 operations per sample; 2 outputs
        record("iir2", path, res, nbytes(*args) + 2 * 4 * r * t, 8 * r * t,
               shape=f"R={r} T={t}")
    for r, t, path in ((2, BLOCK, "headline"), (2, 8192, "mastering"),
                       (2, 999, None), (7, BLOCK, None), (7, 999, None)):
        a, b, y0 = uniform(0.7, 0.999, (r, t)), normal((r, t)), normal(r)
        res = compare(f"iir1 R={r} T={t}", lambda: scan.iir1(a, b, y0),
                      lambda: scan.chunked_first(a, b, y0), DB90,
                      relative=True)
        record("iir1", path, res, nbytes(a, b, y0) + 4 * r * t, 2 * r * t,
               shape=f"R={r} T={t}")
    check_dynamics(dev, rng, record)
    return results


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
    and at a ragged one (B=3, n=4097; the plain version on the card)."""
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
            "follower": (lambda: follower.follower(x, aa, ra, env0),
                         follower.follower_plain, (x, aa, ra, env0)),
            "gate": (lambda: follower.gate(x, aa, ra, thr, rng_db, hs, st0),
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
            if name == "gate":  # (state [B, 3], gains) vs ((env, hold, gain), gains)
                want = (torch.stack(want[0], dim=-1), want[1])
            else:  # (env_end, env)
                want = tuple(want)
            err = exact(f"{name} B={b} n={n}", got, want)
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
                   OPS_PER_SAMPLE[name] * b * n, shape=f"B={b} n={n}",
                   plain_device=plain_dev.type, serial_chain_ms=serial_ms)


def render_path(name, make_program, dev, kernels_used, blocks=4):
    """Render ``blocks`` blocks of a program on the card after one warm-up
    block, with the launch counters set to 0 just before; check the launches,
    the audio, and blocks 0-1 against the same program on the CPU.  Returns
    the launches of this run."""
    prog = make_program(dev)
    prog.render(BLOCK)  # warm-up: allocator and library start-up
    for mod, attr in COUNTERS.values():
        setattr(mod, attr, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    audio = prog.render(blocks * BLOCK)
    wall = time.perf_counter() - t0
    launches = {k: getattr(mod, attr) for k, (mod, attr) in COUNTERS.items()}
    log(f"  rendered {blocks} x {BLOCK} frames in {wall:.3f} s: "
        f"{blocks * BLOCK / SR / wall:.1f} audio-seconds per second; "
        f"launches {launches}")
    idle = [k for k in kernels_used if launches[k] <= 0]
    if idle:
        raise RuntimeError(f"{name}: kernels of the path never launched: {idle}")
    peak = float(np.abs(audio).max())
    if audio.shape != (2, blocks * BLOCK) or not np.isfinite(audio).all():
        raise RuntimeError(f"{name}: bad render: shape {audio.shape}")
    if peak < 0.05:
        raise RuntimeError(f"{name}: render is silent: peak {peak}")
    t0 = time.perf_counter()
    ref = make_program("cpu").render(2 * BLOCK)
    log(f"  CPU reference render of 2 blocks: {time.perf_counter() - t0:.1f} s")
    for b in range(2):
        sl = slice(b * BLOCK, (b + 1) * BLOCK)
        err = float(np.abs(audio[:, sl] - ref[:, sl]).max())
        rpeak = float(np.abs(ref[:, sl]).max())
        log(f"  block {b}: max_abs_err {err:.3e} vs CPU, peak {rpeak:.4f}, "
            f"{20 * np.log10(max(err, 1e-30) / rpeak):.1f} dB")
        if not err <= DB90 * rpeak:
            raise RuntimeError(f"{name}: block {b} disagrees with the CPU render")
    device_busy(prog)
    return launches


def device_busy(prog):
    """Render one block after a warm-up block under ``torch.profiler`` and
    log its device operations, device time, wall time and busy share."""
    state, _ = prog.step(prog.init_state(), prog.block_inputs(0))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, y = prog.step(state, prog.block_inputs(1))
        y.cpu()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.time_range.elapsed_us() for e in ops) / 1e3
    log(f"  one block under the profiler: {len(ops)} device operations, "
        f"{device_ms:.2f} ms of device time in {wall_ms:.1f} ms of wall: "
        f"device busy {100 * device_ms / wall_ms:.1f} %")


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


def kernel_report(measured, paths):
    """The kernels JSON object.  Top-level numbers are the mastering
    chain's, the path that runs all five kernels: its launches and each
    kernel's numbers at its shape; ``by_path`` holds each path's."""
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
                "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
                "bound_by")},
            # no single PyTorch call computes any of these functions
            "library_ms": None, "by_path": by_path})
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

    log("phase 1: build")
    t0 = time.perf_counter()
    path = kernels.library_path()
    kernels.library()
    log(f"  built {path.name} in {time.perf_counter() - t0:.1f} s")
    log((path.parent / "build.log").read_text().strip())

    log("phase 2: kernels against their plain versions")
    measured = check_kernels(dev)
    paths = {}
    log("phase 3: headline graph on the card")
    paths["headline"] = render_path(
        "headline", lambda d: mixer_graph_program(block_frames=BLOCK, device=d),
        dev, ("ramp_read", "iir2", "iir1"))
    log("phase 4: mastering chain on the card")
    paths["mastering"] = render_path(
        "mastering", lambda d: mastering_program(block_frames=BLOCK, device=d),
        dev, tuple(COUNTERS))
    roll_cost(mastering_program(block_frames=BLOCK, device=dev), dev)

    log(json.dumps(kernel_report(measured, paths)))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

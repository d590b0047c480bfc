"""GPU smoke test of the PyTorch port: build the CUDA kernels, check each
against its plain PyTorch version on the card, then render the headline
mixer graph at full width on the card and check it.

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``; exits non-zero without them or when any
phase fails.  Phases:

1. build ``phonic_tpu_torch/csrc/*.cu`` (sm_90a) and print the build time and
   the compiler's register / shared-memory report;
2. each kernel against its plain version on the same card inputs, at the
   headline graph's shapes and at ragged ones, with its time beside the
   plain version's (CUDA events);
3. the headline graph (16 file sources -> 4 sub-mixers with EQ5 + chorus ->
   reverb + gain, 131072-frame blocks at 48 kHz stereo) rendered on the card
   through ``RenderProgram.render``: every kernel's launch counter must grow,
   the audio must be finite and not silent, and its first two blocks must
   match the same program rendered on the CPU to -90 dB of peak.

The line before the last is a JSON object with each kernel's numbers from
this run; the last line is ``{"ok": true, "device": {...}}``.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

from phonic_tpu_torch import kernels
from phonic_tpu_torch.headline import mixer_graph_program
from phonic_tpu_torch.ops import rampread, scan

BLOCK = 131072
SR = 48000
DB90 = 10.0 ** (-90.0 / 20.0)
RAMP_TOL = 1e-5  # unit-scale data; FMA contraction vs the plain x-form


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
    rng = np.random.default_rng(0)
    results = {}
    log("phase 2: kernels against their plain versions")
    for ch in (1, 2):
        for n in (BLOCK, 1000):
            frames = 26656  # the headline graph's longest buffer + guard
            src = torch.as_tensor(rng.normal(size=(16, ch, frames)).astype(
                np.float32), device=dev)
            smap = torch.arange(16, dtype=torch.int32, device=dev)
            pos = torch.as_tensor(ramp_positions(rng, 16, n, frames), device=dev)
            res = compare(f"ramp_read B=16 ch={ch} N={n}",
                          lambda: rampread.ramp_read(src, smap, pos),
                          lambda: rampread.ramp_read_plain(src, smap, pos),
                          RAMP_TOL, relative=False)
            if ch == 1 and n == BLOCK:
                results["ramp_read"] = res

    def uniform(lo, hi, shape):
        return torch.as_tensor(rng.uniform(lo, hi, shape).astype(np.float32),
                               device=dev)

    def normal(shape):
        return torch.as_tensor(rng.normal(size=shape).astype(np.float32),
                               device=dev)

    # stable coefficients: every row sum of |A| stays below 1
    for r in (2, 8, 40):
        for t in (BLOCK, 4097):
            args = (uniform(0.7, 0.95, (r, t)), uniform(-0.04, 0.04, (r, t)),
                    uniform(-0.04, 0.04, (r, t)), uniform(0.7, 0.95, (r, t)),
                    normal((r, t)), normal((r, t)), normal(r), normal(r))
            res = compare(f"iir2 R={r} T={t}", lambda: scan.iir2(*args),
                          lambda: scan.chunked_second(*args), DB90,
                          relative=True)
            if r == 8 and t == BLOCK:
                results["iir2"] = res
    for r in (2, 7):
        for t in (BLOCK, 999):
            a, b, y0 = uniform(0.7, 0.999, (r, t)), normal((r, t)), normal(r)
            res = compare(f"iir1 R={r} T={t}", lambda: scan.iir1(a, b, y0),
                          lambda: scan.chunked_first(a, b, y0), DB90,
                          relative=True)
            if r == 2 and t == BLOCK:
                results["iir1"] = res
    return results


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

    measured = check_kernels(dev)

    log("phase 3: headline graph on the card")
    blocks = 4
    prog = mixer_graph_program(block_frames=BLOCK, device=dev)
    prog.render(BLOCK)  # warm-up: allocator and library start-up
    rampread.launches = scan.iir1_launches = scan.iir2_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    audio = prog.render(blocks * BLOCK)
    wall = time.perf_counter() - t0
    launches = {"ramp_read": rampread.launches, "iir2": scan.iir2_launches,
                "iir1": scan.iir1_launches}
    log(f"  rendered {blocks} x {BLOCK} frames in {wall:.3f} s: "
        f"{blocks * BLOCK / SR / wall:.1f} audio-seconds per second; "
        f"launches {launches}")
    if min(launches.values()) <= 0:
        raise RuntimeError(f"a kernel of the path never launched: {launches}")
    peak = float(np.abs(audio).max())
    if audio.shape != (2, blocks * BLOCK) or not np.isfinite(audio).all():
        raise RuntimeError(f"bad render: shape {audio.shape}")
    if peak < 0.05:
        raise RuntimeError(f"render is silent: peak {peak}")
    t0 = time.perf_counter()
    ref = mixer_graph_program(block_frames=BLOCK, device="cpu").render(2 * BLOCK)
    log(f"  CPU reference render of 2 blocks: {time.perf_counter() - t0:.1f} s")
    for b in range(2):
        sl = slice(b * BLOCK, (b + 1) * BLOCK)
        err = float(np.abs(audio[:, sl] - ref[:, sl]).max())
        rpeak = float(np.abs(ref[:, sl]).max())
        log(f"  block {b}: max_abs_err {err:.3e} vs CPU, peak {rpeak:.4f}, "
            f"{20 * np.log10(max(err, 1e-30) / rpeak):.1f} dB")
        if not err <= DB90 * rpeak:
            raise RuntimeError(f"block {b} disagrees with the CPU render")

    sources = {"ramp_read": ("phonic_tpu_torch/csrc/rampread.cu",
                             "phonic_tpu/ops/rampread.py:176"),
               "iir2": ("phonic_tpu_torch/csrc/scan.cu",
                        "phonic_tpu/ops/pallas_scan.py:112"),
               "iir1": ("phonic_tpu_torch/csrc/scan.cu",
                        "phonic_tpu/ops/pallas_scan.py:74")}
    report = {"kernels": [
        {"name": name, "route": "cuda", "source": sources[name][0],
         "replaces": sources[name][1], "launches": launches[name],
         "max_abs_err": measured[name][0], "ms": measured[name][1],
         "plain_ms": measured[name][2]}
        for name in ("ramp_read", "iir2", "iir1")]}
    log(json.dumps(report))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Plain reference render of the mastering chain: looping stereo stems
summed on one bus, then gate -> compressor -> delay -> distortion ->
limiter.

The graph comes as a plain spec (``configs/mastering_chain.py``) with the
stems' samples, and every automation event as ``(kind, key, pid, frame,
value, rate)``; lanes are independent renders with their own events.
Nothing here imports the program under test.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from . import dsp
from .dynamics import affine1_scan, follow
from .filebank import FileBank
from .params import Param

F32 = torch.float32
LN10_20 = 20.0 / math.log(10.0)
DELAY_LFO_MS = 50.0  # the delay's LFO sweeps its time by up to 50 ms
DELAY_RES = 0.302  # the delay's feedback filter resonance (Q ~ 0.707)
MAX_DRIVE = 4.0


def peak_db(peak):
    """A detector's peak in dB; -120 dB at or below 1e-6."""
    return torch.where(peak > 1e-6, LN10_20 * torch.log(torch.clamp(
        peak, min=1e-7)), torch.full_like(peak, -120.0))


def coef(seconds, sr: int):
    """A follower's per-sample step toward its input, 1 - exp(-1/(t sr))."""
    return -torch.expm1(-1.0 / torch.clamp(seconds.double() * sr, min=1e-9))


def diode(x, drive):
    t = drive / MAX_DRIVE
    gain = 1.0 + (0.6 * t * t + 0.4 * t) * 19.0
    return 2.0 / math.pi * torch.atan(
        (torch.exp((0.1 * x) / (0.0253 * 1.68)) - 1.0) * gain)


def diode_compensation() -> np.ndarray:
    """The distortion's 256-entry RMS compensation table over drive 0..4:
    the RMS of a 5-partial probe over the RMS of its diode-shaped self,
    stored as float32."""
    partials = [(1.0, 0.60), (2.7, 0.25), (5.3, 0.10), (9.1, 0.03),
                (14.6, 0.02)]
    n = 256
    t = 2.0 * math.pi * (np.arange(n) + 0.5) / n
    sig = (sum(a * np.sin(f * t) for f, a in partials)
           / sum(a for _, a in partials)).astype(np.float32).astype(np.float64)
    drive = np.arange(256)[:, None] / 255.0 * MAX_DRIVE
    shaped = diode(torch.as_tensor(sig[None, :]),
                   torch.as_tensor(drive)).numpy()
    out_rms = np.sqrt(np.mean(shaped ** 2, axis=-1))
    in_rms = np.sqrt(np.mean(sig ** 2))
    return np.where(out_rms > 1e-10, in_rms / np.maximum(out_rms, 1e-10),
                    1.0).astype(np.float32)


class MasteringReference:
    """The reference render of ``spec`` over ``stems`` (float32 [2, F]
    each) for ``lanes`` lanes, one block of ``block_frames`` at a time."""

    def __init__(self, spec: dict, stems: list, lanes: int, block_frames: int,
                 device, dtype=torch.float64):
        self.spec, self.lanes, self.n = spec, lanes, block_frames
        self.sr = sr = spec["sample_rate"]
        self.dev, self.dt = device, dtype
        L, ns = lanes, len(stems)
        self.ns = ns
        self.bank = FileBank(stems, L, device)
        p = self.params = {}

        def add(key, pid, value, smoothing, rows=L, arg=None):
            p[f"{key}.{pid}"] = Param(value, smoothing, rows, device, dtype,
                                      sr, arg)

        for pid, v, sm in (("VOLU", spec["volume"], "exp"),
                           ("PANN", 0.0, "exp"), ("SPED", 1.0, "step")):
            add("src", pid, v, sm, rows=L * ns)
        g = spec["gate"]
        for pid, k in (("thrs", "threshold"), ("attk", "attack"),
                       ("hold", "hold"), ("rels", "release"),
                       ("rnge", "range_db")):
            add("gate", pid, g[k], "step")
        for key in ("comp", "limiter"):
            c = spec[key]
            for pid, k in (("thrs", "threshold"), ("rato", "ratio"),
                           ("knee", "knee"), ("attk", "attack"),
                           ("rels", "release")):
                add(key, pid, c[k], "step")
            add(key, "gain", c["makeup_gain"], "exp")
        d = spec["delay"]
        for pid, k in (("fdbk", "feedback"), ("cuto", "filter_cutoff"),
                       ("wet_", "wet"), ("wdth", "width")):
            add("delay", pid, d[k], "exp")
        add("dist", "driv", spec["distortion"]["drive"], "linear", arg=0.01)
        add("dist", "mix ", spec["distortion"]["mix"], "exp", arg=0.1)

        z = lambda *s: torch.zeros(s, dtype=dtype, device=device)  # noqa
        self.gate_state = [torch.full((L,), -120.0, dtype=dtype, device=device),
                           z(L),
                           torch.full((L,), float(g["range_db"]), dtype=dtype,
                                      device=device)]
        self.comp_tail = {k: z(L, 2, math.ceil(spec[k]["lookahead"] * sr))
                          for k in ("comp", "limiter")}
        self.comp_env = {k: torch.full(
            (L,), -120.0 if spec[k]["ratio"] >= 20.0 else 0.0, dtype=dtype,
            device=device) for k in ("comp", "limiter")}
        cap = (min(max(d["max_delay_capacity_ms"], d["delay_ms"]), 4000.0)
               + DELAY_LFO_MS)
        self.delay_cap = cap * 0.001 * sr
        need = int(math.ceil(cap * sr / 1000.0)) + 4 + 2
        self.line_len = -(-need // 128) * 128
        self.line = z(L, 2, self.line_len)
        self.svf = (z(L, 2), z(L, 2))
        self.dc_y, self.dc_x = z(L, 2), z(L, 2)
        self.fb = z(L, 2)
        self.min_delay = d["min_delay_ms"] * sr / 1000.0
        self.lut = torch.as_tensor(diode_compensation(), device=device)
        self.block_index = 0

    def add_event(self, lane: int, ev):
        kind, key, pid, frame, value, _ = ev
        off = frame - self.block_index * self.n
        if not 0 <= off < self.n:
            raise ValueError(f"event at frame {frame} outside block "
                             f"{self.block_index}")
        if kind == "seek":
            i = int(key[3:])
            self.bank.seek(lane * self.ns + i, value)
        elif kind == "set":
            self.params[f"{key}.{pid}"].events[lane].append(
                (off, value, False))
        else:
            raise ValueError(f"the mastering chain takes no {kind}")

    def step(self) -> torch.Tensor:
        n, sr, dt, L = self.n, self.sr, self.dt, self.lanes
        pv = {k: p.block(n, sr) for k, p in self.params.items()}
        st = self.bank.read(pv["src.SPED"], dt)  # [L*S, 2, n]
        left, right = dsp.pan_gains(pv["src.PANN"])
        st = st * pv["src.VOLU"][:, None, :]
        st = torch.stack([st[:, 0] * left, st[:, 1] * right], 1)
        x = st.view(L, self.ns, 2, n).sum(1)
        x = self._gate(x, pv)
        x = self._compressor("comp", x, pv)
        x = self._delay(x, pv)
        x = self._distortion(x, pv)
        x = self._compressor("limiter", x, pv)
        self.block_index += 1
        return x

    def _gate(self, x, pv):
        """Detector (stereo peak in dB) -> envelope -> open while at or
        above the threshold, then held for ``hold`` seconds -> the gain in
        dB follows 0 (open or held) or the range (closed)."""
        sr, dt = self.sr, self.dt
        aa = coef(pv["gate.attk"], sr).to(dt)
        ra = coef(pv["gate.rels"], sr).to(dt)
        env0, hold0, gain0 = self.gate_state
        peak = torch.maximum(x[:, 0].abs(), x[:, 1].abs())
        env = follow(peak_db(peak), aa, ra, env0)
        is_open = env >= pv["gate.thrs"].to(dt)
        hs = torch.floor(pv["gate.hold"] * np.float32(sr)).double()
        t = torch.arange(x.shape[-1], device=x.device)
        last = torch.cummax(torch.where(is_open, t, -1), dim=-1).values
        since = (t - last).double()
        held = torch.where(last >= 0, torch.clamp(
            torch.gather(hs, 1, last.clamp(min=0)) - since, min=0.0),
            torch.clamp(hold0.double()[:, None] - (t + 1).double(), min=0.0))
        prev_hold = torch.cat([hold0.double()[:, None], held[:, :-1]], -1)
        target = torch.where(is_open | (prev_hold > 0.0),
                             torch.zeros_like(env), pv["gate.rnge"].to(dt))
        gain_db = follow(target, aa, ra, gain0)
        self.gate_state = [env[:, -1], held[:, -1].to(dt), gain_db[:, -1]]
        gain = torch.where(gain_db <= -60.0, torch.zeros_like(gain_db),
                           torch.exp(gain_db / LN10_20))
        gain = torch.where(gain_db == 0.0, torch.ones_like(gain), gain)
        return x * gain[:, None, :]

    def _compressor(self, key, x, pv):
        """Lookahead delay of d frames; the detector is the stereo peak
        (a limiter's: the peak over the last d frames); the envelope in dB
        follows it; a soft-knee curve gives the gain reduction; makeup."""
        sr, dt, n = self.sr, self.dt, self.n
        d = self.comp_tail[key].shape[-1]
        ext = torch.cat([self.comp_tail[key], x], -1)
        delayed = ext[..., :n]
        self.comp_tail[key] = ext[..., -d:].clone()
        ratio = pv[f"{key}.rato"].to(dt)
        limiter = ratio >= 20.0
        frame_peak = torch.maximum(x[:, 0].abs(), x[:, 1].abs())
        ext_peak = torch.maximum(ext[:, 0].abs(), ext[:, 1].abs())
        look = F.max_pool1d(ext_peak[:, None], d, stride=1)[:, 0, -n:]
        det = peak_db(torch.where(limiter, look, frame_peak))
        env = follow(det, coef(pv[f"{key}.attk"], sr).to(dt),
                        coef(pv[f"{key}.rels"], sr).to(dt), self.comp_env[key])
        self.comp_env[key] = env[:, -1]
        slope = torch.where(limiter, torch.ones_like(ratio),
                            1.0 - 1.0 / torch.clamp(ratio, min=1.0))
        thr, w = pv[f"{key}.thrs"].to(dt), pv[f"{key}.knee"].to(dt)
        lower, upper = thr - w / 2.0, thr + w / 2.0
        xk = (env - lower) / torch.clamp(w, min=1e-9)
        in_knee = (w > 0.0) & (env > lower) & (env < upper)
        gr = torch.where(in_knee, xk * xk * slope * w / 2.0, torch.where(
            env > upper, (env - thr) * slope, torch.zeros_like(env)))
        total = pv[f"{key}.gain"] - gr
        gain = torch.where(total == 0.0, torch.ones_like(total),
                           torch.exp(total / LN10_20))
        return delayed * gain[:, None, :]

    def _delay(self, x, pv):
        """A stereo feedback delay: each channel writes its input plus the
        previous sample of its feedback, the feedback being the delayed
        signal through a lowpass SVF and a DC blocker, clamped to +-4; a
        dry/wet law and a mid/side width on the output."""
        sr, dt, n, L = self.sr, self.dt, self.n, self.lanes
        dspec = self.spec["delay"]
        # the delay time in samples, in float32 as a parameter value is
        ms = torch.full((L, n), dspec["delay_ms"], dtype=F32, device=self.dev)
        ds = torch.clamp(torch.clamp(ms, min=1.0) * 0.001 * sr,
                         max=self.delay_cap).double()
        fb = torch.clamp(pv["delay.fdbk"], 0.0, 0.999)
        cutoff = torch.clamp(pv["delay.cuto"], 20.0, sr / 2.0)
        g = torch.tan(math.pi * cutoff / sr)
        k = max(2.0 * (1.0 - DELAY_RES * 0.97), 0.03)
        a1 = 1.0 / (1.0 + g * (g + k))
        co = (a1, g * a1, g * g * a1)
        r = 1.0 - 2.0 * math.pi * 5.0 / sr
        h = self.line_len
        chunk = 1 << int(math.log2(self.min_delay - 1))
        chunk = math.gcd(chunk, n)
        if float(ds.min()) < chunk + 1:
            raise ValueError("delay shorter than the reference's chunk")
        line = torch.cat([self.line, torch.zeros_like(x)], -1)
        t_abs = torch.arange(n, device=self.dev).double() + h
        wet = torch.empty_like(x)
        zero = torch.zeros((), dtype=dt, device=self.dev)
        for t0 in range(0, n, chunk):
            sl = slice(t0, t0 + chunk)
            delayed = dsp.lerp_read(line, (t_abs[sl] - ds[:, sl])[:, None, :]
                                    .expand(L, 2, chunk))
            self.svf, filt = dsp.tpt(self.svf, delayed,
                                     *(c[:, None, sl] for c in co),
                                     zero, zero, zero + 1.0)
            diff = filt - torch.cat([self.dc_x[..., None], filt[..., :-1]], -1)
            blocked = affine1_scan(torch.full_like(diff, r), diff, self.dc_y)
            self.dc_x, self.dc_y = filt[..., -1], blocked[..., -1]
            clean = torch.clamp(blocked, -4.0, 4.0)
            prev = torch.cat([self.fb[..., None], clean[..., :-1]], -1)
            line[..., h + t0:h + t0 + chunk] = x[..., sl] + prev * fb[:, None, sl]
            self.fb = clean[..., -1]
            wet[..., sl] = clean
        self.line = line[..., -h:].clone()
        w = pv["delay.wet_"]
        out = (x * torch.clamp((1.0 - w) * 2.0, max=1.0)[:, None, :]
               + wet * torch.clamp(w * 2.0, max=1.0)[:, None, :])
        width = pv["delay.wdth"]
        mid = (out[:, 0] + out[:, 1]) * 0.5
        side = (out[:, 0] - out[:, 1]) * 0.5
        return torch.stack([mid + side * width, mid - side * width], 1)

    def _distortion(self, x, pv):
        """The diode shaper at the drive, scaled by the RMS compensation
        interpolated from its table, mixed with the dry signal."""
        drive, mix = pv["dist.driv"], pv["dist.mix "]
        pos = torch.clamp(drive / MAX_DRIVE, 0.0, 1.0) * 255.0
        lo = torch.floor(pos).to(torch.int64)
        hi = torch.clamp(lo + 1, max=255)
        lut = self.lut.to(self.dt)
        comp = lut[lo] + (lut[hi] - lut[lo]) * (pos - lo.to(pos.dtype))
        wet = diode(x, drive[:, None, :]) * comp[:, None, :]
        return (1.0 - mix[:, None, :]) * x + mix[:, None, :] * wet

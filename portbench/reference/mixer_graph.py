"""Plain reference render of the mixer graph: looping file sources with
smoothed volume and constant-power pan, sub-mixers running a 5-band EQ and
a chorus, a master bus running a reverb and gains.

The graph comes as a plain spec (``configs/mixer_graph_16src.py``) and every
automation event as ``(kind, key, pid, frame, value, rate)``; lanes are
independent renders of the same graph with their own events, kept as a
leading row dimension.  Nothing here imports the program under test.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import dsp
from .filebank import FileBank
from .params import Param

F32 = torch.float32

# the effects' fixed settings and delay-line factors
EQ_FREQS = (100.0, 1000.0, 4000.0, 8000.0, 12000.0)
EQ_BW = (1.0, 4.0, 4.0, 4.0, 1.0)
EQ_KINDS = ("lowshelf", "bell", "bell", "bell", "highshelf")
CHORUS_RANGE = 256.0  # samples of sweep at 44.1 kHz
REVERB_LINES = (79.0, 73.0, 71.0, 67.0, 61.0, 59.0, 53.0, 47.0)
REVERB_VIB = (0.003251, 0.002999, 0.002917, 0.002749,
              0.002503, 0.002423, 0.002146, 0.002088)
REVERB_AP = (43.0, 41.0, 37.0, 31.0)
REVERB_PRE = 29.0
GLIDE_CHUNK = 64  # a glide recomputes its speed every 64 frames
GLIDE_KNOT = 512  # and the engine lowers it to ramp knots 512 frames apart


def tone(frames: int, freq: float, sr: int, decay: float = 2.0) -> np.ndarray:
    """A decaying sine at half scale, stored as float32 samples."""
    t = np.arange(frames) / sr
    return (0.5 * np.sin(2 * np.pi * freq * t) * np.exp(-t * decay)).astype(
        np.float32)


def glide_knots(t: int, current: float, target: float, rate: float,
                sr: int) -> list:
    """A speed glide at ``rate`` semitones per second from ``current`` to
    ``target`` starting at frame ``t``: the speed is recomputed every 64
    frames toward the target; the engine holds it as ramp knots every 512
    frames (and one at the end), each knot on that staircase.  Returns
    ``[(frame, value, ramp)]``."""
    if rate <= 0 or current <= 0 or target <= 0 or abs(target - current) <= 1e-4:
        return [(t, target, False)]
    knots = [(t, current, True)]
    c, chunk, last = current, 0, -1
    while abs(target - c) > 1e-4:
        dur = abs(12.0 * math.log2(target / c)) / rate * float(sr)
        if dur <= 0.0:
            c = target
        else:
            step = (target - c) / dur * GLIDE_CHUNK
            c = target if abs(target - c) < abs(step) else c + step
        if chunk > 0 and chunk % GLIDE_KNOT == 0:
            knots.append((t + chunk, c, True))
            last = chunk
        chunk += GLIDE_CHUNK
    reached = max(chunk - GLIDE_CHUNK, 0)
    if reached != last:
        knots.append((t + reached, target if abs(target - c) <= 1e-4 else c,
                      True))
    return knots


class MixerGraphReference:
    """The reference render of ``spec`` for ``lanes`` lanes, ``chunk_blocks``
    engine blocks of ``block_frames`` per step (the engine applies seeks
    and computes read positions per block, so the reference does so per
    engine block; everything else runs over the whole chunk)."""

    def __init__(self, spec: dict, lanes: int, block_frames: int, device,
                 dtype=torch.float64, chunk_blocks: int = 1):
        self.spec, self.lanes = spec, lanes
        self.block, self.chunk_blocks = block_frames, chunk_blocks
        self.n = block_frames * chunk_blocks
        self.sr = sr = spec["sample_rate"]
        self.dev, self.dt = device, dtype
        srcs = spec["sources"]
        self.ns = ns = len(srcs)
        self.nm = nm = len(spec["submixers"])
        L = lanes
        self.bank = FileBank([tone(s["frames"], s["freq"], sr)[None]
                              for s in srcs], L, device)
        rows = L * ns
        self.speed_now = [[s["speed"] for s in srcs] for _ in range(L)]

        def per_src(k):
            return [s[k] for s in srcs] * L

        def per_sub(fn):
            return [fn(m) for m in spec["submixers"]] * L

        p = self.params = {}
        p["VOLU"] = Param(per_src("volume"), "exp", rows, device, dtype)
        p["PANN"] = Param(per_src("pan"), "exp", rows, device, dtype)
        p["SPED"] = Param(per_src("speed"), "step", rows, device, dtype)
        sub_rows = L * nm
        for b in range(5):
            p[f"gan{b + 1}"] = Param(per_sub(lambda m: m["eq_gains"][b]),
                                      "exp", sub_rows, device, dtype)
            p[f"frq{b + 1}"] = Param(EQ_FREQS[b], "exp", sub_rows, device,
                                      dtype)
            p[f"bw_{b + 1}"] = Param(EQ_BW[b], "linear", sub_rows, device,
                                      dtype, sr)
        ch = spec["chorus"]
        p["rate"] = Param(per_sub(lambda m: m["chorus_rate"]), "exp",
                           sub_rows, device, dtype)
        for pid, key in (("phas", "phase"), ("dpth", "depth"),
                         ("fdbk", "feedback"), ("dlay", "delay_ms"),
                         ("wet_", "wet"), ("fltf", "filter_freq"),
                         ("fltq", "filter_res")):
            p[pid] = Param(ch[key], "exp", sub_rows, device, dtype)
        rv = spec["reverb"]
        p["room"] = Param(rv["room_size"], "linear", L, device, dtype, sr)
        p["wet "] = Param(rv["wet"], "exp", L, device, dtype)
        p["GAIN"] = Param(spec["gain"], "exp", L, device, dtype)
        if spec.get("master_gain") is not None:
            p["master"] = Param(spec["master_gain"], "exp", L, device, dtype)

        z = lambda *s: torch.zeros(s, dtype=dtype, device=device)  # noqa
        self.eq_state = [(z(sub_rows, 2), z(sub_rows, 2)) for _ in range(5)]
        # chorus: input SVF, left LFO phase (float32), the delay line
        self.svf = (z(sub_rows, 2), z(sub_rows, 2))
        self.lfo_phase = torch.zeros(sub_rows, dtype=F32, device=device)
        lfo_range = CHORUS_RANGE * sr / 44100.0
        max_off = 2 + math.ceil(100.0 * sr / 1000.0) + 2 * math.ceil(
            lfo_range) + 2
        self.ch_hist_len = -(-(max_off + 2) // 128) * 128
        self.ch_hist = z(sub_rows, 2, self.ch_hist_len)
        # reverb: delay storage for the largest room (1.0)
        size_cap = 100.0
        self.rv_pre_max = int(REVERB_PRE * size_cap) + 2
        self.rv_pre = z(L, 2, self.rv_pre_max)
        self.rv_bq = [(z(L, 2), z(L, 2)) for _ in range(3)]
        self.rv_ap_len = 1 << int(43.0 * size_cap + 1).bit_length()
        self.rv_line_len = 1 << int(79.0 * size_cap + 1).bit_length()
        self.rv_ap = z(L, 4, 2, self.rv_ap_len)
        self.rv_line = z(L, 8, 2, self.rv_line_len)
        self.rv_fb = z(L, 8, 2)
        rng = np.random.default_rng(rv["seed"])
        vib = rng.uniform(0.0, 2.0 * math.pi, size=(8, 2)).astype(np.float32)
        self.rv_vib = torch.as_tensor(vib, device=device).expand(
            L, 8, 2).clone()
        self.chunk_index = 0

    # -- events -------------------------------------------------------------

    def _row(self, lane: int, key: str) -> int:
        """The row of a node key's parameters for a lane."""
        kind, idx = self.spec["keys"][key]
        width = {"source": self.ns, "submixer": self.nm, "master": 1}[kind]
        return lane * width + idx

    def add_event(self, lane: int, ev):
        """Schedule one event ``(kind, key, pid, frame, value, rate)`` that
        falls in the next chunk."""
        kind, key, pid, frame, value, rate = ev
        off = frame - self.chunk_index * self.n
        if not 0 <= off < self.n:
            raise ValueError(f"event at frame {frame} outside chunk "
                             f"{self.chunk_index}")
        row = self._row(lane, key)
        if kind == "set":
            name = "master" if key == "master" else pid
            self.params[name].events[row].append((off, value, False))
        elif kind == "glide":
            i = self.spec["keys"][key][1]
            knots = glide_knots(frame, self.speed_now[lane][i], value, rate,
                                self.sr)
            if knots[-1][0] // self.block != frame // self.block:
                raise ValueError("a glide must end inside its block")
            self.speed_now[lane][i] = knots[-1][1]
            self.params["SPED"].events[row].extend(
                (f - self.chunk_index * self.n, v, r) for f, v, r in knots)
        elif kind == "seek":
            self.bank.seek(row, value, off // self.block)
        else:
            raise ValueError(kind)

    # -- the block ----------------------------------------------------------

    def step(self) -> torch.Tensor:
        """Render the next chunk: [lanes, 2, chunk_blocks * block_frames]
        in the reference dtype."""
        n, sr, dt, L = self.n, self.sr, self.dt, self.lanes
        pv = {k: p.block(n, sr) for k, p in self.params.items()}
        mono = self.bank.read(pv["SPED"], dt, self.block)[:, 0]
        left, right = dsp.pan_gains(pv["PANN"])
        sig = mono * pv["VOLU"]
        st = torch.stack([sig * left, sig * right], 1)  # [L*S, 2, n]
        st = st.view(L, self.ns, 2, n)
        subs = torch.zeros((L, self.nm, 2, n), dtype=dt, device=self.dev)
        for i, s in enumerate(self.spec["sources"]):
            subs[:, s["submixer"]] += st[:, i]
        x = subs.reshape(L * self.nm, 2, n)
        x = self._eq5(x, pv)
        x = self._chorus(x, pv)
        master = x.view(L, self.nm, 2, n).sum(1)
        master = self._reverb(master, pv)
        master = master * pv["GAIN"][:, None, :]
        if "master" in pv:
            master = master * pv["master"][:, None, :]
        self.chunk_index += 1
        return master

    def _eq5(self, x, pv):
        sr = self.sr
        for b, kind in enumerate(EQ_KINDS):
            freq = torch.clamp(pv[f"frq{b + 1}"], 20.0, sr / 2.0)
            bw = pv[f"bw_{b + 1}"]
            q = bw if kind != "bell" else 1.0 / torch.clamp(bw, min=0.001)
            co = dsp.biquad(kind, sr, freq, q, pv[f"gan{b + 1}"])
            self.eq_state[b], x = dsp.tpt(
                self.eq_state[b], x, *(c[:, None, :] for c in co))
        return x

    def _chorus(self, x, pv):
        n, sr, dt = self.n, self.sr, self.dt
        cutoff = torch.clamp(pv["fltf"], 20.0, sr / 2.0)
        res = pv["fltq"]
        g = torch.tan(math.pi * cutoff / sr)
        k = torch.clamp(2.0 * (1.0 - res * 0.97), min=0.03)
        a1 = 1.0 / (1.0 + g * (g + k))
        zero = torch.zeros_like(g)
        self.svf, filt = dsp.tpt(self.svf, x, *(c[:, None, :] for c in (
            a1, g * a1, g * g * a1, zero, zero, zero + 1.0)))
        # LFOs: phase increments rate / sr, summed exactly and rounded to
        # float32 once; the right channel's phase is offset by PHASE / 2pi
        # the engine carries the left phase in float32 from block to block
        recip = float(np.float32(1.0) / np.float32(sr))
        inc = pv["rate"].to(F32) * recip
        nb = self.block
        lfos = [[], []]
        for k in range(self.chunk_blocks):
            csum = torch.cumsum(inc[:, k * nb:(k + 1) * nb].double(), -1).to(F32)
            excl = torch.cat([torch.zeros_like(csum[:, :1]), csum[:, :-1]], -1)
            off = pv["phas"][:, k * nb].to(F32) / np.float32(2.0 * math.pi)
            for side, ph0 in enumerate(
                    (self.lfo_phase, torch.fmod(self.lfo_phase + off, 1.0))):
                raw = ph0[:, None] + excl
                ph = (raw - torch.floor(raw)).to(dt)
                lfos[side].append(dsp.sine_approx(torch.where(
                    ph < 0.5, ph * (2 * math.pi), (ph - 1.0) * (2 * math.pi))))
            end = self.lfo_phase + csum[:, -1]
            self.lfo_phase = end - torch.floor(end)
        lfos = [torch.cat(x, -1) for x in lfos]
        # read offsets in samples, in float64 whatever the audio's dtype
        lfo_range = CHORUS_RANGE * sr / 44100.0
        delay = 2.0 + pv["dlay"].double() * 0.001 * sr
        depth = lfo_range * pv["dpth"].double()
        pos = torch.stack([delay + (1.0 + lfo.double()) * depth
                           for lfo in lfos], 1)
        fb = torch.clamp(pv["fdbk"], -0.999, 0.999)[:, None, :]
        h = self.ch_hist_len
        if float(pos.min()) < 513 or float(pos.max()) > h - 2:
            raise ValueError("chorus delay outside the reference's line")
        line = torch.cat([self.ch_hist, torch.zeros_like(filt)], -1)
        t_abs = torch.arange(n, device=self.dev).double() + h
        wet = torch.empty_like(filt)
        # a chunk shorter than the shortest delay: no read sees its writes
        chunk = int(pos.min()) - 1
        for t0 in range(0, n, chunk):
            sl = slice(t0, t0 + chunk)
            d = dsp.lerp_read(line, (t_abs[sl] - pos[..., sl]).expand(
                line.shape[:-1] + (min(chunk, n - t0),)))
            line[..., h + t0:h + t0 + d.shape[-1]] = filt[..., sl] + d * fb[..., sl]
            wet[..., sl] = d
        self.ch_hist = line[..., -h:].clone()
        w = pv["wet_"][:, None, :]
        return x * (1.0 - w) + wet * w

    def _reverb(self, x, pv):
        """Predelay -> lowpass A -> wet drive and sin() -> 4 Schroeder
        allpasses -> 8 vibrato-swept feedback lines coupled in two
        Householder groups of 4 -> mean -> lowpass B -> clamp and asin() ->
        lowpass C -> plus the dry signal."""
        n, sr, dt, L, dev = self.n, self.sr, self.dt, self.lanes, self.dev
        spec = self.spec["reverb"]
        room = torch.clamp(pv["room"], min=spec["min_room_size"])
        wet = pv["wet "]
        room0 = room[:, 0].to(F32)
        size0 = room0 * room0 * 75.0 + 25.0  # float32: integer delays
        size = room * room * 75.0 + 25.0
        cutoff = torch.clamp(10000.0 - room * wet * 3000.0, 20.0, sr / 2.0)
        depth = 1.0 - (1.0 - (0.82 - ((1.0 - room) * 0.7 + size * 0.002))) ** 4
        blend = 0.955 - size * 0.007
        regen = depth * 0.5

        def delays(f):
            return (torch.tensor(f, dtype=F32, device=dev) * size0[:, None]
                    ).to(torch.int64)

        line_d = delays(REVERB_LINES)  # [L, 8]
        ap_d = delays(REVERB_AP)  # [L, 4]
        pre_d = (np.float32(REVERB_PRE) * size0).to(torch.int64)  # [L]

        # predelay: x[t - pre_d]
        pre = torch.cat([self.rv_pre, x], -1)
        idx = (self.rv_pre_max - pre_d)[:, None, None] + torch.arange(
            n, device=dev)
        delayed = torch.gather(pre, -1, idx.expand(L, 2, n))
        self.rv_pre = pre[..., n:].clone()
        co = dsp.biquad("lowpass", sr, cutoff, 1.618034)
        self.rv_bq[0], fa = dsp.tpt(self.rv_bq[0], delayed,
                                    *(c[:, None, :] for c in co))
        drive = torch.sin(fa * wet[:, None, :])

        # allpasses: w[t] = in[t] - 0.5 w[t-d]; out[t] = 0.5 w[t] + w[t-d]
        ha = self.rv_ap_len
        ap = torch.cat([self.rv_ap, torch.zeros((L, 4, 2, n), dtype=dt,
                                                device=dev)], -1)
        stages = torch.empty((L, 4, 2, n), dtype=dt, device=dev)
        chunk = int(ap_d.min())  # no read sees this chunk's writes
        for t0 in range(0, n, chunk):
            b = min(chunk, n - t0)
            sig = drive[..., t0:t0 + b]
            j = torch.arange(b, device=dev)
            for a in range(4):
                ridx = (ha + t0 - ap_d[:, a])[:, None, None] + j
                old = torch.gather(ap[:, a], -1, ridx.expand(L, 2, b))
                w = sig - 0.5 * old
                ap[:, a, :, ha + t0:ha + t0 + b] = w
                sig = 0.5 * w + old
                stages[:, a, :, t0:t0 + b] = sig
        self.rv_ap = ap[..., -ha:].clone()
        si, sj, sk, sl = stages.unbind(1)
        line_in = torch.stack([sl, sk, sj, si, si, sj, sk, sl], 1)

        # vibrato-swept lines: output t reads w[t - D + floor(off)] and the
        # sample after it, off = (sin(phase) + 1) * 7 with the float32 phase
        # advanced once per sample; the line's write is its input plus the
        # previous sample's Householder feedback
        hl = self.rv_line_len
        chunk = int(line_d.min()) - 15  # reads reach 15 samples newer
        ln = torch.cat([self.rv_line, torch.zeros((L, 8, 2, n), dtype=dt,
                                                  device=dev)], -1)
        vinc = torch.tensor([v * 0.1 for v in REVERB_VIB], dtype=F32,
                            device=dev)
        vinc3 = vinc[:, None, None]
        # the vibrato phase at each engine block's start, carried in float32
        bases = [self.rv_vib]
        for _ in range(self.chunk_blocks - 1):
            bases.append(torch.fmod(bases[-1] + vinc[:, None]
                                    * np.float32(self.block),
                                    np.float32(2.0 * math.pi)))
        bases = torch.stack(bases, -1)  # [L, 8, 2, blocks]
        fb = self.rv_fb
        wet_sig = torch.empty((L, 2, n), dtype=dt, device=dev)
        for t0 in range(0, n, chunk):
            b = min(chunk, n - t0)
            j = torch.arange(b, device=dev)
            t = t0 + j  # each engine block starts from its own phase
            vib = torch.index_select(bases, -1, t // self.block) + vinc3 * (
                t % self.block).to(F32)
            off = (torch.sin((vib + vinc3).double()).to(F32) + 1.0) * 7.0
            fo = torch.floor(off)
            wf = (off - fo).to(dt)
            ridx = ((hl + t0 - line_d)[:, :, None, None] + j
                    + fo.to(torch.int64))
            v1 = torch.gather(ln, -1, ridx)
            v2 = torch.gather(ln, -1, ridx + 1)
            bl = blend[:, None, None, t0:t0 + b]
            interp = (1.0 - bl) * (v1 * (1.0 - wf) + v2 * wf) + v1 * bl
            g1 = interp[:, :4].sum(1, keepdim=True)
            g2 = interp[:, 4:].sum(1, keepdim=True)
            gsum = torch.cat([g1.expand(-1, 4, -1, -1),
                              g2.expand(-1, 4, -1, -1)], 1)
            fb_now = (2.0 * interp - gsum) * regen[:, None, None, t0:t0 + b]
            prev = torch.cat([fb[..., None], fb_now[..., :-1]], -1)
            ln[..., hl + t0:hl + t0 + b] = line_in[..., t0:t0 + b] + prev
            fb = fb_now[..., -1]
            wet_sig[..., t0:t0 + b] = interp.mean(1)
        self.rv_line = ln[..., -hl:].clone()
        self.rv_fb = fb
        self.rv_vib = torch.fmod(bases[..., -1] + vinc[:, None]
                                 * np.float32(self.block),
                                 np.float32(2.0 * math.pi))
        co = dsp.biquad("lowpass", sr, cutoff, 0.618034)
        self.rv_bq[1], fbq = dsp.tpt(self.rv_bq[1], wet_sig,
                                     *(c[:, None, :] for c in co))
        shaped = torch.asin(torch.clamp(fbq, -1.0, 1.0))
        co = dsp.biquad("lowpass", sr, cutoff, 0.5)
        self.rv_bq[2], fc = dsp.tpt(self.rv_bq[2], shaped,
                                    *(c[:, None, :] for c in co))
        return fc + x * (1.0 - wet)[:, None, :]

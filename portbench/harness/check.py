"""The comparison that decides ``correct``: every block the window
delivered, every lane, against the configuration's plain reference fed the
same events.

The number compared is ``err_db``: over every (lane, block), the RMS of
the program's audio minus the reference's, in dB of the lane's RMS over
the whole compared stretch; a non-finite sample reads +inf.  An RMS over a
block is not moved by a one-sample step of a smoother's snap (where float32
and float64 may freeze a ramp one sample apart), and is moved by anything
that changes a block's sound.
"""

from __future__ import annotations

import math

import torch


def reference_blocks(cfg, spec, mix, log, blocks: int, device,
                     dtype=torch.float64):
    """The reference render of the events ``log`` (per block, per lane),
    one engine block [lanes, ch, n] at a time."""
    lanes, n = mix.get("lanes", 1), mix["block_frames"]
    ref = cfg.reference(spec, lanes, n, device, dtype,
                        player=mix["entry"] == "player")
    per_step = getattr(ref, "chunk_blocks", 1)  # blocks it renders per step
    for b in range(blocks):
        if b % per_step == 0:
            for b2 in range(b, min(b + per_step, blocks)):
                for lane, evs in enumerate(log[b2]):
                    for ev in evs:
                        ref.add_event(lane, ev)
            chunk = ref.step()
        j = b % per_step
        yield chunk[..., j * n:(j + 1) * n]


def compare(cfg, spec, mix, log, audio, device, dtype=torch.float64):
    """(err_db, per-answer err_db [blocks][lanes]) of the delivered
    ``audio`` (host [lanes, ch, n] per block) against the reference render
    of the same events ``log``."""
    err_sq, ref_sq = [], []
    for got, want in zip(audio, reference_blocks(
            cfg, spec, mix, log, len(audio), device, dtype)):
        want = want.double()
        have = torch.as_tensor(got, device=want.device).double()
        bad = ~torch.isfinite(have).flatten(1).all(1)
        d = torch.where(torch.isfinite(have), have - want, 0.0)
        e = d.square().flatten(1).mean(1)
        err_sq.append(torch.where(bad, torch.inf, e).cpu())
        ref_sq.append(want.square().flatten(1).mean(1).cpu())
    err_sq = torch.stack(err_sq)  # [blocks, lanes]
    lane_ms = torch.stack(ref_sq).mean(0)
    per = 10.0 * torch.log10(err_sq / lane_ms.clamp(min=1e-300))
    per = torch.nan_to_num(per, nan=math.inf, neginf=-400.0)
    return float(per.max()), per.tolist()

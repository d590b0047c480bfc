"""The reverb's delay network (``ops/reverbnet.py``) on the CPU.

* ``ReverbEffect.process`` gives, bit for bit, what its two sub-block loops
  gave when they were written inline in the effect: output and every state
  field, with the room automated across its range and a scheduled reset,
  over blocks that carry the state.
* The plain network gives the same output bit for bit at every allowed
  sub-block length of the allpass loop and of the FDN loop: nothing in it
  sums over samples, which is what lets the kernel walk tiles of any length
  up to the smallest delay.
* The allpass reads the sample written ``d`` samples earlier and the FDN's
  newest tap the one written ``d - 15`` earlier: the youngest samples the
  kernel's tiles may read.
* The kernel's wrapper raises on CPU tensors and on bad operands before it
  builds or loads anything; CPU tensors route to the plain loops.
* The router hands the kernel contiguous operands, as it requires, from
  the strided views the plain loops leave.
"""

import math

import numpy as np
import pytest
import torch

from phonic_tpu_torch import kernels
from phonic_tpu_torch.effects import reverb
from phonic_tpu_torch.graph.batching import stack_states
from phonic_tpu_torch.graph.nodes import BuildCtx
from phonic_tpu_torch.ops import consts, reverbnet

SR = 48000
LANES = 2


def _loops_as_inline(drive_in, ap_delay, line_delay, blend, regen,
                     vib_phase, ap_buf, line_buf, fb, b_ap, b_fdn, dt):
    """The effect's two sub-block loops as they were written inside
    ``ReverbEffect.process`` before they moved to ``ops/reverbnet.py``."""
    n = drive_in.shape[-1]
    lanes = drive_in.shape[0]
    dev = drive_in.device
    h_ap = ap_buf.shape[-1]
    ap_idx = ((h_ap - ap_delay)[:, :, None, None]
              + torch.arange(b_ap, device=dev)).expand(lanes, 4, 2, b_ap)
    buf4 = ap_buf
    outs = []
    for t0 in range(0, n, b_ap):
        sig = drive_in[..., t0:t0 + b_ap].to(dt)
        delayed = torch.gather(buf4, -1, ap_idx)
        writes, stage_outs = [], []
        for a in range(4):
            w = sig - delayed[:, a] * 0.5
            sig = w * 0.5 + delayed[:, a]
            writes.append(w)
            stage_outs.append(sig)
        buf4 = torch.cat([buf4[..., b_ap:], torch.stack(writes, dim=1)],
                         dim=-1)
        outs.append(torch.stack(stage_outs, dim=1))
    stages = torch.cat(outs, dim=-1)
    ap_i, ap_j, ap_k, ap_l = stages.unbind(1)
    line_in = torch.stack([ap_l, ap_k, ap_j, ap_i, ap_i, ap_j, ap_k, ap_l],
                          dim=1)
    vib_inc = consts.const(np.array([0.003251, 0.002999, 0.002917, 0.002749,
                                     0.002503, 0.002423, 0.002146, 0.002088])
                           * 0.1, dt, dev)
    vib_inc3 = vib_inc[:, None, None]
    h_ln = line_buf.shape[-1]
    base_idx = (h_ln - line_delay)[:, :, None, None]
    j = torch.arange(b_fdn, device=dev)
    vib_base = vib_phase[..., None]
    buf = line_buf
    wet_parts = []
    for t0 in range(0, n, b_fdn):
        vib = vib_base + vib_inc3 * (t0 + j).to(dt)
        vib_sin = torch.sin((vib + vib_inc3).double()).to(dt)
        offset = (vib_sin + 1.0) * 7.0
        off_floor = torch.floor(offset)
        w_frac = offset - off_floor
        gidx = base_idx + j + off_floor.to(torch.int64)
        v1 = torch.gather(buf, -1, gidx)
        v2 = torch.gather(buf, -1, gidx + 1)
        bl = blend[:, None, None, t0:t0 + b_fdn]
        interp = (1.0 - bl) * (v1 * (1.0 - w_frac) + v2 * w_frac) + v1 * bl
        rg = regen[:, None, None, t0:t0 + b_fdn]
        g1 = torch.sum(interp[:, :4], dim=1, keepdim=True)
        g2 = torch.sum(interp[:, 4:], dim=1, keepdim=True)
        gsum = torch.cat([g1.expand(-1, 4, -1, -1),
                          g2.expand(-1, 4, -1, -1)], dim=1)
        fb_now = (2.0 * interp - gsum) * rg
        fb_prev = torch.cat([fb[..., None], fb_now[..., :-1]], dim=-1)
        writes = (line_in[..., t0:t0 + b_fdn] + fb_prev).to(dt)
        buf = torch.cat([buf[..., b_fdn:], writes], dim=-1)
        fb = fb_now[..., -1]
        wet_parts.append(torch.mean(interp, dim=1))
    return torch.cat(wet_parts, dim=-1), buf4, buf, fb


def _leaves(state):
    return torch.utils._pytree.tree_leaves(state)


@pytest.mark.parametrize("n", [2048, 8192])
def test_effect_equals_the_inline_loops(n, monkeypatch):
    """The room ramps across [min_room_size, max_room_size] block by block
    (the delays follow at block rate), lane 1 resets at block 2."""
    ctx = BuildCtx(SR, 2, n, 16, torch.float32, torch.device("cpu"))
    effects = [reverb.ReverbEffect(room_size=0.6, wet=0.3, seed=s,
                                   min_room_size=0.3, max_room_size=0.9)
               for s in (0xA1B2, 7)]
    b_ap, b_fdn = effects[0]._subblocks(ctx)
    assert b_ap < n or b_fdn < n  # several sub-blocks per block
    moved = stack_states([e.init_state(ctx) for e in effects])
    inline = moved
    rng = np.random.default_rng(n)
    rooms = [(0.3, 0.5), (0.95, 0.9), (0.6, 0.3), (0.2, 0.7)]
    for block, (r0, r1) in enumerate(rooms):
        x = torch.as_tensor(rng.normal(size=(LANES, 2, n)).astype(np.float32)
                            * 0.3)
        room = torch.linspace(r0, r1, n)[None].repeat(LANES, 1)
        room[1] = torch.flip(room[1], (0,))
        p = {reverb.ROOM_SIZE.id: room,
             reverb.WET.id: torch.full((LANES, n), 0.4),
             "_reset": np.array([0.0, 1.0 if block == 2 else 0.0],
                                np.float32)}
        moved, y_moved = effects[0].process(moved, x, p, ctx)
        monkeypatch.setattr(reverb, "network", _loops_as_inline)
        inline, y_inline = effects[0].process(inline, x, p, ctx)
        monkeypatch.undo()
        assert torch.equal(y_moved, y_inline), block
        for a, b in zip(_leaves(moved), _leaves(inline)):
            assert torch.equal(a, b), block
    assert float(y_moved.abs().max()) > 0.01


N_SWEEP = 2048
# the Player's floor: allpass delays >= 1478, lines >= 2241 samples
ROOM_SWEEP = (0.55, 1.0)


def _network_operands(n=N_SWEEP, lanes=LANES, seed=0):
    """Operands of one block: rooms drawn in ``ROOM_SWEEP`` per lane,
    windows and feedback state from a previous life, a driven input."""
    rng = np.random.default_rng(seed)
    room = rng.uniform(*ROOM_SWEEP, lanes).astype(np.float32)
    size = torch.as_tensor(room * room * 75.0 + 25.0)

    def delays(f):
        return (torch.as_tensor(np.asarray(f, np.float32))
                * size[:, None]).to(torch.int64)

    def normal(*shape, scale=0.3):
        return torch.as_tensor(rng.normal(size=shape).astype(np.float32)
                               * scale)

    ramp = torch.linspace(0.0, 1.0, n)[None]
    size_n = size[:, None] * (1.0 - 0.01 * ramp)
    return dict(
        drive_in=torch.sin(normal(lanes, 2, n, scale=0.6)),
        ap_delay=delays(reverb._AP_FACTORS),
        line_delay=delays(reverb._LINE_FACTORS),
        blend=0.955 - size_n * 0.007,
        regen=(0.3 + 0.1 * ramp).repeat(lanes, 1),
        vib_phase=torch.as_tensor(rng.uniform(0.0, 2.0 * math.pi, (
            lanes, 8, 2)).astype(np.float32)),
        ap_buf=normal(lanes, 4, 2, 8192), line_buf=normal(lanes, 8, 2, 8192),
        fb=normal(lanes, 8, 2, scale=0.1))


def _powers(top):
    return [1 << k for k in range(top.bit_length()) if 1 << k <= top]


@pytest.mark.parametrize("loop,b", [("allpass", b) for b in _powers(1024)]
                         + [("fdn", b) for b in _powers(2048)])
def test_every_allowed_subblock_gives_the_same_block(loop, b):
    ops = _network_operands()
    assert int(ops["ap_delay"].min()) >= 1024
    assert int(ops["line_delay"].min()) - reverbnet.VIB_SPAN >= 2048
    want = reverbnet.network_plain(**ops, b_ap=1024, b_fdn=2048)
    subs = dict(b_ap=b, b_fdn=2048) if loop == "allpass" else dict(
        b_ap=1024, b_fdn=b)
    got = reverbnet.network_plain(**ops, **subs)
    for g, w, what in zip(got, want, ("wet", "ap_buf", "line_buf", "fb")):
        assert torch.equal(g, w), what


def test_youngest_reads():
    """One sub-block as long as the smallest delays allow (the allpass
    delays ``b``, the lines ``b + 15``).  At the sub-block's last sample
    the allpass's first stage reads the window's newest sample, and a line
    whose vibrato offset reaches its top, 14, reads the sample before the
    newest and interpolates toward the newest.  The old windows hold their
    indices; no input, no feedback, blend 1 (the older tap alone)."""
    n, h = 64, 256
    inc = reverbnet.vib_increments(torch.float32, "cpu")
    # the phase whose sine rounds to 1 at the sub-block's last sample
    top = torch.tensor(math.pi / 2, dtype=torch.float32) - inc * n
    index = torch.arange(h, dtype=torch.float32)
    wet, ap_buf, _, _ = reverbnet.network_plain(
        drive_in=torch.zeros(1, 2, n), ap_delay=torch.full((1, 4), n),
        line_delay=torch.full((1, 8), n + reverbnet.VIB_SPAN),
        blend=torch.ones(1, n), regen=torch.zeros(1, n),
        vib_phase=top[None, :, None].repeat(1, 1, 2),
        ap_buf=index.repeat(1, 4, 2, 1), line_buf=index.repeat(1, 8, 2, 1),
        fb=torch.zeros(1, 8, 2), b_ap=n, b_fdn=n)
    # stage 0 writes w = 0 - 0.5 * (the sample n back)
    assert torch.equal(ap_buf[0, 0, :, h - n:],
                       (-0.5 * index[h - n:]).repeat(2, 1))
    # every line at the last sample: h - (n + 15) + (n - 1) + 14
    assert torch.equal(wet[0, :, -1], torch.full((2,), h - 2.0))


def _no_build():
    raise AssertionError("the wrapper built the kernels before it checked")


def _kernel_operands(**bad):
    ops = _network_operands(n=64, lanes=2)
    ops.pop("drive_in")
    ops = dict(drive_in=torch.zeros(2, 2, 64), **ops)
    ops["ap_buf"], ops["line_buf"] = (torch.zeros(2, 4, 2, 256),
                                      torch.zeros(2, 8, 2, 256))
    ops.update(bad)
    return ops


@pytest.mark.parametrize("bad,exc", [
    ({}, ValueError),  # CPU tensors: the kernel runs on the card only
    ({"drive_in": torch.zeros(2, 1, 64)}, ValueError),
    ({"drive_in": torch.zeros(2, 2, 64, dtype=torch.float64)}, TypeError),
    ({"dtype": torch.float64}, TypeError),
    ({"ap_delay": torch.zeros(2, 4, dtype=torch.int32)}, TypeError),
    ({"line_delay": torch.zeros(2, 4, dtype=torch.int64)}, ValueError),
    ({"blend": torch.zeros(2, 65)}, ValueError),
    ({"regen": torch.zeros(2, 128)[:, ::2]}, ValueError),
    ({"vib_phase": torch.zeros(2, 8)}, ValueError),
    ({"ap_buf": torch.zeros(2, 4, 2, 200)}, ValueError),
    ({"line_buf": torch.zeros(3, 8, 2, 256)}, ValueError),
    ({"fb": torch.zeros(2, 8, 2, dtype=torch.float64)}, TypeError),
], ids=["cpu", "channels", "dtype", "scan_dtype", "delay_dtype",
        "delay_shape", "length", "strided", "phase", "window_pow2",
        "window_lanes", "state_dtype"])
def test_wrapper_raises_before_building(bad, exc, monkeypatch):
    monkeypatch.setattr(kernels, "library", _no_build)
    if bad:  # CPU tensors that claim to be on the card reach each check
        monkeypatch.setattr(torch.Tensor, "is_cuda", True)
    with pytest.raises(exc):
        reverbnet.network_kernel(**_kernel_operands(**bad))


def test_routes_by_device(monkeypatch):
    """CPU tensors take the plain loops; the kernel is never asked."""
    monkeypatch.setattr(reverbnet, "network_kernel", _no_build)
    ops = _network_operands(n=256)
    got = reverbnet.network(**ops, b_ap=256, b_fdn=256)
    want = reverbnet.network_plain(**ops, b_ap=256, b_fdn=256)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _strided(t):
    """``t``'s values in a view with a stride of 2 along its last axis."""
    return torch.stack([t, t], dim=-1)[..., 0]


def test_router_hands_the_kernel_contiguous_operands(monkeypatch):
    """The kernel takes contiguous operands and the plain loops leave views
    (the feedback state is the last sample of each line): the router makes
    CUDA operands contiguous before it launches, values unchanged."""
    seen = []

    def spy(*args):
        seen.append(args)
        return "launched"

    monkeypatch.setattr(reverbnet, "network_kernel", spy)
    ops = {k: _strided(t) for k, t in _network_operands(n=256).items()}
    assert not any(t.is_contiguous() for t in ops.values())
    monkeypatch.setattr(torch.Tensor, "is_cuda", True)
    assert reverbnet.network(**ops, b_ap=256, b_fdn=256) == "launched"
    (args,) = seen
    assert args[9] == torch.float32
    for t, want in zip(args[:9], ops.values()):
        assert t.is_contiguous() and torch.equal(t, want)

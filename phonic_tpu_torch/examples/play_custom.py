"""A custom user Effect and SynthDef: the analog of reference
examples/play-custom.rs (custom Effect and SynthSourceGenerator impls);
port of ``examples/play_custom.py``.

Both work over torch tensors in the port's batched form: the effect's
``process`` gets a leading lane dimension (``x`` [G, ch, n], parameters
[G, n]) and the SynthDef renders a batch of voices (``init(ctx, batch)``,
``render`` over [B, n])."""

import torch

from ..graph.nodes import BuildCtx, Effect
from ..ops import osc
from ..params import FloatParameter
from ..sources.synth import SynthDef, SynthPlaybackOptions
from .common import make_parser, make_player

DEPTH = FloatParameter("trem", "Tremolo Depth", 0.0, 1.0, 0.5)


class TremoloEffect(Effect):
    """A minimal custom effect: LFO amplitude modulation."""

    PARAMS = (DEPTH,)

    def __init__(self, rate_hz=5.0, name=None):
        super().__init__(name)
        self.rate_hz = rate_hz

    def batch_key(self, ctx: BuildCtx):
        return (type(self).__name__, self.rate_hz)

    def init_state(self, ctx: BuildCtx):
        return {"phase": torch.zeros((), dtype=torch.float32,
                                     device=ctx.device)}

    def process(self, state, x, params, ctx: BuildCtx):
        rate = torch.full(x.shape[:1] + (ctx.block_frames,), self.rate_hz,
                          device=x.device)
        ph, end = osc.phase_accumulate(state["phase"], rate, ctx.sample_rate)
        mod = 1.0 - params[DEPTH.id] * (0.5 + 0.5 * osc.sine(ph))
        return {"phase": end}, x * mod[:, None, :]


def chiptune() -> SynthDef:
    """A custom square-wave SynthDef over a batch of voices."""

    def init(ctx, batch):
        return {"phase": torch.zeros(batch, dtype=torch.float32,
                                     device=ctx.device)}

    def render(state, sctx):
        ph, end = osc.phase_accumulate(state["phase"], sctx.freq,
                                       sctx.sample_rate)
        return {"phase": end}, (osc.square(ph, sctx.freq, sctx.sample_rate)
                                * 0.3 * sctx.gate)

    return SynthDef(init=init, render=render)


def main():
    args = make_parser("custom effect + synth").parse_args()
    player = make_player(args)
    player.play_synth(chiptune(), SynthPlaybackOptions(
        frequency=330.0, duration=2 * args.sample_rate))
    fx = player.add_effect(TremoloEffect(rate_hz=6.0))
    fx.set_parameter("trem", 0.8, at=args.sample_rate)
    player.run()
    print(f"rendered {player.position} frames")
    player.close()


if __name__ == "__main__":
    main()

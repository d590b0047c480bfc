"""The JAX package's lowering of a block's notes, for tests that hold the
port's renders to it: each voice's last note start of a block only.

The port lowers a trigger slot for every note that starts on a voice in a
block (``_trig_*`` [V, K], ``_ta_*`` [V, K, knots]); the JAX package keeps
the last start.  ``one_trigger`` reduces the port's lowering to that start,
as one slot, so the port renders what the JAX package renders.
"""

import numpy as np


def last_slot(out: dict, block_len: int) -> dict:
    """``out`` (a ``_lower_notes`` result) with each voice's last used
    trigger slot only (a voice without a start keeps an unused slot)."""
    used = (out["_trig_time"] < block_len).sum(axis=1)
    last = np.maximum(used - 1, 0)[:, None]

    def keep(a):
        return np.take_along_axis(a, last.reshape(last.shape + (1,) * (
            a.ndim - 2)), axis=1)
    return {k: keep(a) if k.startswith(("_trig_", "_ta_")) else a
            for k, a in out.items()}


def one_trigger(monkeypatch, cls):
    """Lower ``cls``'s notes (a ``Sampler`` or a ``SynthGenerator``) as the
    JAX package does, through ``last_slot``."""
    lower = cls._lower_notes

    def lowered(self, plan, notes, block_start, block_len):
        return last_slot(lower(self, plan, notes, block_start, block_len),
                         block_len)
    monkeypatch.setattr(cls, "_lower_notes", lowered)

"""Render-state checkpoint / resume (port of ``phonic_tpu/checkpoint.py``).

The reference has no checkpointing (nearest analogs are seek + effect Reset
messages, src/effect/reverb.rs:470-494); explicit DSP state trees make it
natural here: snapshot a RenderProgram's state mid-render, store it, resume
later: a bit-identical continuation of filters, delays, reverb tails,
voice positions, smoothers and silence ages.

A snapshot holds the state as numpy (tensors are fetched from the device)
and a structural signature: the tree's structure, each leaf's shape and
dtype, and the engine config.  Loading it against a program checks the
signature against the program's own state first and raises
:class:`CheckpointError` listing the mismatches, then places the tensors on
the program's device.

Resuming into a REBUILT program (not the one that made the snapshot)
requires deterministic node names: auto-named nodes get process-global
sequence numbers, so an unnamed graph rebuilt from scratch produces
different state paths and will (correctly) fail verification.
"""

from __future__ import annotations

import pickle

import numpy as np
import torch

from .errors import CheckpointError
from .graph.engine import tree_leaves, tree_map

_MAGIC = "phonic_tpu_torch-checkpoint"
_VERSION = 1


def _structure(tree) -> str:
    """The tree's structure without its leaves, as text."""
    return repr(tree_map(lambda _: "*", tree))


def _dtype_name(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).removeprefix("torch.")
    return str(np.asarray(x).dtype)


def state_signature(state, config=None) -> dict:
    """Structural signature of a render state: enough to detect any
    topology / shape / dtype drift between snapshot and resume.  Tensors
    and their numpy copies give the same signature."""
    return {
        "treedef": _structure(state),
        "leaves": [(tuple(np.shape(x)), _dtype_name(x))
                   for x in tree_leaves(state)],
        "config": _config_repr(config),
    }


def _config_repr(config):
    """The engine config as text, without the device: a snapshot taken on
    the card resumes on the CPU and back."""
    if config is None:
        return None
    fields = {k: v for k, v in vars(config).items() if k != "device"}
    return f"{type(config).__name__}({fields})"


def _diff_signatures(saved: dict, current: dict) -> list[str]:
    problems = []
    if saved["treedef"] != current["treedef"]:
        problems.append(
            "state tree structure differs (graph topology changed since the "
            "snapshot; rebuild the same graph or carry state across edits "
            "with RenderProgram.adopt())")
    else:
        for i, (a, b) in enumerate(zip(saved["leaves"], current["leaves"])):
            sa, sb = (tuple(a[0]), a[1]), (tuple(b[0]), b[1])
            if sa != sb:
                problems.append(f"leaf {i}: snapshot {sa[0]}/{sa[1]} vs "
                                f"program {sb[0]}/{sb[1]}")
            if len(problems) >= 4:
                problems.append("...")
                break
    if (saved.get("config") and current.get("config")
            and saved["config"] != current["config"]):
        problems.append(f"engine config differs: snapshot "
                        f"{saved['config']} vs program {current['config']}")
    return problems


def save_state(state, path=None, program=None):
    """Snapshot a render state to host numpy (and optionally to disk).

    With ``program`` given, the snapshot embeds the program's config in its
    signature; :func:`load_state` then verifies shape, dtype, tree structure
    and config before handing the state back."""
    host = tree_map(lambda x: x.detach().cpu().numpy().copy()
                    if isinstance(x, torch.Tensor) else np.asarray(x), state)
    if path is not None:
        snap = {
            "magic": _MAGIC,
            "version": _VERSION,
            "signature": state_signature(
                host, getattr(program, "config", None)),
            "state": host,
        }
        with open(path, "wb") as f:
            pickle.dump(snap, f)
    return host


def load_state(path_or_tree, program=None):
    """Load a snapshot (a path, or the tree :func:`save_state` returned).

    With ``program`` given, raises :class:`CheckpointError` describing every
    structural mismatch (topology edits, block-size / config changes, dtype
    drift), then returns the state as tensors on the program's device;
    without it, returns the numpy tree."""
    if isinstance(path_or_tree, (str, bytes)) or hasattr(path_or_tree,
                                                         "__fspath__"):
        with open(path_or_tree, "rb") as f:
            snap = pickle.load(f)
        if not (isinstance(snap, dict) and snap.get("magic") == _MAGIC):
            raise CheckpointError(f"{path_or_tree}: not a checkpoint of "
                                  "this package")
        state, saved_sig = snap["state"], snap["signature"]
    else:
        state, saved_sig = path_or_tree, None
    if program is None:
        return state
    current = state_signature(program.init_state(), program.config)
    problems = _diff_signatures(saved_sig or state_signature(state), current)
    if problems:
        raise CheckpointError(
            "checkpoint does not match the program it is being resumed "
            "into:\n  - " + "\n  - ".join(problems))
    return tree_map(lambda a: torch.as_tensor(np.asarray(a),
                                              device=program.device), state)

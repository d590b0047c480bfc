"""Carry a JAX render state over to the port.

:func:`state_from_jax` takes a ``phonic_tpu`` ``RenderProgram`` state,
fetched to numpy (``jax.device_get``), and returns the equivalent state of a
port program built from the same graph description with the same node
names.  Running state carries over: file positions, sampler voice
positions, synth voice states, smoother states, filter states, delay
windows, LFO and vibrato phases, reverb buffers.  Static data (source
buffers, per-lane metadata, a high-quality bank's sinc table) is not taken
from the JAX state — the JAX package holds it packed for its chip — but
comes from the port program's own graph.  This package never imports JAX;
the argument is plain numpy.
"""

from __future__ import annotations

import numpy as np
import torch


def _like(template, value, where: str):
    """``value`` (numpy tree) shaped, typed and placed like ``template``
    (tensor tree).  Walks the template's keys, so keys the port does not
    keep in its state (a file bank's "buf", "meta" and "sinc") are skipped
    by name."""
    if isinstance(template, torch.Tensor):
        arr = np.asarray(value)
        if arr.size != template.numel():
            raise ValueError(f"{where}: JAX state has shape {arr.shape}, the "
                             f"port expects {tuple(template.shape)}")
        return torch.tensor(arr.reshape(template.shape), dtype=template.dtype,
                            device=template.device)
    if isinstance(template, dict):
        missing = [k for k in template if k not in value]
        if missing:
            raise KeyError(f"{where}: JAX state lacks {missing}")
        return {k: _like(t, value[k], f"{where}/{k}")
                for k, t in template.items()}
    return type(template)(*(_like(t, v, f"{where}[{i}]")
                            for i, (t, v) in enumerate(zip(template, value))))


def _stack(trees):
    """Stack numpy trees (nested dicts and tuples of arrays) along a new
    first axis."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    if isinstance(trees[0], tuple):
        return tuple(_stack(list(xs)) for xs in zip(*trees))
    return np.stack([np.asarray(t) for t in trees])


def _node(np_state, path: str):
    try:
        return np_state["nodes"][path]
    except KeyError:
        raise KeyError(f"JAX state has no node {path!r}: build both programs "
                       "from the same graph with the same node names") from None


def state_from_jax(np_state, program):
    """Port state of ``program`` equal to the JAX state ``np_state``.

    Where the JAX package batches (file sources and samplers in groups of
    two or more, sibling effect chains), its state holds stacked lanes
    numbered in the order the port enumerates its own banks, pools and
    chains; where it does not, the node's own entry is used and gets the
    port's lane dimension of 1.  A granular sampler is never batched: its
    state, grain pools included, is its node's own, and it takes no
    ``gen_batches`` entry; nor is a synth generator, whose voices' synth
    state is its node's own with a leading V.  A bank of synth or streamed
    sources keeps its lanes' statics (``_statics``) from the port program,
    and a streamed bank has no running state.  Under auto-bypass the
    silence ages map onto each chain's [stages, lanes] matrix."""
    template = program.init_state()
    smoothers = {key: _like(t, np_state["smoothers"][key], f"smoothers{key}")
                 for key, t in template["smoothers"].items()}

    file_batches, gid = [], 0
    keys = ("base", "frac", "frac_lo")
    for batch, t in zip(program.file_batches, template["file_batches"]):
        if program.config.batch_sources and len(batch.paths) >= 2:
            lanes = np_state["file_batches"][gid]
            gid += 1
        else:
            lanes = {k: np.stack([np.asarray(_node(np_state, p)[k])
                                  for p in batch.paths]) for k in keys}
        file_batches.append(_like(t, lanes, f"file_batches/{batch.paths[0]}"))

    pools, gid = [], 0
    for pool, t in zip(program.pools, template["pools"]):
        # a bank's statics are static config: the port's own
        t = dict(t)
        statics = t.pop("_statics", None)
        if program.config.batch_sources and len(pool.paths) >= 2:
            lanes = np_state["gen_batches"][gid]
            gid += 1
        else:
            lanes = _stack([{k: _node(np_state, p)[k] for k in t}
                            for p in pool.paths])
        st = _like(t, lanes, f"pools/{pool.paths[0]}")
        if statics is not None:
            st["_statics"] = statics
        pools.append(st)

    chains, gid = [], 0
    for c, t in zip(program.chains, template["chains"]):
        if len(c["mixers"]) >= 2:
            per_effect = np_state["effect_batches"][gid]
            gid += 1
        else:
            per_effect = [_node(np_state, p) for p in c["effect_paths"][0]]
        chains.append([_like(ti, si, eps) for ti, si, eps in
                       zip(t, per_effect, c["effect_paths"][0])])
    state = {"smoothers": smoothers, "file_batches": file_batches,
             "pools": pools, "chains": chains}
    if "bypass" in template:
        # silence ages: the JAX package keys an unbatched effect's by its
        # path and a batched group's [stages, lanes] matrix by
        # ``__batch{gid}``; the port holds one [stages, lanes] per chain
        ages, gid = [], 0
        for c, t in zip(program.chains, template["bypass"]):
            if len(c["mixers"]) >= 2:
                a = np_state["bypass"][f"__batch{gid}"]
                gid += 1
            else:
                a = np.array([[np_state["bypass"][p]]
                              for p in c["effect_paths"][0]])
            ages.append(_like(t, a, f"bypass/{c['mixer_paths'][0]}"))
        state["bypass"] = ages
    return state

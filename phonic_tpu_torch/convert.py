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

:func:`batched_state_from_jax` does the same for the stacked lane states
of the JAX package's ``BatchedRenderProgram``: lane k of each of its
leaves becomes lane k of each folded bank of the port's
``BatchedRenderProgram``.
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

    # the JAX package's lane-batched programs step a twin with batched
    # effect chains off: its chain states are its nodes' own
    chains, gid = [], 0
    batched = bool(np_state.get("effect_batches"))
    for c, t in zip(program.chains, template["chains"]):
        if len(c["mixers"]) >= 2 and batched:
            per_effect = np_state["effect_batches"][gid]
            gid += 1
        else:
            per_effect = [_stack([_node(np_state, eps[i])
                                  for eps in c["effect_paths"]])
                          for i in range(len(c["effect_paths"][0]))]
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
            if len(c["mixers"]) >= 2 and batched:
                a = np_state["bypass"][f"__batch{gid}"]
                gid += 1
            else:
                a = np.array([[np_state["bypass"][eps[i]]
                               for eps in c["effect_paths"]]
                              for i in range(len(c["effect_paths"][0]))])
            ages.append(_like(t, a, f"bypass/{c['mixer_paths'][0]}"))
        state["bypass"] = ages
    return state


def _lane(tree, k: int):
    """Lane ``k`` of every leaf of a numpy state tree."""
    if isinstance(tree, dict):
        return {key: _lane(v, k) for key, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_lane(v, k) for v in tree]
        return (type(tree)(*out) if hasattr(tree, "_fields")
                else type(tree)(out))
    return np.asarray(tree)[k]


def batched_state_from_jax(np_states, batched):
    """Port states (one per shard) of the port's ``BatchedRenderProgram``
    ``batched`` equal to the JAX package's stacked lane states
    ``np_states`` (``jax.device_get`` of its ``BatchedRenderProgram``
    state, every leaf with a leading lanes axis), built from the same
    graph description with the same node names.

    Each lane converts as :func:`state_from_jax` converts one program's
    state, and lane k lands in rows ``k * G .. k * G + G - 1`` of each
    folded bank of G members (its silence ages in columns of each chain's
    [stages, lanes * G]).  A parameter group whose smoother state is equal
    in every lane of a shard keeps one lane's rows ``[P]`` (the lanes share
    the smoothing); one whose lanes differ takes every lane's, ``[L*P]``
    lane-major, as a program that has stepped per-lane inputs holds it."""
    from .graph.engine import tree_leaves, tree_map

    lanes = [state_from_jax(_lane(np_states, k), batched.program)
             for k in range(batched.lanes)]
    per = batched.lanes // len(batched.shards)
    out = []
    for j, shard in enumerate(batched.shards):
        group = lanes[j * per:(j + 1) * per]
        smoothers = {}
        for key, st0 in group[0]["smoothers"].items():
            sts = [g["smoothers"][key] for g in group]
            equal = all(torch.equal(a, b) for st in sts[1:] for a, b in
                        zip(tree_leaves(st0), tree_leaves(st)))
            smoothers[key] = st0 if equal else tree_map(
                lambda *xs: torch.cat(xs), *sts)
        st = {"smoothers": smoothers}
        for key in ("file_batches", "pools", "chains"):
            st[key] = tree_map(lambda *xs: torch.cat(xs),
                               *(g[key] for g in group))
        if "bypass" in group[0]:
            st["bypass"] = [torch.cat(xs, dim=1) for xs in
                            zip(*(g["bypass"] for g in group))]
        out.append(tree_map(lambda t: t.to(shard.device), st))
    return out

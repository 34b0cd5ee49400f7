"""Carry aggregate state between the JAX package's leaves and the port.

``state_from_numpy`` takes the reference's ``AggState`` leaves as numpy
arrays (what ``ShardedAggregator.state_arrays()`` returns) and builds the
port's state: one shard's (the leading shard axis of one, or none) on
``device`` (the card unless the caller names another), or, with ``mesh``,
one state per mesh device, shard ``s`` from row ``s`` of the leading shard
axis of S. ``state_to_numpy`` gives the leaves back with the reference's
dtypes: one state's without a shard axis, a list of per-shard states
stacked on a leading axis of S, so two states can be diffed leaf by leaf.
``vocab_from_reference`` carries the store's host state, the name and key
interners, from plain lists. numpy and torch only.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from zipkin_tpu_torch.device import resolve_device
from zipkin_tpu_torch.tpu.columnar import Vocab
from zipkin_tpu_torch.tpu.state import LEAF_DTYPES, AggConfig, AggState, init_state, torch_dtype


def state_from_numpy(leaves: Sequence[np.ndarray], config: AggConfig, device=None,
                     mesh=None):
    """The port's state from reference leaves (in AggState order): one
    AggState on ``device``, or with ``mesh`` the list of per-shard states,
    shard ``s`` on ``mesh[s]``, from leaves whose leading axis is
    ``len(mesh)`` (a one-shard mesh also takes leaves without it)."""
    if len(leaves) != len(AggState._fields):
        raise ValueError(f"expected {len(AggState._fields)} leaves, got {len(leaves)}")
    if mesh is None:
        device = resolve_device(device)
    else:
        mesh = [resolve_device(d) for d in mesh]
    template = init_state(config, "meta")
    shards = None if mesh is None else len(mesh)
    per_shard = [[] for _ in range(shards or 1)]
    for name, leaf, want in zip(AggState._fields, leaves, template):
        a = np.asarray(leaf)
        if a.ndim == want.dim() + 1 and (shards is None or a.shape[0] == shards):
            rows = a  # the leading shard axis
        else:
            rows = a[None]
        if (shards or 1) != rows.shape[0]:
            raise ValueError(f"leaf {name}: {rows.shape[0]} shards, the mesh has {shards or 1}")
        if tuple(rows.shape[1:]) != tuple(want.shape):
            raise ValueError(f"leaf {name}: shape {a.shape}, expected {tuple(want.shape)}")
        for i, row in enumerate(rows):
            row = np.array(row, dtype=LEAF_DTYPES[name], copy=True)
            t = torch.from_numpy(row).to(torch_dtype(LEAF_DTYPES[name]))
            per_shard[i].append(t.to(device if mesh is None else mesh[i]))
    states = [AggState(*out) for out in per_shard]
    return states[0] if mesh is None else states


def state_to_numpy(state) -> list:
    """Every leaf as numpy with the reference's dtype: an AggState's with
    its own shape, a list of per-shard states' stacked on a leading shard
    axis."""
    if not isinstance(state, AggState):
        shards = [state_to_numpy(s) for s in state]
        return [np.stack(rows) for rows in zip(*shards)]
    out = []
    for name, t in zip(AggState._fields, state):
        a = t.detach().cpu().numpy()
        if LEAF_DTYPES[name] == np.uint32:
            a = (a & 0xFFFFFFFF).astype(np.uint32)
        else:
            a = a.astype(LEAF_DTYPES[name])
        out.append(a)
    return out


def vocab_from_reference(services: Sequence[str], span_names: Sequence[str],
                         keys: Sequence[Sequence[int]], max_services: int = 1024,
                         max_keys: int = 8192) -> Vocab:
    """A :class:`Vocab` with the given id assignment: ``services`` and
    ``span_names`` are the names by id and ``keys`` the (service id, span
    name id) pairs by key id, each with id 0's entry first (the reference
    store's ``vocab.services._names``, ``vocab.span_names._names`` and
    ``vocab._key_list``). Later interning continues from there."""
    if not services or services[0] or not span_names or span_names[0]:
        raise ValueError("services and span_names must start with id 0's empty name")
    if not keys or tuple(keys[0]) != (0, 0):
        raise ValueError("keys must start with id 0's (0, 0) pair")
    if len(services) > max_services or len(keys) > max_keys:
        raise ValueError("the id assignment exceeds the vocab's capacity")
    v = Vocab(max_services=max_services, max_keys=max_keys)
    v.services._names = list(services)
    v.services._ids = {n: i for i, n in enumerate(services) if i}
    v.span_names._names = list(span_names)
    v.span_names._ids = {n: i for i, n in enumerate(span_names) if i}
    v._key_list = [(int(a), int(b)) for a, b in keys]
    v._keys = {pair: i for i, pair in enumerate(v._key_list) if i}
    return v

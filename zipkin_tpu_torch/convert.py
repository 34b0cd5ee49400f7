"""Carry aggregate state between the JAX package's leaves and the port.

``state_from_numpy`` takes the reference's ``AggState`` leaves as numpy
arrays with their leading shard axis of S (what
``ShardedAggregator.state_arrays()`` returns) and builds the port's list
of per-shard states, shard ``s`` from row ``s`` on ``mesh[s]`` (without a
mesh, one shard on ``device``: the card unless the caller names another).
``state_to_numpy`` takes such a list and gives the leaves back with the
reference's dtypes, stacked on the leading shard axis, so two states can
be diffed leaf by leaf.
``vocab_from_reference`` carries the store's host state, the name and key
interners, from plain lists. numpy and torch only.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from zipkin_tpu_torch.device import resolve_device
from zipkin_tpu_torch.tpu.columnar import Vocab
from zipkin_tpu_torch.tpu.state import LEAF_DTYPES, AggConfig, AggState, init_state, torch_dtype


def state_from_numpy(leaves: Sequence[np.ndarray], config: AggConfig, device=None,
                     mesh=None) -> List[AggState]:
    """The port's per-shard states from reference leaves (in AggState
    order, each with the leading shard axis of ``len(mesh)``): shard ``s``
    on ``mesh[s]``; without ``mesh``, one shard on ``device``."""
    if len(leaves) != len(AggState._fields):
        raise ValueError(f"expected {len(AggState._fields)} leaves, got {len(leaves)}")
    mesh = [resolve_device(device)] if mesh is None else [resolve_device(d) for d in mesh]
    template = init_state(config, "meta")
    per_shard = [[] for _ in mesh]
    for name, leaf, want in zip(AggState._fields, leaves, template):
        a = np.asarray(leaf)
        if a.ndim != want.dim() + 1:
            raise ValueError(f"leaf {name}: shape {a.shape} lacks the leading shard axis")
        if a.shape[0] != len(mesh):
            raise ValueError(f"leaf {name}: {a.shape[0]} shards, the mesh has {len(mesh)}")
        if tuple(a.shape[1:]) != tuple(want.shape):
            raise ValueError(f"leaf {name}: shape {a.shape}, expected (S, *{tuple(want.shape)})")
        for i, row in enumerate(a):
            row = np.array(row, dtype=LEAF_DTYPES[name], copy=True)
            t = torch.from_numpy(row).to(torch_dtype(LEAF_DTYPES[name]))
            per_shard[i].append(t.to(mesh[i]))
    return [AggState(*out) for out in per_shard]


def _leaves(state: AggState) -> list:
    out = []
    for name, t in zip(AggState._fields, state):
        a = t.detach().cpu().numpy()
        if LEAF_DTYPES[name] == np.uint32:
            a = (a & 0xFFFFFFFF).astype(np.uint32)
        else:
            a = a.astype(LEAF_DTYPES[name])
        out.append(a)
    return out


def state_to_numpy(states: Sequence[AggState]) -> list:
    """Every leaf of the per-shard states as numpy with the reference's
    dtype, stacked on a leading shard axis of ``len(states)``."""
    if isinstance(states, AggState):
        raise TypeError("state_to_numpy takes the list of per-shard states")
    shards = [_leaves(s) for s in states]
    return [np.stack(rows) for rows in zip(*shards)]


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

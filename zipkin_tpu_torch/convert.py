"""Carry aggregate state between the JAX package's leaves and the port.

``state_from_numpy`` takes the reference's ``AggState`` leaves as numpy
arrays (what ``ShardedAggregator.state_arrays()`` returns — with the
leading shard axis of one shard, or without it) and builds the port's
state on ``device`` (the card unless the caller names another); ``state_to_numpy`` gives them back with the
reference's dtypes and shapes (no shard axis), so two states can be
diffed leaf by leaf. ``vocab_from_reference`` carries the store's host
state, the name and key interners, from plain lists. numpy and torch only.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from zipkin_tpu_torch.device import resolve_device
from zipkin_tpu_torch.tpu.columnar import Vocab
from zipkin_tpu_torch.tpu.state import LEAF_DTYPES, AggConfig, AggState, init_state, torch_dtype


def state_from_numpy(leaves: Sequence[np.ndarray], config: AggConfig, device=None) -> AggState:
    """The port's state from reference leaves (in AggState order)."""
    device = resolve_device(device)
    if len(leaves) != len(AggState._fields):
        raise ValueError(f"expected {len(AggState._fields)} leaves, got {len(leaves)}")
    template = init_state(config, "meta")
    out = []
    for name, leaf, want in zip(AggState._fields, leaves, template):
        a = np.asarray(leaf)
        if a.ndim == want.dim() + 1 and a.shape[0] == 1:
            a = a[0]  # the leading shard axis of a one-shard mesh
        if tuple(a.shape) != tuple(want.shape):
            raise ValueError(f"leaf {name}: shape {a.shape}, expected {tuple(want.shape)}")
        a = np.array(a, dtype=LEAF_DTYPES[name], copy=True)
        t = torch.from_numpy(a).to(torch_dtype(LEAF_DTYPES[name]))
        out.append(t.to(device))
    return AggState(*out)


def state_to_numpy(state: AggState) -> list:
    """Every leaf as numpy with the reference's dtype and shape."""
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

"""Carry aggregate state between the JAX package's leaves and the port.

``state_from_numpy`` takes the reference's ``AggState`` leaves as numpy
arrays (what ``ShardedAggregator.state_arrays()`` returns — with the
leading shard axis of one shard, or without it) and builds the port's
state on ``device`` (the card unless the caller names another); ``state_to_numpy`` gives them back with the
reference's dtypes and shapes (no shard axis), so two states can be
diffed leaf by leaf. numpy and torch only.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from zipkin_tpu_torch.device import resolve_device
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

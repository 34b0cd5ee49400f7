"""The shard mesh of the aggregation tier (port of ``zipkin_tpu/parallel/mesh.py``).

One logical axis, ``shard``: span-hash data parallelism. The reference
builds a 1-D ``jax.sharding.Mesh`` over its devices; here a mesh is the
ordered list of ``torch.device``s, one per shard. Shard ``s`` keeps its
state on ``mesh[s]`` and the cross-shard merges reduce on ``mesh[0]``, so
a mesh of distinct cards spreads the state over them (peer copies, no
collective library) and a mesh that repeats one device runs several
shards on it, as the reference's tests run eight shards on eight virtual
CPU devices of one host.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import torch

SHARD_AXIS = "shard"

Mesh = List[torch.device]


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence[Union[str, torch.device]]] = None) -> Mesh:
    """A mesh over ``n_devices`` of ``devices`` (default: every visible
    card, ``cuda:0`` to ``cuda:{count-1}``). More shards than devices is
    an error, never a quiet fallback; a caller who wants several shards on
    one device lists it that many times."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain PyTorch path"
            )
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    for d in devices:
        if d.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {d} requested but CUDA is not available")
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(f"requested {n_devices} devices, have {len(devices)}")
        devices = devices[:n_devices]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return list(devices)

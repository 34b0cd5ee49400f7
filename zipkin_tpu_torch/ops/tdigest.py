"""Merging t-digest with sort-based compaction (port of ``zipkin_tpu/ops/tdigest.py``).

Digests are float32 ``[slots, C, 2]`` (mean, weight). The reference's
``jnp.lexsort`` becomes two stable sorts, its one-hot einsum cluster sums
become scatter-adds, and its vmapped ``jnp.interp`` is written out
batched with the same edge rules. Sums run in another order than XLA's,
so means agree to float32 rounding, not bit for bit; weights are
integer-valued and agree exactly.

:func:`update` folds a weighted batch into the digests with one global
sort (the streaming form, which the aggregator's buffered flush replaces
with :func:`compact_points` + :func:`row_merge`); :func:`merge` and
:func:`merge_many` are the cross-shard merges: a shard-major concatenation
of every shard's centroids, reclustered row by row.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from zipkin_tpu_torch.device import resolve_device
from zipkin_tpu_torch.ops.segments import sorted_segment_cumsum, sorted_segment_total

_INF = float("inf")


def cluster_q_width(c: int, q: float) -> float:
    """Width in q-space of the k1-scale cluster covering quantile ``q``."""
    return min(0.5, math.pi * math.sqrt(max(q * (1.0 - q), 0.0)) / c + 0.5 / c)


def new_digests(slots: int, centroids: int = 64, device=None) -> torch.Tensor:
    """Zeroed digest state ``[slots, centroids, 2]`` (mean, weight)
    float32, on the card unless ``device`` names another."""
    return torch.zeros((slots, centroids, 2), dtype=torch.float32,
                       device=resolve_device(device))


def _cluster_ids(q: torch.Tensor, c: int) -> torch.Tensor:
    """k1 scale function: cluster = floor(C * (asin(2q-1)/pi + 1/2))."""
    x = torch.clamp(2.0 * q - 1.0, -1.0, 1.0)
    k = torch.asin(x) / math.pi + 0.5
    return torch.clamp((k * c).to(torch.int64), 0, c - 1)


def _lexsort_slot_mean(mean: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """``jnp.lexsort((mean, slot))``: by slot, then mean, stable."""
    o1 = torch.sort(mean, stable=True).indices
    o2 = torch.sort(slot[o1], stable=True).indices
    return o1[o2]


def _cluster_sorted(mean, w, slot, slots: int, c: int) -> torch.Tensor:
    """Points sorted by (slot, mean) -> ``[slots, c, 2]``: within-slot
    quantile positions, k1 cluster ids, and the (weight, weight*mean)
    sums of each (slot, cluster)."""
    cum = sorted_segment_cumsum(w, slot)
    total = sorted_segment_total(w, slot)
    q = torch.where(total > 0, (cum - 0.5 * w) / torch.clamp(total, min=1e-9),
                    torch.zeros_like(w))
    cluster = _cluster_ids(q, c)

    dest = slot * c + cluster
    wsum = torch.zeros(slots * c, dtype=torch.float32, device=w.device).index_add_(0, dest, w)
    m0 = torch.where(torch.isfinite(mean), mean, torch.zeros_like(mean))
    msum = torch.zeros_like(wsum).index_add_(0, dest, w * m0)
    new_mean = torch.where(wsum > 0, msum / torch.clamp(wsum, min=1e-9), torch.zeros_like(wsum))
    return torch.stack([new_mean, wsum], dim=-1).reshape(slots, c, 2)


def update(digests: torch.Tensor, slot_ids, values, weights) -> torch.Tensor:
    """Merge a batch of weighted values into their slots' digests with one
    (two-pass stable) sort of the existing centroids and the batch.

    ``slot_ids`` in [0, slots); lanes with weight 0 are inert. Returns
    digests of the same shape."""
    u, c, _ = digests.shape
    dev = digests.device
    st_slot = torch.arange(u * c, dtype=torch.int64, device=dev) // c
    mean = torch.cat([digests[..., 0].reshape(-1), values.to(torch.float32).to(dev)])
    w = torch.cat([digests[..., 1].reshape(-1), weights.to(torch.float32).to(dev)])
    slot = torch.cat([st_slot, slot_ids.to(torch.int64).to(dev)])
    # empty centroids and inert lanes sort to their slot's tail
    mean = torch.where(w > 0, mean, torch.full_like(mean, _INF))
    order = _lexsort_slot_mean(mean, slot)
    return _cluster_sorted(mean[order], w[order], slot[order], u, c)


def compact_points(slot_ids, values, weights, slots: int, c: int) -> torch.Tensor:
    """Compact a flat weighted point list into per-slot partial digests
    ``[slots, c, 2]`` with one (two-pass stable) sort of the points."""
    w = weights.to(torch.float32)
    mean = torch.where(w > 0, values.to(torch.float32), torch.full_like(w, _INF))
    slot = slot_ids.to(torch.int64)

    order = _lexsort_slot_mean(mean, slot)
    return _cluster_sorted(mean[order], w[order], slot[order], slots, c)


def row_merge(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Merge digests slot-wise: ``[K, Ca, 2]`` + ``[K, Cb, 2]`` -> ``[K, Ca, 2]``
    with one row-parallel stable sort of the Ca+Cb centroids."""
    k, ca, _ = a.shape
    m = torch.cat([a[..., 0], b[..., 0]], dim=-1)
    w = torch.cat([a[..., 1], b[..., 1]], dim=-1)
    m = torch.where(w > 0, m, torch.full_like(m, _INF))

    m, order = torch.sort(m, dim=-1, stable=True)
    w = torch.gather(w, -1, order)

    cum = torch.cumsum(w, dim=-1)
    total = cum[..., -1:]
    q = torch.where(total > 0, (cum - 0.5 * w) / torch.clamp(total, min=1e-9),
                    torch.zeros_like(w))
    cluster = _cluster_ids(q, ca)

    m0 = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    wsum = torch.zeros((k, ca), dtype=torch.float32, device=a.device).scatter_add_(1, cluster, w)
    msum = torch.zeros_like(wsum).scatter_add_(1, cluster, w * m0)
    new_mean = torch.where(wsum > 0, msum / torch.clamp(wsum, min=1e-9), torch.zeros_like(wsum))
    return torch.stack([new_mean, wsum], dim=-1)


def quantile(digests: torch.Tensor, qs: torch.Tensor) -> torch.Tensor:
    """Quantiles per slot: ``[slots, Q]`` float32, 0 for empty slots.

    Centroid means at cumulative-weight midpoints, linear in between —
    ``jnp.interp`` row by row: index = right-searchsorted clipped to
    [1, C-1], a zero-width step takes the left value, and targets outside
    [xp[0], xp[-1]] take the end values."""
    means = digests[..., 0]
    ws = digests[..., 1]
    cum = (torch.cumsum(ws, dim=-1) - 0.5 * ws).contiguous()
    total = torch.sum(ws, dim=-1, keepdim=True)
    x = torch.where(ws > 0, means, torch.full_like(means, -_INF))
    x = torch.cummax(x, dim=-1).values
    x = torch.where(torch.isfinite(x), x, torch.zeros_like(x))

    qs = qs.to(torch.float32).to(digests.device)
    targets = (qs[None, :] * total).contiguous()  # [slots, Q]
    c = cum.shape[-1]
    i = torch.clamp(torch.searchsorted(cum, targets, right=True), 1, c - 1)
    xp0, xp1 = torch.gather(cum, 1, i - 1), torch.gather(cum, 1, i)
    fp0, fp1 = torch.gather(x, 1, i - 1), torch.gather(x, 1, i)
    df = fp1 - fp0
    dx = xp1 - xp0
    delta = targets - xp0
    eps = float(np.spacing(np.finfo(np.float32).eps))
    dx0 = torch.abs(dx) <= eps
    f = torch.where(dx0, fp0, fp0 + (delta / torch.where(dx0, torch.ones_like(dx), dx)) * df)
    f = torch.where(targets < cum[:, :1], x[:, :1].expand_as(f), f)
    f = torch.where(targets > cum[:, -1:], x[:, -1:].expand_as(f), f)
    return torch.where(total > 0, f, torch.zeros_like(f))



def merge(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Merge two digest states slot-wise (row-parallel re-compaction)."""
    return row_merge(a, b)


def merge_many(states) -> torch.Tensor:
    """Merge ``[shards, U, C, 2]`` (a tensor, or a sequence of ``[U, C, 2]``
    on one device) into one ``[U, C, 2]``: one shard is returned as it is;
    more are concatenated shard-major along the centroid axis, the order of
    the reference's all-gather, and reclustered row by row."""
    if len(states) == 1:
        return states[0]
    arr = states if isinstance(states, torch.Tensor) else torch.stack(list(states))
    d, u, c, _ = arr.shape
    all_c = arr.movedim(0, 1).reshape(u, d * c, 2)
    return row_merge(torch.zeros((u, c, 2), dtype=torch.float32, device=arr.device), all_c)

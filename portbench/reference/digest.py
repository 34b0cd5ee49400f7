"""The latency digests' stated rules in plain PyTorch: a merging t-digest
of ``C`` centroids a key, float32 (mean, weight), fed through a pending
buffer of ``digest_buffer`` points that is folded in whole.

- A fold sorts the pending points by (key, value), gives each point the
  quantile position ``(cum - w / 2) / total`` within its key and the k1
  cluster ``floor(C * (asin(2q - 1) / pi + 1 / 2))``, and sums each
  cluster's weight and weighted mean; the key's old centroids and these
  new ones are then sorted by mean and reclustered the same way.
- The buffer is folded before a batch that would overflow it, and by every
  read that finds it non-empty (the store's flush-then-read): the run
  records the batch count of each such read's fold.
- A quantile read interpolates linearly between centroid means placed at
  their cumulative-weight midpoints, taking the end means outside them.

``lower=True`` keeps the means and the points' values in bfloat16, the
precision below the stated one: the control's digests. Nothing here
imports the program.
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Iterable, List, Tuple

import torch

_INF = float("inf")


def fold_groups(n: int, batch: int, buffer: int, read_folds: Iterable[int]) -> List[Tuple[int, int]]:
    """The folds of a stream of ``n`` batches of ``batch`` points, in
    order, as ``(first, end)`` ranges of the batches each folds: before a
    batch that would overflow the buffer, and at each batch count of
    ``read_folds``; the points still pending after ``n`` are folded last
    (the final read's flush)."""
    reads = Counter(int(r) for r in read_folds)
    groups = []
    start, pend = 0, 0
    for g in range(n + 1):
        for _ in range(reads.get(g, 0)):
            groups.append((start, g))
            start, pend = g, 0
        if g == n:
            break
        if pend + batch > buffer:
            groups.append((start, g))
            start, pend = g, 0
        pend += batch
    if start < n:
        groups.append((start, n))
    return groups


def _clusters(q: torch.Tensor, c: int) -> torch.Tensor:
    k = torch.asin(torch.clamp(2.0 * q - 1.0, -1.0, 1.0)) / math.pi + 0.5
    return torch.clamp((k * c).to(torch.int64), 0, c - 1)


def _round(x: torch.Tensor, lower: bool) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32) if lower else x


def compact(keys: torch.Tensor, values: torch.Tensor, rows: int, c: int,
            lower: bool = False) -> torch.Tensor:
    """Points (``keys`` >= 0, float32 ``values``, weight 1 each) as
    ``[rows, c, 2]`` per-key partial digests."""
    live = keys >= 0
    keys, values = keys[live], _round(values[live].to(torch.float32), lower)
    order = torch.argsort(keys * (1 << 32) + values.view(torch.int32).to(torch.int64),
                          stable=True)
    keys, values = keys[order], values[order]
    ones = torch.ones_like(values)
    n_key = torch.bincount(keys, minlength=rows)
    first = torch.cumsum(n_key, 0) - n_key
    cum = (torch.arange(1, len(keys) + 1, device=keys.device) - first[keys]).to(torch.float32)
    total = n_key[keys].to(torch.float32)
    q = (cum - 0.5 * ones) / total
    dest = keys * c + _clusters(q, c)
    wsum = torch.zeros(rows * c, device=keys.device).index_add_(0, dest, ones)
    msum = torch.zeros_like(wsum).index_add_(0, dest, values)
    mean = torch.where(wsum > 0, msum / torch.clamp(wsum, min=1e-9), torch.zeros_like(wsum))
    return torch.stack([_round(mean, lower), wsum], -1).reshape(rows, c, 2)


def merge(a: torch.Tensor, b: torch.Tensor, lower: bool = False) -> torch.Tensor:
    """Each key's centroids of ``a`` and ``b`` [rows, c, 2], reclustered
    into ``c``."""
    rows, c, _ = a.shape
    m = torch.cat([a[..., 0], b[..., 0]], -1)
    w = torch.cat([a[..., 1], b[..., 1]], -1)
    m, order = torch.sort(torch.where(w > 0, m, torch.full_like(m, _INF)), dim=-1, stable=True)
    w = torch.gather(w, -1, order)
    cum = torch.cumsum(w, -1)
    total = cum[..., -1:]
    q = torch.where(total > 0, (cum - 0.5 * w) / torch.clamp(total, min=1e-9),
                    torch.zeros_like(w))
    cl = _clusters(q, c)
    m0 = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    wsum = torch.zeros((rows, c), device=a.device).scatter_add_(1, cl, w)
    msum = torch.zeros_like(wsum).scatter_add_(1, cl, w * m0)
    mean = torch.where(wsum > 0, msum / torch.clamp(wsum, min=1e-9), torch.zeros_like(wsum))
    return torch.stack([_round(mean, lower), wsum], -1)


def quantiles(d: torch.Tensor, qs: Tuple[float, ...]) -> torch.Tensor:
    """[rows, len(qs)] values of digests ``d`` [rows, c, 2] (0 for an
    empty key): linear between the centroid means at their cumulative
    midpoints, the end means outside them, the left mean across a step of
    no width."""
    means, ws = d[..., 0], d[..., 1]
    cum = (torch.cumsum(ws, -1) - 0.5 * ws).contiguous()
    total = ws.sum(-1, keepdim=True)
    x = torch.cummax(torch.where(ws > 0, means, torch.full_like(means, -_INF)), -1).values
    x = torch.where(torch.isfinite(x), x, torch.zeros_like(x))
    t = (torch.tensor(qs, dtype=torch.float32, device=d.device)[None, :] * total).contiguous()
    c = cum.shape[-1]
    i = torch.clamp(torch.searchsorted(cum, t, right=True), 1, c - 1)
    x0, x1 = torch.gather(cum, 1, i - 1), torch.gather(cum, 1, i)
    f0, f1 = torch.gather(x, 1, i - 1), torch.gather(x, 1, i)
    dx = x1 - x0
    flat = dx.abs() <= float(torch.finfo(torch.float32).tiny)
    f = torch.where(flat, f0, f0 + (t - x0) / torch.where(flat, torch.ones_like(dx), dx) * (f1 - f0))
    f = torch.where(t < cum[:, :1], x[:, :1].expand_as(f), f)
    f = torch.where(t > cum[:, -1:], x[:, -1:].expand_as(f), f)
    return torch.where(total > 0, f, torch.zeros_like(f))


class Lanes:
    """The pool's lanes on ``device``: each batch's digest key (-1 where a
    lane carries no duration) and what its durations are made from, so
    batch ``g``'s durations are made on the device."""

    def __init__(self, pool, lane_key, device):
        self.pool = pool
        self.key = [torch.as_tensor(k, device=device) for k in lane_key]
        self.parts = [tuple(torch.as_tensor(a.astype("int64"), device=device)
                            for a in (b.dur_lo, b.dur_rel, b.dur_mask)) for b in pool.batches]

    def batch(self, g: int):
        j = g % self.pool.size
        lo, rel, mask = self.parts[j]
        off = int(self.pool.stamp(g)[3])
        return self.key[j], (lo | ((rel + off) & mask)).to(torch.float32)


def replay(lanes: Lanes, rows: int, c: int, groups: List[Tuple[int, int]],
           lower: bool = False) -> torch.Tensor:
    """The digests [rows, c, 2] after the folds ``groups``."""
    dev = lanes.key[0].device
    d = torch.zeros((rows, c, 2), device=dev)
    for a, b in groups:
        if b > a:
            parts = [lanes.batch(g) for g in range(a, b)]
            keys = torch.cat([k for k, _ in parts])
            values = torch.cat([v for _, v in parts])
        else:
            keys = torch.zeros(0, dtype=torch.int64, device=dev)
            values = torch.zeros(0, device=dev)
        d = merge(d, compact(keys, values, rows, c, lower), lower)
    return d


def rank_ranges(lanes: Lanes, n: int, values: torch.Tensor):
    """([sets, rows] below, [sets, rows] up to): for each row of
    ``values`` [sets, rows] (one value a key), how many of the key's
    durations in the first ``n`` batches lie below the value, and how
    many at or below it."""
    sets, rows = values.shape
    dev = values.device
    v = torch.cat([values, torch.full((sets, 1), -_INF, device=dev)], 1)
    below = torch.zeros(sets * (rows + 1), dtype=torch.int64, device=dev)
    upto = torch.zeros_like(below)
    base = (torch.arange(sets, device=dev) * (rows + 1))[:, None]
    for g in range(n):
        key, d = lanes.batch(g)
        k = torch.where(key >= 0, key, rows)
        at = v[:, k]
        idx = (base + k[None, :]).reshape(-1)
        below.index_add_(0, idx, (d[None, :] < at).reshape(-1).to(torch.int64))
        upto.index_add_(0, idx, (d[None, :] <= at).reshape(-1).to(torch.int64))
    return (below.reshape(sets, rows + 1)[:, :rows], upto.reshape(sets, rows + 1)[:, :rows])

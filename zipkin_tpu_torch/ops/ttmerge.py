"""Host-side merges for the time-disaggregated sketch tier (port of
``zipkin_tpu/ops/ttmerge.py``, numpy only).

A windowed query covers a run of sealed time-bucket segments (compact
host arrays, tpu/timetier.py) plus at most one device pull for the
unsealed current bucket. The merges here are the host mirrors of the
device combiners — t-digest cluster recluster (ops/tdigest.row_merge),
HLL register-max + the bias-corrected estimate (ops/hll.estimate), and
edge-count sums — over numpy arrays, so serving a sealed window costs
NO device dispatch at all (the paper's read-the-compact-segments move).

Determinism contract: every function here is a pure, order-defined
numpy computation in float32 — merging the same segment list always
produces the same bits. That is what lets a windowed bit-identity
oracle compare a live store's merged answers
against a from-scratch rebuild segment by segment: per-bucket segments
are bit-identical on device (per-slot segmented compaction), and the
host fold over equal inputs is bit-equal by construction. The host
recluster does NOT need to reproduce the device ``row_merge`` bitwise —
only to be deterministic and standard-merging-digest correct.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np


def _cluster_ids(q: np.ndarray, c: int) -> np.ndarray:
    """k1 scale function (host mirror of ops/tdigest._cluster_ids)."""
    x = np.clip(2.0 * q - 1.0, -1.0, 1.0).astype(np.float32)
    k = np.arcsin(x) / np.float32(np.pi) + np.float32(0.5)
    return np.clip((k * c).astype(np.int32), 0, c - 1)


def merge_digests(parts: Sequence[np.ndarray]) -> np.ndarray:
    """Fold per-bucket digests ``[K, C, 2]`` into one ``[K, C, 2]``.

    The merge_many formulation: concatenate every part's clusters along
    the centroid axis, then ONE row-parallel recluster — stable
    mean-sort, k1-scale cluster assignment, weighted mean per cluster.
    Accumulation runs through np.add.at in sorted-lane order, so the
    result is a pure function of the input list (segment epoch order —
    the tier always folds ascending)."""
    parts = [np.asarray(p, np.float32) for p in parts]
    if not parts:
        raise ValueError("merge_digests needs at least one part")
    k, c, _ = parts[0].shape
    m = np.concatenate([p[..., 0] for p in parts], axis=-1)
    w = np.concatenate([p[..., 1] for p in parts], axis=-1)
    m = np.where(w > 0, m, np.float32(np.inf))

    order = np.argsort(m, axis=-1, kind="stable")
    m = np.take_along_axis(m, order, axis=-1)
    w = np.take_along_axis(w, order, axis=-1)

    cum = np.cumsum(w, axis=-1, dtype=np.float32)
    total = cum[..., -1:]
    q = np.where(
        total > 0, (cum - np.float32(0.5) * w) / np.maximum(total, 1e-9), 0.0
    ).astype(np.float32)
    cluster = _cluster_ids(q, c)

    row = np.broadcast_to(np.arange(k, dtype=np.int64)[:, None], cluster.shape)
    dest = row * c + cluster
    wsum = np.zeros(k * c, np.float32)
    msum = np.zeros(k * c, np.float32)
    m0 = np.where(np.isfinite(m), m, 0.0).astype(np.float32)
    np.add.at(wsum, dest.ravel(), w.ravel())
    np.add.at(msum, dest.ravel(), (w * m0).ravel())
    new_mean = np.where(wsum > 0, msum / np.maximum(wsum, 1e-9), 0.0)
    return np.stack(
        [new_mean.astype(np.float32), wsum], axis=-1
    ).reshape(k, c, 2)


def digest_quantile(digest: np.ndarray, qs) -> np.ndarray:
    """[K, Q] quantiles from a merged digest — the host mirror of
    ops/tdigest.quantile (centroid means at cumulative-weight midpoints,
    linear in between; 0 for empty rows)."""
    digest = np.asarray(digest, np.float32)
    qs = np.asarray(qs, np.float32)
    means = digest[..., 0]
    ws = digest[..., 1]
    cum = np.cumsum(ws, axis=-1, dtype=np.float32) - np.float32(0.5) * ws
    total = ws.sum(axis=-1, keepdims=True, dtype=np.float32)
    x = np.where(ws > 0, means, -np.inf)
    x = np.maximum.accumulate(x, axis=-1)
    x = np.where(np.isfinite(x), x, 0.0).astype(np.float32)
    out = np.empty((digest.shape[0], qs.shape[0]), np.float32)
    targets = qs[None, :] * total
    for i in range(digest.shape[0]):
        out[i] = np.interp(targets[i], cum[i], x[i])
    return np.where(total > 0, out, 0.0).astype(np.float32)


def merge_hll(parts: Sequence[np.ndarray]) -> np.ndarray:
    """Register-wise max over per-bucket register arrays — the lossless
    HLL union (same combiner as the cross-shard pmax)."""
    if not parts:
        raise ValueError("merge_hll needs at least one part")
    out = np.asarray(parts[0], np.uint8)
    for p in parts[1:]:
        out = np.maximum(out, np.asarray(p, np.uint8))
    return out


def _alpha(m: int) -> float:
    if m == 16:
        return 0.673
    if m == 32:
        return 0.697
    if m == 64:
        return 0.709
    return 0.7213 / (1.0 + 1.079 / m)


def hll_estimate(registers: np.ndarray) -> np.ndarray:
    """[rows] f32 cardinality estimates — exact host port of
    ops/hll.estimate (bias-corrected harmonic mean, linear counting
    below 2.5m, no classical large-range correction — see the device
    docstring for why), so windowed and cumulative cardinalities read
    off the same estimator."""
    registers = np.asarray(registers, np.uint8)
    m = registers.shape[-1]
    alpha = np.float32(_alpha(m))
    regs = registers.astype(np.float32)
    harm = np.sum(np.exp2(-regs), axis=-1, dtype=np.float32)
    raw = alpha * np.float32(m) * np.float32(m) / harm
    zeros = np.sum(registers == 0, axis=-1).astype(np.float32)
    linear = (
        np.float32(m) * np.log(np.float32(m) / np.maximum(zeros, 1.0))
    ).astype(np.float32)
    use_linear = (raw <= 2.5 * m) & (zeros > 0)
    return np.where(use_linear, linear, raw).astype(np.float32)


def merge_edges(parts: Sequence[np.ndarray]) -> np.ndarray:
    """Sum per-bucket edge-count matrices ``[S, S]`` (uint64 accumulate
    — merging many buckets must not wrap the u32 segment dtype)."""
    if not parts:
        raise ValueError("merge_edges needs at least one part")
    out = np.zeros(np.asarray(parts[0]).shape, np.uint64)
    for p in parts:
        out += np.asarray(p, np.uint64)
    return out


def digest_total(digest: np.ndarray) -> np.ndarray:
    """[K] total folded weight per key row (the windowed count column
    quantile responses report alongside the percentiles)."""
    return np.asarray(digest, np.float32)[..., 1].sum(
        axis=-1, dtype=np.float32
    )


def cluster_q_width(c: int, q: float) -> float:
    """Rank resolution of a ``c``-centroid merged digest at quantile
    ``q`` (host copy of ops/tdigest.cluster_q_width — the windowed
    accuracy observatory converts it to a value bound)."""
    return min(
        0.5, math.pi * math.sqrt(max(q * (1.0 - q), 0.0)) / c + 0.5 / c
    )

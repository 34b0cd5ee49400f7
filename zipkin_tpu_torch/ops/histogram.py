"""HDR-style log2 latency histograms (port of ``zipkin_tpu/ops/histogram.py``).

Per-key ``u32`` count rows ``[keys, BUCKETS]`` (int64 here, reduced mod
2**32 — see :mod:`zipkin_tpu_torch.u32`), 32 sub-buckets per octave,
quantiles by linear interpolation inside the bucket.
"""

from __future__ import annotations

import torch

from zipkin_tpu_torch import u32
from zipkin_tpu_torch.device import resolve_device
from zipkin_tpu_torch.ops.hashing import floor_log2

SUB_BITS = 5
SUB = 1 << SUB_BITS
BUCKETS = (32 - SUB_BITS + 1) * SUB  # 896


def new_histograms(keys: int, device=None) -> torch.Tensor:
    """Zeroed rows on the card unless ``device`` names another."""
    return torch.zeros((keys, BUCKETS), dtype=u32.DTYPE, device=resolve_device(device))


def bucket_of(duration_us: torch.Tensor) -> torch.Tensor:
    """Map u32 microsecond durations to bucket indices [0, BUCKETS)."""
    v = u32.wrap(duration_us.to(u32.DTYPE))
    e = floor_log2(torch.clamp(v, min=1))
    small = v < (1 << (SUB_BITS + 1))
    shift = torch.clamp(e - SUB_BITS, min=0)
    mant = (v >> shift) - SUB
    idx = (e - SUB_BITS + 1) * SUB + mant
    return torch.where(small, v, idx)


def bucket_bounds(idx: torch.Tensor):
    """(low, width) of each bucket in microseconds, float32.

    The reference computes ``(SUB + off) << shift`` in int32, which wraps
    negative in the top octave (buckets >= 864, durations >= 2**31 µs);
    :func:`u32.as_int32` reproduces that wrap so the two agree."""
    idx = idx.to(torch.int64)
    small = idx < 2 * SUB
    block = idx // SUB
    off = idx % SUB
    e = block + SUB_BITS - 1
    shift = torch.clamp(e - SUB_BITS, min=0)
    lo = u32.as_int32((SUB + off) << shift).to(torch.float32)
    width = (torch.ones_like(shift) << shift).to(torch.float32)
    return (
        torch.where(small, idx.to(torch.float32), lo),
        torch.where(small, torch.ones_like(width), width),
    )


def update(histograms, key_ids, durations_us, valid) -> torch.Tensor:  # zt-in-place: histograms — counts are added in place
    """Count valid durations into ``histograms[key, bucket]`` IN PLACE
    (u32 counts: the touched cells are reduced mod 2**32)."""
    b = bucket_of(durations_us)
    k = torch.clamp(key_ids.to(torch.int64), 0, histograms.shape[0] - 1)
    flat = k * BUCKETS + b
    u32.index_add_(histograms.view(-1), flat, valid.to(histograms.dtype))
    return histograms


def quantile(counts: torch.Tensor, qs: torch.Tensor) -> torch.Tensor:
    """Quantiles per row, ``[..., Q]`` float32 (0 for empty rows)."""
    c = u32.wrap(counts).to(torch.float32)
    total = torch.sum(c, dim=-1, keepdim=True)
    cum = torch.cumsum(c, dim=-1)
    qs = qs.to(torch.float32).to(counts.device)
    targets = qs[None, :] * total.reshape(-1, 1)  # [R, Q]
    cum2 = cum.reshape(-1, BUCKETS).contiguous()
    # first bucket whose cumulative count reaches the target (cum is
    # non-decreasing, so the count of cum < target is a left search)
    idx = torch.searchsorted(cum2, targets.contiguous(), right=False)
    idx = torch.clamp(idx, 0, BUCKETS - 1)
    lo, width = bucket_bounds(idx)
    padded = torch.cat([torch.zeros_like(cum2[:, :1]), cum2], dim=1)
    cum_before = torch.gather(padded, 1, idx)
    in_bucket = torch.gather(cum2, 1, idx) - cum_before
    frac = torch.where(
        in_bucket > 0,
        (targets - cum_before) / torch.clamp(in_bucket, min=1e-9),
        torch.full_like(in_bucket, 0.5),
    )
    frac = torch.clamp(frac, 0.0, 1.0)
    out = lo + frac * width
    out = torch.where(total.reshape(-1, 1) > 0, out, torch.zeros_like(out))
    return out.reshape(tuple(counts.shape[:-1]) + (qs.shape[0],))


def merge(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact union of two count planes: the u32 (wrapping) add, the
    cross-shard sum's combiner."""
    return u32.add(a, b)


def total_count(counts: torch.Tensor) -> torch.Tensor:
    """Per-row total, u32 (wrapped)."""
    return u32.wrap(torch.sum(u32.wrap(counts), dim=-1))

"""Sorted-segment reductions (port of ``zipkin_tpu/ops/segments.py``).

Runs of equal ids in a sorted id vector; cumulative sums within runs.
The reference's associative max/min scans become ``cummax``/``cummin``.
"""

from __future__ import annotations

import torch


def segment_starts(sorted_ids: torch.Tensor) -> torch.Tensor:
    """Boolean mask marking the first element of each run in sorted ids."""
    first = torch.ones((1,) + tuple(sorted_ids.shape[1:]), dtype=torch.bool,
                       device=sorted_ids.device)
    return torch.cat([first, sorted_ids[1:] != sorted_ids[:-1]], dim=0)


def run_start_indices(sorted_ids: torch.Tensor) -> torch.Tensor:
    """For each element, the index where its run of equal ids begins."""
    idx = torch.arange(sorted_ids.shape[0], device=sorted_ids.device)
    start_idx = torch.where(segment_starts(sorted_ids), idx, 0)
    return torch.cummax(start_idx, dim=0).values


def sorted_segment_cumsum(values: torch.Tensor, sorted_ids: torch.Tensor) -> torch.Tensor:
    """Inclusive cumulative sum within each run of equal sorted ids:
    the global inclusive cumsum minus the global exclusive cumsum at the
    element's run start."""
    cum = torch.cumsum(values, dim=0)
    excl = cum - values
    return cum - excl[run_start_indices(sorted_ids)]


def sorted_segment_total(values: torch.Tensor, sorted_ids: torch.Tensor) -> torch.Tensor:
    """For each element, the total of its run (broadcast segment sum)."""
    cum = sorted_segment_cumsum(values, sorted_ids)
    n = values.shape[0]
    starts = segment_starts(sorted_ids)
    idx = torch.arange(n, device=values.device)
    next_start = torch.where(starts, idx, n)
    # reverse inclusive min scan: the start of MY run seen from the right
    next_start = torch.flip(torch.cummin(torch.flip(next_start, [0]), dim=0).values, [0])
    nxt = torch.cat([next_start[1:], torch.full((1,), n, dtype=next_start.dtype,
                                                device=values.device)])
    return cum[nxt - 1]


def segment_sum_scatter(values: torch.Tensor, ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Plain scatter-add segment sum (ids need not be sorted). As the
    reference's ``.at[ids].add``: a negative id counts from the end and an
    id out of range is dropped (its lane adds zero to segment 0)."""
    ids = ids.to(torch.int64)
    ids = torch.where(ids < 0, ids + num_segments, ids)
    keep = (ids >= 0) & (ids < num_segments)
    mask = keep.reshape(keep.shape + (1,) * (values.dim() - 1))
    out = torch.zeros((num_segments,) + tuple(values.shape[1:]), dtype=values.dtype,
                      device=values.device)
    return out.index_add_(0, torch.where(keep, ids, 0),
                          torch.where(mask, values, torch.zeros_like(values)))

"""Lens read ``windowed``: ``latency_quantiles([0.5, 0.99], endTs,
window_minutes)``, every key's quantiles over the dashboard's last minutes
from the time-sliced histograms; each key's count is held exactly."""

from __future__ import annotations

from portbench import compare

CHECK = "read_gap"
NEEDS_REGS = False


def issue(store, end_ts: int, reads: dict):
    return store.latency_quantiles(list(compare.QS), end_ts=end_ts,
                                   lookback=int(reads["window_minutes"]) * 60_000)


def answer(ans, names: compare.Names) -> dict:
    return compare.counts_by_id(ans, names)


def want(ref, n: int, end_ts: int, reads: dict, regs) -> dict:
    lo = (end_ts - int(reads["window_minutes"]) * 60_000) // 60_000
    return compare.counts_dict(ref.window_counts(n, lo, end_ts // 60_000))


def gap(port: dict, expected: dict) -> float:
    return compare.dict_gap(port, expected)

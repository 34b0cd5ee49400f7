"""Lens read ``quantiles``: ``latency_quantiles([0.5, 0.99])``, every
key's digest quantiles over all time; each key's count is held exactly
(the values are held at the window's close, ``digest_rank_gap``)."""

from __future__ import annotations

from portbench import compare

CHECK = "read_gap"
NEEDS_REGS = False


def issue(store, end_ts: int, reads: dict):
    return store.latency_quantiles(list(compare.QS))


def answer(ans, names: compare.Names) -> dict:
    return compare.counts_by_id(ans, names)


def want(ref, n: int, end_ts: int, reads: dict, regs) -> dict:
    return compare.counts_dict(ref.key_total(n))


def gap(port: dict, expected: dict) -> float:
    return compare.dict_gap(port, expected)

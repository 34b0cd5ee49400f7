"""Lens read ``deps``: ``get_dependencies(endTs, deps_lookback_ms)``, the
dependency links of the day up to the newest minute folded; each edge's
call and error counts are held exactly."""

from __future__ import annotations

from portbench import compare

CHECK = "read_gap"
NEEDS_REGS = False


def issue(store, end_ts: int, reads: dict):
    return store.get_dependencies(end_ts, int(reads["deps_lookback_ms"])).execute()


def answer(ans, names: compare.Names) -> dict:
    return compare.links_by_id(ans, names)


def want(ref, n: int, end_ts: int, reads: dict, regs) -> dict:
    calls, errs = ref.links(n, (end_ts - int(reads["deps_lookback_ms"])) // 60_000,
                            end_ts // 60_000)
    return compare.links_dict(calls, errs)


def gap(port: dict, expected: dict) -> float:
    return compare.dict_gap(port, expected)

"""Lens read ``cardinalities``: ``trace_cardinalities()``, each service's
and the global distinct-trace estimate, held relative to the estimator
over the reference's registers."""

from __future__ import annotations

from portbench import compare

CHECK = "read_card_relgap"
NEEDS_REGS = True


def issue(store, end_ts: int, reads: dict):
    return store.trace_cardinalities()


def answer(ans, names: compare.Names) -> dict:
    return compare.cards_by_id(ans, names)


def want(ref, n: int, end_ts: int, reads: dict, regs) -> dict:
    return compare.cards_dict(ref, regs)


def gap(port: dict, expected: dict) -> float:
    return compare.card_relgap(port, expected)

"""The comparison that decides ``correct``: the port's answers, brought to
the generator's ids by name, against the reference's at the same batch
count, as named numbers each held to its limit (the configuration's
``limits``).

- ``counts_gap``: the largest gap of a span, duration, error or batch
  counter (the card's and the host's), of a key's count in the digest
  quantile rows and in the dashboard window's rows. Exact: limit 0.
- ``hist_gap``: the largest gap of a cell of the all-time histograms and
  of the dashboard window's histograms. Exact.
- ``digest_gap``: the largest gap of a key's total weight in the merged
  digests (pending points folded in) against its count. Exact.
- ``digest_rank_gap``: the largest distance in rank, as a share of the
  key's durations, between the port's digest quantile and the reference
  digest's (the same rules, the same folds) for each key with
  ``min_points`` durations or more.
- ``hll_gap``: HLL registers that differ. Exact.
- ``card_relgap``: the largest relative gap of a cardinality estimate
  against the estimator over the reference's registers.
- ``links_gap``: the largest gap of an edge's call or error count in the
  day's dependency links. Exact.
- ``tt_gap``: the time tier's live buckets: differing registers, and the
  largest gap of a key's digest weight or an edge's count. Exact.
- the Lens reads in the window (``portbench/reads/``): each sampled read
  against the reference at every batch count it may have seen (those
  folded when it was issued up to those begun when it returned), the
  closest taken, under the check its kind names; the largest over the
  sample.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

import numpy as np

from portbench.generator import service_name, span_name
from portbench.reference.model import Reference
from portbench.reference.sketch import hll_estimate

QS = (0.5, 0.99)
COUNTER_SLOTS = {"spans": 0, "spansWithDuration": 2, "spansWithError": 3, "batches": 4}


class Names:
    """The generator's ids by the names the store answers with."""

    def __init__(self, services: int, names: int):
        self.svc = {service_name(s): s for s in range(1, services + 1)}
        self.key = {(service_name(s), span_name(n)): s * names + n
                    for s in range(1, services + 1) for n in range(names)}


# -- answers in the generator's ids -------------------------------------------

def rows_by_id(rows, nm: Names) -> Dict[int, tuple]:
    """Quantile rows as {key: (count, (value of each q))}."""
    return {nm.key.get((r["serviceName"], r["spanName"]), -1):
            (r["count"], tuple(r["quantiles"][q] for q in QS)) for r in rows}


def counts_by_id(rows, nm: Names) -> Dict[int, int]:
    return {k: int(c) for k, (c, _) in rows_by_id(rows, nm).items()}


def counts_dict(counts: np.ndarray) -> Dict[int, int]:
    return {int(k): int(counts[k]) for k in np.nonzero(counts)[0]}


def links_by_id(deps, nm: Names) -> Dict[tuple, tuple]:
    return {(nm.svc.get(d.parent, -1), nm.svc.get(d.child, -1)):
            (int(d.call_count), int(d.error_count)) for d in deps}


def links_dict(calls: np.ndarray, errs: np.ndarray) -> Dict[tuple, tuple]:
    return {(int(a), int(b)): (int(calls[a, b]), int(errs[a, b]))
            for a, b in zip(*np.nonzero(calls))}


def cards_by_id(cards: dict, nm: Names) -> Dict[object, float]:
    return {("_global" if k == "_global" else nm.svc.get(k, -1)): float(v)
            for k, v in cards.items()}


def cards_dict(ref: Reference, regs: np.ndarray) -> Dict[object, float]:
    est = hll_estimate(regs)
    return {**{s: float(est[s]) for s in range(1, ref.S + 1)}, "_global": float(est[ref.G])}


class Maps:
    """The store's ids of the generator's services and keys (the vocabulary
    the harness interned them into)."""

    def __init__(self, svc_map: np.ndarray, key_map: np.ndarray, max_services: int):
        self.svc = svc_map
        self.key = key_map
        self.global_row = max_services

    def rows(self, plane: np.ndarray, gen_rows: np.ndarray, global_row: bool):
        """(the plane's rows in the generator's order, total of the store's
        rows that no generator id maps to)."""
        idx = list(gen_rows) + ([self.global_row] if global_row else [])
        mapped = np.asarray(plane)[idx]
        rest = np.ones(plane.shape[0], bool)
        rest[[i for i in idx if i > 0]] = False
        return mapped, int(np.abs(np.asarray(plane)[rest].astype(np.int64)).sum())


# -- the final answers ------------------------------------------------------

def port_final(raw: dict, maps: Maps, ref: Reference, nm: Names) -> dict:
    """The port's final answers in the generator's ids."""
    gen_keys = maps.key.copy()
    gen_keys[:ref.names] = 0
    svc_rows = maps.svc.copy()
    hist, hist_extra = maps.rows(raw["hist"], gen_keys, False)
    whist, whist_extra = maps.rows(raw["window_hist"], gen_keys, False)
    weights, weight_extra = maps.rows(np.rint(raw["digest_weight"]).astype(np.int64), gen_keys,
                                      False)
    hll, hll_extra = maps.rows(raw["hll"], svc_rows, True)
    hll[0] = 0
    c = raw["counters"]
    rows = rows_by_id(raw["rows"], nm)
    values = np.full((len(QS), ref.K), np.nan)
    for k, (_, v) in rows.items():
        if 0 <= k < ref.K:
            values[:, k] = v
    out = {
        "counters": {k: int(c[i]) for k, i in COUNTER_SLOTS.items()},
        "host_counters": {k: int(raw["host_counters"][k]) for k in COUNTER_SLOTS},
        "rows": {k: count for k, (count, _) in rows.items()},
        "window_rows": counts_by_id(raw["window_rows"], nm),
        "digest_values": values,
        "hist": hist, "hist_extra": hist_extra + whist_extra, "window_hist": whist,
        "digest_weight": weights, "digest_extra": weight_extra,
        "hll": hll, "hll_extra": hll_extra,
        "cards": cards_by_id(raw["cards"], nm),
        "links": links_by_id(raw["deps"], nm),
    }
    if "tt" in raw:
        regs, weights, calls, errs = raw["tt"]
        tregs, tregs_extra = maps.rows(regs, svc_rows, True)
        tregs[0] = 0
        s = maps.svc
        out["tt"] = (tregs, tregs_extra, np.rint(np.asarray(weights)[gen_keys]).astype(np.int64),
                     np.asarray(calls)[np.ix_(s, s)], np.asarray(errs)[np.ix_(s, s)])
    return out


def expected_final(ref: Reference, n: int, regs: np.ndarray, windows: dict,
                   tt_range: Optional[tuple]) -> dict:
    """The reference's final answers at ``n`` batches, in the same form."""
    lo, hi = windows["window"]
    dlo, dhi = windows["deps_window"]
    calls, errs = ref.links(n, dlo, dhi)
    out = {
        "counters": ref.counters(n),
        "key_total": ref.key_total(n), "window_counts": ref.window_counts(n, lo, hi),
        "hist": ref.hist(np.arange(n)), "window_hist": ref.hist(ref.window_batches(n, lo, hi)),
        "hll": regs, "cards": cards_dict(ref, regs),
        "calls": calls, "errs": errs,
    }
    if tt_range is not None:
        out["tt"] = ref.tt(n, *tt_range)
    return out


def control_final(ref: Reference, n: int, regs: np.ndarray, windows: dict,
                  tt_range: Optional[tuple], digest_values: np.ndarray) -> dict:
    """The control: the reference's answers at ``n`` batches in the port's
    form, its digest quantiles ``digest_values`` from digests kept in the
    precision below the stated one. Given one batch short of what the
    window folded, it is a store that also breaks read-after-write."""
    want = expected_final(ref, n, regs, windows, tt_range)
    out = {
        "counters": want["counters"], "host_counters": want["counters"],
        "rows": counts_dict(want["key_total"]), "window_rows": counts_dict(want["window_counts"]),
        "digest_values": digest_values,
        "hist": want["hist"], "hist_extra": 0, "window_hist": want["window_hist"],
        "digest_weight": want["key_total"], "digest_extra": 0,
        "hll": regs, "hll_extra": 0, "cards": want["cards"],
        "links": links_dict(want["calls"], want["errs"]),
    }
    if "tt" in want:
        tregs, weights, calls, errs = want["tt"]
        out["tt"] = (tregs, 0, weights, calls, errs)
    return out


# -- gaps -------------------------------------------------------------------

def dict_gap(port: dict, want: dict) -> int:
    """The largest gap of a count (or of each count of a tuple) over the
    keys of either side, a missing key counting 0; a key the generator
    does not know (-1) counts whole."""
    gap = 0
    for k in set(port) | set(want):
        a, b = port.get(k), want.get(k)
        a = () if a is None else a if isinstance(a, tuple) else (a,)
        b = () if b is None else b if isinstance(b, tuple) else (b,)
        width = max(len(a), len(b))
        a, b = a or (0,) * width, b or (0,) * width
        gap = max(gap, max(abs(int(x) - int(y)) for x, y in zip(a, b)))
    return gap


def card_relgap(port: Dict[object, float], want: Dict[object, float]) -> float:
    gap = 0.0
    for k, v in want.items():
        got = port.get(k)
        gap = max(gap, 1.0 if got is None else abs(got - v) / max(v, 1.0))
    return max(gap, 1.0 if set(port) - set(want) else 0.0)


def final_gaps(port: dict, want: dict) -> dict:
    c_gap = max(max(abs(port[src][k] - want["counters"][k]) for k in COUNTER_SLOTS)
                for src in ("counters", "host_counters"))
    gaps = {
        "counts_gap": max(c_gap, dict_gap(port["rows"], counts_dict(want["key_total"])),
                          dict_gap(port["window_rows"], counts_dict(want["window_counts"]))),
        "hist_gap": max(int(np.abs(port["hist"].astype(np.int64) - want["hist"]).max()),
                        int(np.abs(port["window_hist"].astype(np.int64)
                                   - want["window_hist"]).max()),
                        port["hist_extra"]),
        "digest_gap": max(int(np.abs(port["digest_weight"] - want["key_total"]).max()),
                          port["digest_extra"]),
        "hll_gap": int((port["hll"] != want["hll"]).sum()) + port["hll_extra"],
        "card_relgap": card_relgap(port["cards"], want["cards"]),
        "links_gap": dict_gap(port["links"], links_dict(want["calls"], want["errs"])),
    }
    if "tt" in want:
        regs, extra, weights, calls, errs = port["tt"]
        wregs, wweights, wcalls, werrs = want["tt"]
        gaps["tt_gap"] = max(int((regs != wregs).sum()) + extra,
                             int(np.abs(weights - wweights).max()),
                             int(np.abs(calls.astype(np.int64) - wcalls).max()),
                             int(np.abs(errs.astype(np.int64) - werrs).max()))
    return gaps


def digest_gaps(values: np.ndarray, below: np.ndarray, upto: np.ndarray, total: np.ndarray,
                min_points: int):
    """(``digest_rank_gap``, readings). ``values`` [2 * len(QS), K]: the
    port's quantiles then the reference digest's; ``below``/``upto`` the
    count of each key's durations under and up to each value. A key counts
    with ``min_points`` durations or more and a value on both sides. The
    readings are each side's distance in rank from q (the digest's own
    error, the same rules on both sides)."""
    nq = len(QS)
    keys = (total >= min_points) & np.isfinite(values).all(axis=0)
    if not keys.any():
        return 0.0, {}
    t = total[keys].astype(np.float64)
    lo, hi = below[:, keys] / t, upto[:, keys] / t
    gap = np.maximum(0.0, np.maximum(lo[nq:] - hi[:nq], lo[:nq] - hi[nq:])).max()
    qs = np.asarray(QS)[:, None]
    err = np.maximum(0.0, np.maximum(lo - np.vstack([qs, qs]), np.vstack([qs, qs]) - hi))
    err = err.max(axis=1)
    readings = {f"{side}_rank_p{int(q * 100)}": float(err[i + off])
                for side, off in (("port", 0), ("reference", nq)) for i, q in enumerate(QS)}
    return float(gap), readings


def read_gaps(reads: Iterable[tuple], kinds: dict, ref: Reference, mix: dict,
              snaps: dict) -> dict:
    """For each check the read kinds name: each sampled read's smallest gap
    over the batch counts it may have seen, the largest over the reads.
    ``reads``: (kind, n0, n1, end_ts, answer in the generator's ids)."""
    r = mix["reads"]
    worst = {mod.CHECK: 0 for mod in kinds.values()}
    for kind, n0, n1, end_ts, port in reads:
        mod = kinds[kind]
        gaps = [mod.gap(port, mod.want(ref, n, end_ts, r, snaps.get(n)))
                for n in range(n0, n1 + 1)]
        worst[mod.CHECK] = max(worst[mod.CHECK], min(gaps))
    return worst

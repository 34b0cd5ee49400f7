"""Seeded span traffic for the benchmark (numpy only).

A frozen copy of the rules of ``zipkin_tpu_torch/workload.py``: traces are
chains of ``hops`` RPC hops; each hop is a CLIENT span in the caller's
service and a SERVER span sharing its span id in the callee's service, so
every hop yields exactly one dependency edge caller -> callee, with an
error when the hop fails. Services are drawn Zipf-like (``svc_zipf``), span
names per service likewise (``name_zipf``), durations are lognormal and
the client half is ``client_factor`` slower.

:class:`Pool` makes ``pool_batches`` batches of ``batch_spans`` spans from
the seed at set-up. Global batch ``g`` is pool batch ``g % P`` on its pass
``g // P``: every pass re-stamps the trace and span ids (XOR with the
pass's constants, parents only where present), so each batch brings new
traces, and its minute is ``base_minute + g // batches_per_minute``, so
the time buckets rotate as the stream goes on. Each pass also moves every
duration within its latency-histogram bucket by the pass's offset, so
durations do not repeat pass after pass while every histogram cell does.
A trace's 32-bit hash follows the mix's ``trace_h`` rule: ``"drawn"`` (the
default) draws it per trace and XORs it with the pass's constant, for a
feed that hands the columns over as they are; ``"id"`` hashes the pass's
trace id (:func:`~portbench.reference.sketch.trace_id_hash`), as a store
that parses the id off the wire does. The same seed gives the
same stream. Ids here are the generator's own: services ``1..services``
and sketch keys ``svc * names_per_service + name``; the harness maps them
to the store's vocabulary, the reference keeps them.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from portbench.reference.sketch import hist_bucket_bounds, trace_id_hash

BASE_MINUTE = 29_000_000  # an epoch minute in 2025
SEED_MASK = (1 << 64) - 1
TRACE_H_RULES = ("drawn", "id")


def service_name(svc: int) -> str:
    return f"svc{svc:04d}"


def span_name(name: int) -> str:
    return f"op{name:02d}"


def zipf_weights(n: int, s: float) -> np.ndarray:
    w = 1.0 / np.arange(1, n + 1) ** s
    return w / w.sum()


class PoolBatch:
    """One pool batch: the lane columns and what the reference needs of
    its traces (the service chain and the failed hops)."""

    def __init__(self, cols: Dict[str, np.ndarray], chain: np.ndarray, hop_err: np.ndarray):
        self.cols = cols
        self.chain = chain  # [t, hops + 1] generator service ids
        self.hop_err = hop_err  # [t, hops] bool
        # each duration's histogram bucket, where a pass moves it: the
        # bucket's low end and the duration's offset in it (bucket widths
        # are powers of two, so a move is a mask)
        lo, width = hist_bucket_bounds(cols["dur"])
        self.dur_lo = lo.astype(np.uint32)
        self.dur_rel = (cols["dur"] - lo).astype(np.uint32)
        self.dur_mask = (width - 1).astype(np.uint32)
        # parents present (a root's parent id stays 0 when a pass re-stamps)
        self.parent_mask = np.where((cols["p0"] | cols["p1"]) != 0, 0xFFFFFFFF, 0).astype(np.uint32)


def make_batch(rng: np.random.Generator, mix: dict) -> PoolBatch:
    """``batch_spans`` spans of ``hops``-hop traces (workload.generate's
    rules, one batch)."""
    hops = int(mix["hops"])
    services = int(mix["services"])
    names = int(mix["names_per_service"])
    per_trace = 2 * hops
    n = int(mix["batch_spans"])
    if n % per_trace:
        raise ValueError(f"batch_spans must be a multiple of {per_trace}")
    t = n // per_trace
    svc_p = zipf_weights(services, float(mix["svc_zipf"]))
    name_p = zipf_weights(names, float(mix["name_zipf"]))

    chain = rng.choice(services, size=(t, hops + 1), p=svc_p) + 1
    for h in range(1, hops + 1):  # no self-calls
        same = chain[:, h] == chain[:, h - 1]
        chain[same, h] = chain[same, h] % services + 1
    trace_h = rng.integers(0, 1 << 32, t, dtype=np.uint32)
    tl = rng.integers(0, 1 << 32, (t, 2), dtype=np.uint32)
    span_id = rng.integers(1, 1 << 32, (t, hops, 2), dtype=np.uint32)
    hop_err = rng.random((t, hops)) < float(mix["error_rate"])

    u32 = np.zeros(n, np.uint32)
    cols = {c: u32.copy() for c in ("trace_h", "tl0", "tl1", "s0", "s1", "p0", "p1", "dur")}
    cols.update(shared=np.zeros(n, bool), kind=np.zeros(n, np.int32), svc=np.zeros(n, np.int32),
                rsvc=np.zeros(n, np.int32), key=np.zeros(n, np.int32), err=np.zeros(n, bool),
                has_dur=np.ones(n, bool), valid=np.ones(n, bool))
    idx = np.arange(t) * per_trace
    median = np.log(float(mix["dur_median_us"]))
    for h in range(hops):
        for half in (0, 1):  # 0: client in the caller, 1: shared server in the callee
            lane = idx + 2 * h + half
            cols["trace_h"][lane] = trace_h
            cols["tl0"][lane], cols["tl1"][lane] = tl[:, 0], tl[:, 1]
            cols["s0"][lane], cols["s1"][lane] = span_id[:, h, 0], span_id[:, h, 1]
            if h > 0:  # parent: the previous hop's (shared) span id
                cols["p0"][lane], cols["p1"][lane] = span_id[:, h - 1, 0], span_id[:, h - 1, 1]
            cols["shared"][lane] = half == 1
            cols["kind"][lane] = 2 if half else 1
            svc = chain[:, h + half]
            cols["svc"][lane] = svc
            cols["rsvc"][lane] = chain[:, h + 1] if half == 0 else 0
            name = rng.choice(names, size=t, p=name_p)
            cols["key"][lane] = svc * names + name
            cols["err"][lane] = hop_err[:, h]
            factor = float(mix["client_factor"]) if half == 0 else 1.0
            dur = rng.lognormal(median, float(mix["dur_sigma"]), t) * factor
            cols["dur"][lane] = np.minimum(dur, 0xFFFFFFFE).astype(np.uint32) + 1
    return PoolBatch(cols, chain, hop_err)


class Pool:
    """The stream of one run: ``pool_batches`` batches made from ``seed``,
    replayed pass after pass with new ids and advancing minutes."""

    def __init__(self, mix: dict, seed: int):
        self.mix = mix
        self.seed = int(seed) & SEED_MASK
        self.batch_spans = int(mix["batch_spans"])
        self.per_trace = 2 * int(mix["hops"])
        self.traces = self.batch_spans // self.per_trace
        self.size = int(mix["pool_batches"])
        self.batches_per_minute = int(mix["batches_per_minute"])
        self.base_minute = int(mix.get("base_minute", BASE_MINUTE))
        self.trace_h = mix.get("trace_h", "drawn")
        if self.trace_h not in TRACE_H_RULES:
            raise ValueError(f"trace_h must be one of {TRACE_H_RULES}, not {self.trace_h!r}")
        rng = np.random.default_rng([self.seed, 0])
        self.batches: List[PoolBatch] = [make_batch(rng, mix) for _ in range(self.size)]
        self._stamps: Dict[int, np.ndarray] = {}

    def minute(self, g: int) -> int:
        return self.base_minute + g // self.batches_per_minute

    def stamp(self, g: int) -> np.ndarray:
        """The pass's constants of global batch ``g``: the XORs of trace_h,
        tl0 and s0, and the durations' offset."""
        q = g // self.size
        got = self._stamps.get(q)
        if got is None:
            got = np.random.default_rng([self.seed, 1, q]).integers(
                0, 1 << 32, 4, dtype=np.uint32)
            self._stamps[q] = got
        return got

    def trace_hashes(self, g: int) -> np.ndarray:
        """[traces] the re-stamped ``trace_h`` of each trace of batch ``g``."""
        b = self.batches[g % self.size].cols
        if self.trace_h == "id":
            return trace_id_hash(b["tl0"][:: self.per_trace] ^ self.stamp(g)[1],
                                 b["tl1"][:: self.per_trace])
        return b["trace_h"][:: self.per_trace] ^ self.stamp(g)[0]

    def columns(self, g: int) -> Dict[str, np.ndarray]:
        """Global batch ``g``'s lane columns with generator ids: the pool
        batch's, with the pass's ids and the batch's minute."""
        pb = self.batches[g % self.size]
        b = pb.cols
        k_trace, k_tl0, k_span, _ = self.stamp(g)
        out = dict(b)
        out["dur"] = self.durations(g)
        out["tl0"] = b["tl0"] ^ k_tl0
        out["trace_h"] = (trace_id_hash(out["tl0"], b["tl1"]) if self.trace_h == "id"
                          else b["trace_h"] ^ k_trace)
        out["s0"] = b["s0"] ^ k_span
        out["p0"] = b["p0"] ^ (pb.parent_mask & k_span)
        out["ts_min"] = np.full(self.batch_spans, self.minute(g), np.uint32)
        return out

    def durations(self, g: int) -> np.ndarray:
        """Batch ``g``'s durations: the pool batch's, each moved within its
        histogram bucket by the pass's offset."""
        pb = self.batches[g % self.size]
        return pb.dur_lo | ((pb.dur_rel + self.stamp(g)[3]) & pb.dur_mask)

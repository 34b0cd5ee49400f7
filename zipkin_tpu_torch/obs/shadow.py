"""Bounded-memory host shadow of the device sketch plane.

The device plane answers every query off approximate structures
(t-digest percentiles, HLL cardinalities, compacted link matrices,
sampled retention) and nothing in the running system measured whether
those answers were still *correct*. This module is the ground-truth
half of the accuracy observatory: a small host-side shadow fed from
the post-parse ingest path — tapped in ``collector/core.py`` (object
path), ``tpu/store.py`` (sync fast path) and the MP fan-out dispatcher
in ``tpu/mp_ingest.py`` — that keeps EXACT statistics over bounded
sub-streams:

- **Per-service duration reservoirs** (vectorized Algorithm R,
  ``reservoir_k`` values per service): exact durations whose empirical
  quantiles anchor the digest relative-error estimators.
- **Hash-sampled distinct sub-stream** (adaptive / KMV-style sketch,
  ``distinct_k`` trace ids): every trace id whose selection hash falls
  under an adaptive threshold θ is kept *exactly*; the distinct-count
  estimate ``|kept| * 2^32 / θ`` is unbiased with relative standard
  error ≈ 1.2/sqrt(|kept|) — the HLL error oracle.
- **Exact link edges on hash-sampled traces** (``link_rate`` of
  traces, trace-affine so sampled traces are COMPLETE): the shadow
  retains the raw span lanes of each sampled trace and the accuracy
  rollup replays them through the host dependency-linker oracle
  (``internal/dependency_linker.py`` — the same semantics the device
  linker is parity-tested against), giving the recall denominator for
  the device's compacted dependency matrices.
- **Retention tallies**: the shadow re-runs the reference verdict
  (:func:`zipkin_tpu_torch.sampling.reference.host_verdict`) over everything
  it drains and keeps its OWN cumulative seen/kept counts — the
  controller consumes ``HostSampler.take_tallies()`` destructively, so
  bias against the live retention counters needs an independent ledger.

Concurrency / hot-path contract: the three ingest taps only call
``offer_*``, which is an O(1) bounded-deque append (plus a drop
counter) — no parsing, hashing or locking happens on the dispatch
path. All real work runs in :meth:`HostShadow.drain`, called from the
accuracy rollup (``obs/accuracy.py``) on the telemetry ticker thread.
Overflowing the pending queue drops the OLDEST batch and counts it;
the accuracy plane gates its estimators on the observed coverage ratio
so a lossy shadow degrades to "no signal", never to a false alert.

Like ``windows``/``slo``/``device``, this module is imported lazily by
the server — ``import zipkin_tpu_torch.obs`` alone never pays for it. Lint
the shadow is host-side ground truth and never runs inside a device
program.
"""

from __future__ import annotations

import math
import threading
from collections import OrderedDict, deque
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from zipkin_tpu_torch.tpu.columnar import SpanColumns, _hash2_np, _mix32

# Selection salts: distinct from sampling.VERDICT_SALT so the shadow's
# sub-streams are independent of the retention verdicts they audit.
_DISTINCT_SALT = 0x5AD0_5EED
_LINK_SALT = 0x11C4_E11E

_U32_SPACE = float(1 << 32)


def rank_interval(q: float, k: int, z: float = 3.0) -> Tuple[float, float]:
    """z-sigma confidence interval on the RANK of the reservoir's
    q-quantile: a k-sample empirical quantile's rank error is binomial,
    stderr sqrt(q(1-q)/k). The accuracy plane turns this into a VALUE
    interval by evaluating the reservoir at both rank endpoints —
    distribution-free, so the stated bound adapts to the data's local
    density instead of assuming a shape."""
    half = z * math.sqrt(max(q * (1.0 - q), 0.0) / max(k, 1))
    return max(0.0, q - half), min(1.0, q + half)


class _Reservoir:
    """Algorithm R over one service's durations, vectorized per batch.

    Element ``t`` (0-based stream index) replaces a uniformly chosen
    slot ``j in [0, t]`` iff ``j < k`` — numpy fancy assignment applies
    duplicates in order, which reproduces the sequential algorithm
    exactly, so the buffer is a uniform k-sample of the whole stream.
    """

    __slots__ = ("k", "buf", "seen", "_rng")

    def __init__(self, k: int, rng: np.random.Generator) -> None:
        self.k = int(k)
        self.buf = np.empty(self.k, np.float64)
        self.seen = 0
        self._rng = rng

    def add(self, vals: np.ndarray) -> None:
        m = len(vals)
        if not m:
            return
        n0 = self.seen
        fill = min(max(self.k - n0, 0), m)
        if fill:
            self.buf[n0:n0 + fill] = vals[:fill]
        if m > fill:
            t = n0 + np.arange(fill, m, dtype=np.int64)
            j = self._rng.integers(0, t + 1)
            sel = j < self.k
            self.buf[j[sel]] = vals[fill:][sel]
        self.seen = n0 + m

    def values(self) -> np.ndarray:
        return self.buf[: min(self.seen, self.k)]

    def quantile(self, q: float) -> float:
        vals = self.values()
        if not len(vals):
            return 0.0
        return float(np.quantile(vals, q))

    def quantile_interval(self, q: float, z: float = 3.0) -> Tuple[float, float]:
        """(lo, hi) VALUE interval for the q-quantile at z sigmas of
        rank noise — empty reservoirs return (0, 0)."""
        vals = self.values()
        if not len(vals):
            return 0.0, 0.0
        q_lo, q_hi = rank_interval(q, len(vals), z)
        pair = np.quantile(vals, [q_lo, q_hi])
        return float(pair[0]), float(pair[1])


class _DistinctSketch:
    """Adaptive hash-sampled distinct counter (KMV / Wegman sampling).

    Keeps EVERY trace id whose selection hash lands below θ; when the
    kept set outgrows ``k``, θ halves and the set is re-filtered — an
    exact distinct count over a uniform 1-in-(2^32/θ) sub-stream. The
    estimate ``|kept| * 2^32/θ`` is unbiased; relative standard error
    ≈ 1.2/sqrt(|kept|) (Flajolet's adaptive-sampling analysis).
    """

    __slots__ = ("k", "ids", "theta")

    def __init__(self, k: int) -> None:
        self.k = int(k)
        self.ids = np.empty(0, np.uint64)
        self.theta = 1 << 32  # full stream until first saturation

    @staticmethod
    def _sel_hash(ids: np.ndarray) -> np.ndarray:
        tl0 = (ids & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        tl1 = (ids >> np.uint64(32)).astype(np.uint32)
        return _mix32(_hash2_np(tl0, tl1) ^ np.uint32(_DISTINCT_SALT))

    def add(self, ids: np.ndarray) -> None:
        if not len(ids):
            return
        ids = ids.astype(np.uint64)
        cand = ids[self._sel_hash(ids).astype(np.uint64) < np.uint64(self.theta)]
        if len(cand):
            self.ids = np.union1d(self.ids, cand)
        while len(self.ids) > self.k:
            self.theta //= 2
            keep = self._sel_hash(self.ids).astype(np.uint64) < np.uint64(self.theta)
            self.ids = self.ids[keep]

    def estimate(self) -> float:
        return len(self.ids) * (_U32_SPACE / self.theta)

    def rel_bound(self, z: float = 3.0) -> float:
        """z-sigma relative error bound of the estimate itself: zero
        while the sketch is still exact (θ never halved)."""
        if self.theta >= (1 << 32):
            return 0.0
        return z * 1.2 / math.sqrt(max(len(self.ids), 1))


class HostShadow:
    """The bounded-memory ground-truth shadow (one per storage)."""

    def __init__(
        self,
        *,
        reservoir_k: int = 512,
        distinct_k: int = 4096,
        link_rate: float = 0.125,
        pending_max: int = 512,
        max_services: int = 1 << 16,
        max_link_traces: int = 256,
        max_link_spans: int = 512,
        seed: int = 0xACC0,
        sampler_ref: Optional[Callable[[], object]] = None,
        svc_resolver: Optional[Callable[[str], Optional[int]]] = None,
        bucket_minutes: int = 0,
        window_slots: int = 8,
    ) -> None:
        self.reservoir_k = int(reservoir_k)
        self.distinct_k = int(distinct_k)
        self.link_rate = float(link_rate)
        self._link_theta = np.uint32(
            min(int(self.link_rate * _U32_SPACE), (1 << 32) - 1)
        )
        self.pending_max = int(pending_max)
        self.max_services = int(max_services)
        self.max_link_traces = int(max_link_traces)
        self.max_link_spans = int(max_link_spans)
        self._seed = int(seed)
        # sampler_ref returns the CURRENT HostSampler (or None): the
        # aggregator can be swapped wholesale (clear/restore), so the
        # shadow must not pin one instance.
        self._sampler_ref = sampler_ref or (lambda: None)
        self._svc_resolver = svc_resolver or (lambda name: None)
        # windowed ground truth: when bucket_minutes > 0 the
        # shadow also keeps PER-TIME-BUCKET exact sub-streams — a global
        # duration reservoir and a KMV distinct sketch per epoch, a ring
        # of the most recent window_slots epochs — so the accuracy plane
        # can audit the time tier's sealed segments the same way the
        # cumulative estimators audit the all-time sketches.
        self.bucket_minutes = int(bucket_minutes)
        self.window_slots = int(window_slots)
        self._pending: deque = deque()
        self._dropped_batches = 0
        self._offered_batches = 0
        self._lock = threading.Lock()
        self._reset_locked()

    def _reset_locked(self) -> None:
        self._rng = np.random.default_rng(self._seed)
        self._reservoirs: Dict[int, _Reservoir] = {}
        self._distinct = _DistinctSketch(self.distinct_k)
        # sampled-trace span lanes: trace id64 -> list of
        # (s0, s1, p0, p1, shared, kind, svc, rsvc, err) tuples; the
        # accuracy rollup replays these through the host linker oracle
        self._link_traces: Dict[int, List[tuple]] = {}
        self._seen_by_svc: Dict[int, int] = {}
        self._total_seen = 0
        self._ret_seen = 0
        self._ret_kept = 0
        # per-epoch windowed sub-streams, oldest-first insertion order
        self._win_res: "OrderedDict[int, _Reservoir]" = OrderedDict()
        self._win_distinct: "OrderedDict[int, _DistinctSketch]" = OrderedDict()

    def reset(self) -> None:
        """Start a fresh shadow window (e.g. after the operator rotates
        retention / clears device state): drop every sub-stream AND the
        pending queue so the next rollup compares like with like."""
        with self._lock:
            self._pending.clear()
            self._reset_locked()

    # -- taps (O(1), called from the ingest paths) ---------------------

    def offer_cols(self, cols: SpanColumns) -> None:
        """Tap for the sync fast path: one packed columnar batch."""
        self._offer(("cols", cols))

    def offer_fused(self, fused: np.ndarray) -> None:
        """Tap for the MP dispatcher: one routed wire image (the
        dispatcher's own copy — safe to hold a reference)."""
        self._offer(("fused", fused))

    def offer_spans(self, spans) -> None:
        """Tap for the object path: already-decoded Span objects."""
        self._offer(("spans", list(spans)))

    def _offer(self, item) -> None:
        # append is atomic under the GIL; the drop check races only
        # against other offers, so the counter is approximate by at
        # most the number of concurrently offering threads.
        if len(self._pending) >= self.pending_max:
            try:
                self._pending.popleft()
            except IndexError:
                pass
            self._dropped_batches += 1
        self._offered_batches += 1
        self._pending.append(item)

    # -- drain (rollup cadence, off the dispatch path) -----------------

    def drain(self) -> int:
        """Fold every pending batch into the shadow; returns batches
        processed. Runs on the accuracy-rollup thread."""
        n = 0
        with self._lock:
            while True:
                try:
                    kind, payload = self._pending.popleft()
                except IndexError:
                    break
                if kind == "cols":
                    self._fold_cols(payload)
                elif kind == "fused":
                    self._fold_fused(payload)
                else:
                    self._fold_spans(payload)
                n += 1
        return n

    def _fold_cols(self, cols: SpanColumns) -> None:
        self._fold_lanes(
            cols.trace_h, cols.tl0, cols.tl1, cols.svc, cols.rsvc,
            cols.key, cols.dur, cols.has_dur, cols.err, cols.valid,
            cols.s0, cols.s1, cols.p0, cols.p1, cols.shared, cols.kind,
            ts=cols.ts_min,
        )

    def _fold_fused(self, fused: np.ndarray) -> None:
        f = np.asarray(fused)
        sr = f[..., 9, :].reshape(-1)
        kf = f[..., 10, :].reshape(-1)
        self._fold_lanes(
            f[..., 0, :].reshape(-1),
            f[..., 1, :].reshape(-1),
            f[..., 2, :].reshape(-1),
            (sr >> np.uint32(16)).astype(np.int64),
            (sr & np.uint32(0xFFFF)).astype(np.int64),
            (kf >> np.uint32(8)).astype(np.int64),
            f[..., 7, :].reshape(-1),
            (kf & np.uint32(8)) != 0,
            (kf & np.uint32(4)) != 0,
            (kf & np.uint32(1)) != 0,
            f[..., 3, :].reshape(-1),
            f[..., 4, :].reshape(-1),
            f[..., 5, :].reshape(-1),
            f[..., 6, :].reshape(-1),
            (kf & np.uint32(2)) != 0,
            ((kf >> np.uint32(4)) & np.uint32(0xF)).astype(np.int64),
            ts=f[..., 8, :].reshape(-1),
        )

    def _fold_spans(self, spans: List) -> None:
        """Object-path batches arrive as Span objects: rebuild the lanes
        the vectorized fold needs. The object path is the low-volume
        compatibility path, so a per-span Python pass here (on the
        rollup thread) is within budget. Spans whose service has not
        been interned yet are skipped — the device has not attributed
        them to a slot either. Retention verdicts are NOT re-run for
        this path (the (service, name) key id is not resolvable without
        interning, which a read-side plane must never do)."""
        from zipkin_tpu_torch.internal.hex import normalize_trace_id
        from zipkin_tpu_torch.tpu.columnar import KIND_TO_ID

        n = len(spans)
        if not n:
            return
        tl0 = np.zeros(n, np.uint32)
        tl1 = np.zeros(n, np.uint32)
        th0 = np.zeros(n, np.uint32)
        th1 = np.zeros(n, np.uint32)
        s0 = np.zeros(n, np.uint32)
        s1 = np.zeros(n, np.uint32)
        p0 = np.zeros(n, np.uint32)
        p1 = np.zeros(n, np.uint32)
        shared = np.zeros(n, bool)
        kind = np.zeros(n, np.int64)
        svc = np.zeros(n, np.int64)
        rsvc = np.zeros(n, np.int64)
        dur = np.zeros(n, np.uint32)
        has_dur = np.zeros(n, bool)
        err = np.zeros(n, bool)
        valid = np.zeros(n, bool)
        ts = np.zeros(n, np.uint32)
        for i, s in enumerate(spans):
            sid = self._svc_resolver(s.local_service_name) if s.local_service_name else None
            if not sid:
                continue
            try:
                full = int(normalize_trace_id(s.trace_id), 16)
                sid64 = int(s.id, 16)
                pid64 = int(s.parent_id, 16) if s.parent_id else 0
            except (TypeError, ValueError):
                continue
            lo64, hi64 = full & ((1 << 64) - 1), full >> 64
            tl0[i], tl1[i] = lo64 & 0xFFFFFFFF, lo64 >> 32
            th0[i], th1[i] = hi64 & 0xFFFFFFFF, hi64 >> 32
            s0[i], s1[i] = sid64 & 0xFFFFFFFF, sid64 >> 32
            p0[i], p1[i] = pid64 & 0xFFFFFFFF, pid64 >> 32
            shared[i] = bool(s.shared)
            kind[i] = KIND_TO_ID.get(s.kind, 0)
            svc[i] = sid
            rid = self._svc_resolver(s.remote_service_name) if s.remote_service_name else None
            rsvc[i] = rid or 0
            d = s.duration or 0
            dur[i] = min(int(d), 0xFFFFFFFF)
            has_dur[i] = d > 0
            err[i] = "error" in (s.tags or {})
            ts[i] = min(int(s.timestamp or 0) // 60_000_000, 0xFFFFFFFF)
            valid[i] = True
        trace_h = _hash2_np(_hash2_np(tl0, tl1), _hash2_np(th0, th1))
        self._fold_lanes(
            trace_h, tl0, tl1, svc, rsvc, None, dur, has_dur, err, valid,
            s0, s1, p0, p1, shared, kind, ts=ts,
        )

    def _fold_lanes(
        self, trace_h, tl0, tl1, svc, rsvc, key, dur, has_dur, err, valid,
        s0, s1, p0, p1, shared, kind, ts=None,
    ) -> None:
        v = np.asarray(valid, bool)
        if not v.any():
            return
        trace_h = np.asarray(trace_h, np.uint32)[v]
        tl0 = np.asarray(tl0)[v]
        tl1 = np.asarray(tl1)[v]
        svc = np.asarray(svc, np.int64)[v]
        rsvc = np.asarray(rsvc, np.int64)[v]
        dur = np.asarray(dur, np.uint32)[v]
        has_dur = np.asarray(has_dur, bool)[v]
        err = np.asarray(err, bool)[v]
        s0 = np.asarray(s0, np.uint32)[v]
        s1 = np.asarray(s1, np.uint32)[v]
        p0 = np.asarray(p0, np.uint32)[v]
        p1 = np.asarray(p1, np.uint32)[v]
        shared = np.asarray(shared, bool)[v]
        kind = np.asarray(kind, np.int64)[v]
        svc = np.clip(svc, 0, self.max_services - 1)
        rsvc = np.clip(rsvc, 0, self.max_services - 1)
        self._total_seen += len(svc)
        # per-service seen tallies + duration reservoirs
        uniq, counts = np.unique(svc, return_counts=True)
        for s, c in zip(uniq.tolist(), counts.tolist()):
            self._seen_by_svc[s] = self._seen_by_svc.get(s, 0) + c
        hd = has_dur
        if hd.any():
            dsvc = svc[hd]
            ddur = dur[hd].astype(np.float64)
            for s in np.unique(dsvc).tolist():
                res = self._reservoirs.get(s)
                if res is None:
                    res = self._reservoirs[s] = _Reservoir(
                        self.reservoir_k, self._rng
                    )
                res.add(ddur[dsvc == s])
        # distinct sub-stream (trace identity = low-64 id lanes)
        ids = (tl1.astype(np.uint64) << np.uint64(32)) | tl0.astype(np.uint64)
        self._distinct.add(np.unique(ids))
        # per-time-bucket windowed sub-streams: the exact
        # mirrors of the device's tb_* current-bucket sketches, keyed by
        # the SAME epoch = ts_min // bucket_minutes the ingest step uses
        if self.bucket_minutes > 0 and ts is not None:
            eps = (
                np.asarray(ts, np.int64)[v] // self.bucket_minutes
            )
            for e in np.unique(eps).tolist():
                in_e = eps == e
                res = self._win_res.get(e)
                if res is None:
                    # only track epochs newer than anything evicted —
                    # a late straggler for a dropped epoch must not
                    # resurrect it with a near-empty (biased) reservoir
                    if (
                        len(self._win_res) >= self.window_slots
                        and e < next(iter(self._win_res))
                    ):
                        continue
                    res = self._win_res[e] = _Reservoir(
                        self.reservoir_k, self._rng
                    )
                    self._win_distinct[e] = _DistinctSketch(self.distinct_k)
                sel_d = in_e & hd
                if sel_d.any():
                    res.add(dur[sel_d].astype(np.float64))
                self._win_distinct[e].add(np.unique(ids[in_e]))
            while len(self._win_res) > self.window_slots:
                old, _ = self._win_res.popitem(last=False)
                self._win_distinct.pop(old, None)
            # keep insertion order == epoch order for the eviction rule
            if len(self._win_res) > 1:
                order = sorted(self._win_res)
                if list(self._win_res) != order:
                    self._win_res = OrderedDict(
                        (e, self._win_res[e]) for e in order
                    )
                    self._win_distinct = OrderedDict(
                        (e, self._win_distinct[e])
                        for e in order if e in self._win_distinct
                    )
        # sampled-trace span lanes for the host linker oracle: trace-
        # affine selection (pure function of the trace hash) keeps every
        # span of a sampled trace across batches and ingest paths
        sel = _mix32(trace_h ^ np.uint32(_LINK_SALT)) < self._link_theta
        for i in np.nonzero(sel)[0].tolist():
            tid = int(ids[i])
            rec = self._link_traces.get(tid)
            if rec is None:
                if len(self._link_traces) >= self.max_link_traces:
                    continue
                rec = self._link_traces[tid] = []
            if len(rec) < self.max_link_spans:
                rec.append((
                    int(s0[i]), int(s1[i]), int(p0[i]), int(p1[i]),
                    bool(shared[i]), int(kind[i]), int(svc[i]),
                    int(rsvc[i]), bool(err[i]),
                ))
        # retention verdicts vs the sampler's published tables
        if key is not None:
            sampler = self._sampler_ref()
            if sampler is not None:
                from zipkin_tpu_torch.sampling.reference import host_verdict

                key = np.clip(np.asarray(key, np.int64)[v], 0, None)
                keep = host_verdict(
                    trace_h, svc, rsvc, key, dur, hd, err,
                    np.ones(len(svc), bool),
                    sampler.rate, sampler.tail, sampler.link,
                    sampler.rare_min,
                )
                self._ret_seen += len(svc)
                self._ret_kept += int(keep.sum())

    # -- query side (accuracy rollup + statusz) ------------------------

    def services(self) -> List[int]:
        with self._lock:
            return sorted(self._reservoirs)

    def reservoir(self, svc_id: int) -> Optional[_Reservoir]:
        with self._lock:
            return self._reservoirs.get(svc_id)

    def distinct_estimate(self) -> float:
        with self._lock:
            return self._distinct.estimate()

    def distinct_bound(self, z: float = 3.0) -> float:
        with self._lock:
            return self._distinct.rel_bound(z)

    def link_traces(self) -> Dict[int, List[tuple]]:
        """Snapshot of the sampled traces' span lanes: trace id64 ->
        [(s0, s1, p0, p1, shared, kind, svc, rsvc, err), ...]."""
        with self._lock:
            return {tid: list(rec) for tid, rec in self._link_traces.items()}

    def retention(self) -> Tuple[int, int]:
        """(seen, kept) cumulative shadow verdict tallies."""
        with self._lock:
            return self._ret_seen, self._ret_kept

    def window_epochs(self) -> List[int]:
        """Epochs (ts_min // bucket_minutes) the windowed shadow holds,
        ascending — empty when the windowed shadow is off."""
        with self._lock:
            return sorted(self._win_res)

    def window_reservoir(self, epoch: int) -> Optional[_Reservoir]:
        with self._lock:
            return self._win_res.get(epoch)

    def window_distinct(self, epoch: int) -> Optional[_DistinctSketch]:
        with self._lock:
            return self._win_distinct.get(epoch)

    def seen_by_service(self) -> Dict[int, int]:
        with self._lock:
            return dict(self._seen_by_svc)

    @property
    def total_seen(self) -> int:
        return self._total_seen

    @property
    def dropped_batches(self) -> int:
        return self._dropped_batches

    def counters(self) -> Dict[str, float]:
        with self._lock:
            return {
                "shadowSpans": self._total_seen,
                "shadowServices": len(self._reservoirs),
                "shadowDistinctKept": len(self._distinct.ids),
                "shadowDistinctTheta": self._distinct.theta / _U32_SPACE,
                "shadowLinkTraces": len(self._link_traces),
                "shadowWindowEpochs": len(self._win_res),
                "shadowPending": len(self._pending),
                "shadowOfferedBatches": self._offered_batches,
                "shadowDroppedBatches": self._dropped_batches,
            }

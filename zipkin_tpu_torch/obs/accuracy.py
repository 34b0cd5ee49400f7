"""Accuracy observatory: relative-error estimators over the shadow.

The evaluation half of the accuracy plane (see ``obs/shadow.py`` for
the ground-truth half). At rollup cadence — driven by the windowed
telemetry ticker, rate-limited to ``rollup_s`` — the estimator drains
the shadow's pending taps, queries the device plane through the
existing one-transfer read paths (``merged_digest`` / ``cardinalities``
/ ``dependency_edges``, each ONE packed pull through the readpack
chokepoint), and publishes relative-error gauges:

- ``accuracyDigestP50RelErr`` / ``accuracyDigestP99RelErr``: worst
  per-service |digest quantile − reservoir quantile| / reservoir
  quantile. The per-service device quantile is re-derived host-side
  from the pulled [K, C, 2] digest by merging the service's key rows —
  standard t-digest midpoint interpolation, no extra transfer.
- ``accuracyDigestP99Bound``: the STATED confidence bound for the
  worst service — the reservoir evaluated at ``q ± (digest cluster
  width + 3σ reservoir rank noise)``, i.e. distribution-free and
  recomputed per rollup (ops/tdigest.cluster_q_width).
- ``accuracyDigestP50Drift`` / ``accuracyDigestP99Drift``: the ALERT
  gauges — relative error in excess of what reservoir sampling noise
  alone explains (``max(0, relerr - noise_bound)``). The noise bound
  deliberately EXCLUDES the digest's cluster width: an undersized
  digest widens its own stated bound, so excess-over-full-bound could
  never page on it, while excess-over-noise does. Conversely, on
  heavy-tailed streams the sample p99 is noisy even when the digest is
  perfect — raw relerr reads 30%+ there — and the noise bound absorbs
  exactly that, so drift stays at 0 for a healthy digest.
- ``accuracyHllRelErr`` / ``accuracyHllBound`` /
  ``accuracyHllDrift``: global device HLL estimate vs the shadow's
  exact-on-substream distinct estimate; bound = 3·stderr(p) +
  measured bias fraction + substream noise, drift = excess over it.
- ``accuracyLinkRecall``: fraction of edges the host linker oracle
  derives from the shadow's sampled traces that the device's
  compacted dependency matrix also reports.
- ``accuracyRetentionBias``: |shadow verdict keep-rate − live
  sampledKept/(sampledKept+sampledDropped)| — drift between the
  published sampling tables and what retention actually did.

Estimators degrade to NO SIGNAL, never to false alerts: when the
shadow's coverage (spans drained / spans ingested) falls under
``min_coverage`` — lossy taps, or a restore that re-fed the device
with history the shadow never saw — error gauges report 0.0 and
recall 1.0, with ``accuracyShadowCoverage`` telling the operator why.

The gauges merge into ``TorchStorage.ingest_counters()`` and from there
flow everywhere counters flow: ``/metrics``, flat
``zipkin_tpu_accuracy_*`` gauges on ``/prometheus``, the statusz
accuracy section, and the windowed-telemetry counter source — which is
what lets the burn-rate watchdog (obs/slo.py) alert on accuracy drift through
the two default gauge ``SloSpec``s (digest_p99_relerr, hll_relerr)
exactly like it alerts on latency.
"""

from __future__ import annotations

import math
import threading
import time
import weakref
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from zipkin_tpu_torch import obs
from zipkin_tpu_torch.obs.shadow import HostShadow
from zipkin_tpu_torch.ops import ttmerge

_FULL_LO_MIN = 0
_FULL_HI_MIN = (1 << 32) - 1


def _digest_quantile(rows: np.ndarray, q: float) -> Tuple[float, float]:
    """(quantile, total weight) of one service's merged centroid rows
    ``[m, C, 2]`` — the same midpoint interpolation ops/tdigest.quantile
    runs on device, host-side over the already-pulled read."""
    means = rows[..., 0].ravel()
    w = rows[..., 1].ravel()
    live = w > 0
    if not live.any():
        return 0.0, 0.0
    m_, w_ = means[live], w[live]
    order = np.argsort(m_, kind="stable")
    m_, w_ = m_[order], w_[order]
    cum = np.cumsum(w_) - 0.5 * w_
    total = float(w_.sum())
    return float(np.interp(q * total, cum, m_)), total


class AccuracyEstimator:
    """Rollup-cadence accuracy evaluation for one storage instance."""

    QS = (0.5, 0.99)

    def __init__(
        self,
        storage,
        shadow: HostShadow,
        *,
        rollup_s: float = 5.0,
        min_count: int = 64,
        min_coverage: float = 0.9,
        clock=time.monotonic,
    ) -> None:
        # the store owns its estimator (store.accuracy): a weak proxy, so
        # the pair is no cycle that keeps a dropped store's device state
        self._store = weakref.proxy(storage)
        self._shadow = shadow
        self.rollup_s = float(rollup_s)
        self.min_count = int(min_count)
        self.min_coverage = float(min_coverage)
        self._clock = clock
        self._last = float("-inf")
        self._lock = threading.Lock()
        self._roll_lock = threading.Lock()
        self.rollups = 0
        self._detail: Dict = {"services": [], "suppressed": False}
        self._gauges: Dict[str, float] = {
            "accuracyDigestP50RelErr": 0.0,
            "accuracyDigestP99RelErr": 0.0,
            "accuracyDigestP99Bound": 0.0,
            "accuracyDigestP50Drift": 0.0,
            "accuracyDigestP99Drift": 0.0,
            "accuracyHllRelErr": 0.0,
            "accuracyHllBound": 0.0,
            "accuracyHllDrift": 0.0,
            "accuracyWindowedDigestP99RelErr": 0.0,
            "accuracyWindowedDigestP99Drift": 0.0,
            "accuracyWindowedHllRelErr": 0.0,
            "accuracyWindowedHllDrift": 0.0,
            "accuracyLinkRecall": 1.0,
            "accuracyRetentionBias": 0.0,
            "accuracyShadowCoverage": 1.0,
            "accuracyRollups": 0,
            "accuracyRollupMs": 0.0,
        }

    # -- scheduling ----------------------------------------------------

    def maybe_rollup(self, now: Optional[float] = None) -> bool:
        """Rate-limited rollup; safe to call from the ticker thread and
        read handlers concurrently (overlapping calls no-op)."""
        now = self._clock() if now is None else now
        if now - self._last < self.rollup_s:
            return False
        if not self._roll_lock.acquire(blocking=False):
            return False
        try:
            self._last = now
            self.rollup()
            return True
        finally:
            self._roll_lock.release()

    # -- evaluation ----------------------------------------------------

    def rollup(self) -> Dict[str, float]:
        """Drain the shadow, read the device plane, publish gauges."""
        t0 = time.perf_counter()
        shadow = self._shadow
        store = self._store
        shadow.drain()

        spans_total = int(store.agg.host_counters.get("spans", 0))
        coverage = (
            min(1.0, shadow.total_seen / spans_total)
            if spans_total > 0 else 1.0
        )
        suppressed = coverage < self.min_coverage

        services: List[Dict] = []
        p50_err = p99_err = p99_bound = 0.0
        p50_drift = p99_drift = 0.0
        hll_err = hll_bound = 0.0
        recall = 1.0
        ret_bias = 0.0
        w_digest_err = w_digest_drift = 0.0
        w_hll_err = w_hll_drift = 0.0
        links_detail: Dict = {}
        distinct_detail: Dict = {}
        windowed_detail: Dict = {}

        if not suppressed:
            (services, p50_err, p99_err, p99_bound,
             p50_drift, p99_drift) = self._digest_errors()
            hll_err, hll_bound, distinct_detail = self._hll_error()
            (w_digest_err, w_digest_drift, w_hll_err, w_hll_drift,
             windowed_detail) = self._windowed_errors()
            recall, links_detail = self._link_recall()
            ret_bias = self._retention_bias()

        self.rollups += 1
        roll_ms = (time.perf_counter() - t0) * 1000.0
        obs.record("accuracy_rollup", time.perf_counter() - t0)
        gauges = {
            "accuracyDigestP50RelErr": p50_err,
            "accuracyDigestP99RelErr": p99_err,
            "accuracyDigestP99Bound": p99_bound,
            "accuracyDigestP50Drift": p50_drift,
            "accuracyDigestP99Drift": p99_drift,
            "accuracyHllRelErr": hll_err,
            "accuracyHllBound": hll_bound,
            "accuracyHllDrift": max(0.0, hll_err - hll_bound),
            "accuracyWindowedDigestP99RelErr": w_digest_err,
            "accuracyWindowedDigestP99Drift": w_digest_drift,
            "accuracyWindowedHllRelErr": w_hll_err,
            "accuracyWindowedHllDrift": w_hll_drift,
            "accuracyLinkRecall": recall,
            "accuracyRetentionBias": ret_bias,
            "accuracyShadowCoverage": coverage,
            "accuracyRollups": self.rollups,
            "accuracyRollupMs": roll_ms,
        }
        with self._lock:
            self._gauges = gauges
            self._detail = {
                "services": services,
                "links": links_detail,
                "distinct": distinct_detail,
                "windowed": windowed_detail,
                "suppressed": suppressed,
            }
        return gauges

    def _digest_errors(
        self,
    ) -> Tuple[List[Dict], float, float, float, float, float]:
        """Per-service digest-vs-reservoir relative errors; worst-case
        aggregates for the gauges. One device transfer when any service
        is eligible, zero at rest."""
        shadow = self._shadow
        store = self._store
        eligible = [
            s for s in shadow.services()
            if (res := shadow.reservoir(s)) is not None
            and res.seen >= self.min_count
        ]
        if not eligible:
            return [], 0.0, 0.0, 0.0, 0.0, 0.0
        # ops.tdigest imports torch: loaded here, not when obs is imported
        from zipkin_tpu_torch.ops.tdigest import cluster_q_width

        digest = np.asarray(store.agg.merged_digest())  # [K, C, 2]
        c = digest.shape[1]
        with store.vocab._lock:
            pairs = np.asarray(store.vocab._key_list, np.int64)
        rows: List[Dict] = []
        p50_err = p99_err = p99_bound = 0.0
        p50_drift = p99_drift = 0.0
        for svc in eligible:
            kids = np.nonzero(pairs[:, 0] == svc)[0]
            kids = kids[kids >= 1]
            if not len(kids):
                continue
            res = shadow.reservoir(svc)
            vals = res.values()
            k = len(vals)
            errs = {}
            bounds = {}
            drifts = {}
            skip = False
            for q in self.QS:
                dev_q, total = _digest_quantile(digest[kids], q)
                if total < self.min_count:
                    skip = True
                    break
                sq = float(np.quantile(vals, q))
                errs[q] = abs(dev_q - sq) / max(sq, 1.0)
                # stated bound: reservoir evaluated at q widened by the
                # digest's own rank resolution plus 3σ of reservoir
                # rank noise — both in rank space, converted to a value
                # bound by the exact sample itself
                noise = 3.0 * math.sqrt(max(q * (1.0 - q), 0.0) / k)
                half = cluster_q_width(c, q) + noise
                vlo, vhi = np.quantile(
                    vals, [max(0.0, q - half), min(1.0, q + half)]
                )
                bounds[q] = (
                    max(float(vhi) - sq, sq - float(vlo)) / max(sq, 1.0)
                    + 0.005
                )
                # drift = error the SAMPLING noise can't explain. The
                # digest's cluster width is excluded on purpose: an
                # undersized digest must not widen the bound it is
                # judged against (it would never page), while a noisy
                # sample p99 on a heavy-tailed stream must not page a
                # digest that is actually fine.
                nlo, nhi = np.quantile(
                    vals, [max(0.0, q - noise), min(1.0, q + noise)]
                )
                noise_bound = (
                    max(float(nhi) - sq, sq - float(nlo)) / max(sq, 1.0)
                    + 0.005
                )
                drifts[q] = max(0.0, errs[q] - noise_bound)
            if skip:
                continue
            name = store.vocab.services.lookup(int(svc)) or str(svc)
            rows.append({
                "service": name,
                "reservoirSeen": res.seen,
                "p50RelErr": round(errs[0.5], 6),
                "p99RelErr": round(errs[0.99], 6),
                "p99Bound": round(bounds[0.99], 6),
                "p99Drift": round(drifts[0.99], 6),
            })
            p50_err = max(p50_err, errs[0.5])
            p50_drift = max(p50_drift, drifts[0.5])
            p99_drift = max(p99_drift, drifts[0.99])
            if errs[0.99] >= p99_err:
                p99_err = errs[0.99]
                p99_bound = bounds[0.99]
        return rows, p50_err, p99_err, p99_bound, p50_drift, p99_drift

    def _hll_error(self) -> Tuple[float, float, Dict]:
        from zipkin_tpu_torch.ops import hll  # imports torch: loaded at first use

        shadow = self._shadow
        store = self._store
        kept = shadow.counters()["shadowDistinctKept"]
        if kept < self.min_count:
            return 0.0, 0.0, {}
        est = np.asarray(store.agg.cardinalities())  # [S+1], last global
        dev = float(est[store.config.global_hll_row])
        sh = shadow.distinct_estimate()
        err = abs(dev - sh) / max(sh, 1.0)
        bound = (
            3.0 * hll.standard_error(store.config.hll_precision)
            + hll.bias_fraction(max(dev, 1.0))
            + shadow.distinct_bound()
        )
        return err, bound, {
            "device": dev,
            "shadow": sh,
            "kept": int(kept),
        }

    def _windowed_errors(self) -> Tuple[float, float, float, float, Dict]:
        """Windowed accuracy: audit the time tier's newest
        SEALED bucket for which the windowed shadow holds exact
        sub-streams — the tier's per-bucket digest p99 vs the bucket's
        exact reservoir, and the bucket's HLL estimate vs the bucket's
        KMV sketch. Same estimator shapes (and the same drift-over-
        noise alert semantics) as the cumulative pair, so the default
        windowed SloSpecs page on real sketch drift, not sampling
        noise. Sealed-only by construction: a sealed segment never
        changes, so this read takes no aggregator lock."""
        shadow = self._shadow
        store = self._store
        tier = getattr(store, "timetier", None)
        if tier is None or shadow.bucket_minutes <= 0:
            return 0.0, 0.0, 0.0, 0.0, {}
        from zipkin_tpu_torch.ops import hll  # imports torch: loaded at first use

        eps = [
            e for e in shadow.window_epochs() if e <= tier.sealed_through
        ]
        if not eps:
            return 0.0, 0.0, 0.0, 0.0, {}
        epoch = eps[-1]
        ans = tier.window(store.agg, epoch, epoch)
        d_err = d_drift = h_err = h_drift = 0.0
        detail: Dict = {"epoch": int(epoch)}
        res = shadow.window_reservoir(epoch)
        if res is not None and res.seen >= self.min_count:
            vals = res.values()
            k = len(vals)
            q = 0.99
            dev_q, total = _digest_quantile(np.asarray(ans.digest)[1:], q)
            if total >= self.min_count:
                sq = float(np.quantile(vals, q))
                d_err = abs(dev_q - sq) / max(sq, 1.0)
                noise = 3.0 * math.sqrt(q * (1.0 - q) / k)
                nlo, nhi = np.quantile(
                    vals, [max(0.0, q - noise), min(1.0, q + noise)]
                )
                noise_bound = (
                    max(float(nhi) - sq, sq - float(nlo)) / max(sq, 1.0)
                    + 0.005
                )
                d_drift = max(0.0, d_err - noise_bound)
                detail["digest"] = {
                    "device": dev_q, "shadow": sq, "reservoirSeen": res.seen,
                }
        sk = shadow.window_distinct(epoch)
        if sk is not None and len(sk.ids) >= self.min_count:
            dev = float(
                ttmerge.hll_estimate(np.asarray(ans.hll))[
                    store.config.global_hll_row
                ]
            )
            sh = sk.estimate()
            h_err = abs(dev - sh) / max(sh, 1.0)
            bound = (
                3.0 * hll.standard_error(store.config.hll_precision)
                + hll.bias_fraction(max(dev, 1.0))
                + sk.rel_bound()
            )
            h_drift = max(0.0, h_err - bound)
            detail["distinct"] = {"device": dev, "shadow": sh}
        return d_err, d_drift, h_err, h_drift, detail

    def _link_recall(self) -> Tuple[float, Dict]:
        """Replay the shadow's sampled traces through the host linker
        oracle and check every derived edge against the device's
        compacted dependency read (full window, one transfer)."""
        shadow_edges = self._shadow_edges()
        if not shadow_edges:
            return 1.0, {}
        store = self._store
        s = store.config.max_services
        idx, calls, _errors = store.agg.dependency_edges(
            _FULL_LO_MIN, _FULL_HI_MIN
        )
        live = calls > 0
        dev_edges: Set[Tuple[int, int]] = {
            (int(f) // s, int(f) % s) for f in idx[live]
        }
        hit = len(shadow_edges & dev_edges)
        return hit / len(shadow_edges), {
            "shadowEdges": len(shadow_edges),
            "deviceEdges": len(dev_edges),
            "matched": hit,
        }

    def _shadow_edges(self) -> Set[Tuple[int, int]]:
        from zipkin_tpu_torch.internal.dependency_linker import DependencyLinker
        from zipkin_tpu_torch.model.span import Endpoint, Span
        from zipkin_tpu_torch.tpu.columnar import ID_TO_KIND

        traces = self._shadow.link_traces()
        if not traces:
            return set()
        vocab = self._store.vocab
        linker = DependencyLinker()
        for tid, recs in traces.items():
            spans = []
            for (s0, s1, p0, p1, shared, kind, svc, rsvc, err) in recs:
                local = vocab.services.lookup(int(svc))
                if not local:
                    continue
                remote = vocab.services.lookup(int(rsvc)) if rsvc else None
                sid = (s1 << 32) | s0
                pid = (p1 << 32) | p0
                spans.append(Span(
                    trace_id=f"{tid:016x}",
                    id=f"{sid:016x}",
                    parent_id=f"{pid:016x}" if pid else None,
                    kind=ID_TO_KIND.get(kind),
                    local_endpoint=Endpoint(service_name=local),
                    remote_endpoint=(
                        Endpoint(service_name=remote) if remote else None
                    ),
                    tags={"error": "true"} if err else {},
                    shared=bool(shared),
                ))
            if spans:
                linker.put_trace(spans)
        edges: Set[Tuple[int, int]] = set()
        for link in linker.link():
            p = vocab.services.get(link.parent)
            child = vocab.services.get(link.child)
            if p and child:
                edges.add((int(p), int(child)))
        return edges

    def _retention_bias(self) -> float:
        seen, kept = self._shadow.retention()
        if seen < self.min_count:
            return 0.0
        counters = self._store.agg.host_counters
        live_kept = int(counters.get("sampledKept", 0))
        live_dropped = int(counters.get("sampledDropped", 0))
        live_total = live_kept + live_dropped
        if live_total <= 0:
            return 0.0
        return abs(kept / seen - live_kept / live_total)

    # -- export --------------------------------------------------------

    def gauges(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._gauges)

    def export_counters(self) -> Dict[str, float]:
        """Flat numeric dict for the ingest_counters merge: the accuracy
        gauges plus the shadow's own occupancy counters."""
        out = self.gauges()
        out.update(self._shadow.counters())
        return out

    def status(self) -> Dict:
        """Full dict for the ``/statusz`` accuracy section."""
        with self._lock:
            detail = dict(self._detail)
            gauges = dict(self._gauges)
        return {
            "gauges": gauges,
            "rollupS": self.rollup_s,
            "minCount": self.min_count,
            "minCoverage": self.min_coverage,
            "shadow": self._shadow.counters(),
            **detail,
        }

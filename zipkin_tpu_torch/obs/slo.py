"""SLO burn-rate watchdog over the windowed telemetry plane.

Declarative specs, Google-SRE-style multi-window evaluation: each
:class:`SloSpec` names an error-budget objective and two lookbacks; the
watchdog computes the **burn rate** (observed bad fraction divided by
the budgeted bad fraction ``1 - objective``) over both windows and
trips only when *both* burn — the short window gives fast reaction, the
long window filters blips. A tripped alert holds until both windows
recover (hysteresis for free: the long window keeps burning until the
bad events age out of it).

Spec grammar (three kinds):

- ``latency``: ``stage`` + ``threshold_us`` against the windowed stage
  histogram. An observation counts *bad* when its bucket's inclusive
  upper bound exceeds the threshold — the same upper-bound convention
  the quantile reads use, so "p99 < 50 ms" is expressed as objective
  0.99 with threshold_us 50_000.
- ``ratio``: ``bad`` counter delta over either ``total`` (exact
  denominator) or ``bad + good`` (when no total counter exists).
- ``gauge``: instantaneous counter value against ``limit``; burn is
  ``value / limit`` on both windows and the alert threshold is 1.0
  (a gauge is not rate-like, so the burn multiplier does not apply).

Windows with no events do not burn: an idle system is in SLO.
Evaluation is driven by the telemetry ticker (the watchdog subscribes
to ``on_tick``) so trips land within one tick of the burn being
visible; read paths may also call :meth:`SloWatchdog.evaluate`.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Sequence

from zipkin_tpu_torch.obs.recorder import bucket_le_us
from zipkin_tpu_torch.obs.windows import WindowedTelemetry, WindowStats


@dataclasses.dataclass(frozen=True)
class SloSpec:
    name: str
    kind: str                  # "latency" | "ratio" | "gauge"
    short_s: float = 60.0
    long_s: float = 300.0
    burn_threshold: float = 2.0
    objective: float = 0.99    # good-fraction target (latency/ratio)
    # latency
    stage: str = ""
    threshold_us: int = 0
    # ratio
    bad: str = ""
    good: str = ""
    total: str = ""
    # gauge
    gauge: str = ""
    limit: float = 0.0

    def __post_init__(self) -> None:
        if self.kind not in ("latency", "ratio", "gauge"):
            raise ValueError(f"unknown SLO kind: {self.kind!r}")
        if self.kind == "latency" and not self.stage:
            raise ValueError(f"{self.name}: latency SLO needs a stage")
        if self.kind == "ratio" and not (self.bad and (self.good
                                                       or self.total)):
            raise ValueError(f"{self.name}: ratio SLO needs bad+good/total")
        if self.kind == "gauge" and not (self.gauge and self.limit > 0):
            raise ValueError(f"{self.name}: gauge SLO needs gauge+limit")


def default_specs(short_s: float = 60.0, long_s: float = 300.0,
                  burn_threshold: float = 2.0) -> List[SloSpec]:
    """The four production SLOs from the north star, snapshot age, plus
    the accuracy-drift gauges published by the accuracy observatory
    (obs/accuracy.py) and the HLL operating-envelope breach ratio.

    The accuracy gauges default to 0.0 (and are coverage-gated to 0.0
    when the shadow is lossy), so these specs are inert until a rollup
    actually measures drift — an idle or shadowless deployment stays in
    SLO. The specs watch the DRIFT gauges — relative error in excess
    of the noise the accuracy plane's own ground truth carries (see
    obs/accuracy.py) — not the raw relative errors: a heavy-tailed
    stream makes the raw p99 comparison noisy even when the digest is
    healthy, while an undersized digest shows up as drift the noise
    bound cannot explain. Limits mirror the sketches' design envelopes
    with headroom: t-digest C=64 claims ~0.5% p99 error, HLL p=14
    claims ~0.8% — a sustained 20% / 15% of UNEXPLAINED relative error
    means the structure is mis-sized or broken, not noisy."""
    kw = dict(short_s=short_s, long_s=long_s, burn_threshold=burn_threshold)
    return [
        SloSpec("ingest_wire_to_ack", "ratio", objective=0.999,
                bad="collectorMessagesDropped", total="collectorMessages",
                **kw),
        SloSpec("query_fresh_p99", "latency", objective=0.99,
                stage="query_fresh", threshold_us=50_000, **kw),
        SloSpec("durability_wal_fsync", "latency", objective=0.99,
                stage="wal_fsync", threshold_us=100_000, **kw),
        SloSpec("backpressure_429", "ratio", objective=0.99,
                bad="mpRejected", good="mpAccepted", **kw),
        SloSpec("snapshot_age", "gauge", gauge="snapshotAgeS",
                limit=1800.0, **kw),
        # Disk-exhaustion degraded mode: storage flips this
        # 0/1 gauge the instant a durable tier (WAL append or snapshot
        # commit) enters ENOSPC-degraded mode — acked spans are not
        # crash-safe until a snapshot re-covers the gap, which is a
        # page, not a dashboard curiosity. A 0/1 gauge against limit
        # 1.0 makes the trip immediate and the clear exact.
        SloSpec("durability_at_risk", "gauge", gauge="durabilityAtRisk",
                limit=1.0, **kw),
        SloSpec("digest_p99_relerr", "gauge",
                gauge="accuracyDigestP99Drift", limit=0.20, **kw),
        SloSpec("hll_relerr", "gauge",
                gauge="accuracyHllDrift", limit=0.15, **kw),
        # Windowed accuracy: the same drift-over-noise
        # semantics evaluated against the time tier's newest sealed
        # bucket — per-bucket digest p99 vs the bucket's exact shadow
        # reservoir, per-bucket HLL vs its KMV sketch. Same limits as
        # the cumulative pair: a sealed segment is the SAME sketch
        # structure, so sustained unexplained error past them means the
        # seal/merge path (not sampling noise) is corrupting windows.
        SloSpec("windowed_digest_p99_relerr", "gauge",
                gauge="accuracyWindowedDigestP99Drift", limit=0.20, **kw),
        SloSpec("windowed_hll_relerr", "gauge",
                gauge="accuracyWindowedHllDrift", limit=0.15, **kw),
        SloSpec("hll_envelope", "ratio", objective=0.99,
                bad="hllEnvelopeExceeded", total="hostTransfers", **kw),
        # Critical-path tracer (obs/critpath.py): wire-to-durable is the
        # END of the ingest story — boundary read through wal fsync — a
        # strictly longer interval than wire-to-ack's 202-on-enqueue.
        # 5 s covers the dispatcher's coalescing window plus a device
        # feed with headroom; sustained excess means the fan-out tier is
        # backed up, not merely busy.
        SloSpec("ingest_wire_to_durable", "latency", objective=0.99,
                stage="wire_to_durable", threshold_us=5_000_000, **kw),
        # Little's-law queue saturation gauge from the stitcher: lambda
        # x mean(queue-wait + slot-wait) over total queue capacity.
        # Zeroed on idle ticks, so a stale reading cannot hold an alert.
        SloSpec("ingest_queue_saturation", "gauge",
                gauge="critpathQueueSaturation", limit=0.9, **kw),
        # Query-plane observatory (obs/querytrace.py): the
        # instrumented aggregator lock relays every outermost wait into
        # query_lock_wait — sustained waits past 10 ms mean readers are
        # queueing on the lock again, i.e. traffic is bypassing the
        # epoch-published read mirror (tpu/mirror.py) that took the read
        # path off the lock (per-request staleness_ms=0 floods, or
        # TPU_READ_MIRROR=false). query_wall is the stitched whole-query
        # critical path, so this spec IS the "p99 < 50 ms under
        # concurrent readers" target measured from inside the pipeline
        # rather than from a benchmark harness.
        SloSpec("query_lock_wait", "latency", objective=0.99,
                stage="query_lock_wait", threshold_us=10_000, **kw),
        SloSpec("query_p99_concurrent", "latency", objective=0.99,
                stage="query_wall", threshold_us=50_000, **kw),
        # Epoch-published read mirror (the reference's tpu/mirror.py): the
        # staleness contract is the price of lock-free serving — mirror
        # answers may lag the live aggregator by up to the publish
        # cadence. mirrorServeAgeMs is the age-at-serve gauge (worst
        # serve in flight resets per read); the limit mirrors the
        # TPU_MIRROR_MAX_STALE_MS default, so a trip means the publisher
        # stopped cutting epochs (ticker dead, publish erroring) while
        # reads kept serving ever-older data — page before dashboards
        # quietly freeze in time.
        SloSpec("query_mirror_staleness", "gauge",
                gauge="mirrorServeAgeMs", limit=5000.0, **kw),
        # Scale-out reader processes (the reference's serving/): the same
        # staleness contract one process boundary further out —
        # readerServeAgeMs is the worst live reader's age-at-serve,
        # relayed through the segment heartbeat stripes into
        # ingest_counters. Inert at 0.0 with no readers attached; a
        # trip with readers attached means the segment publisher
        # stopped landing epochs (sink erroring, payload overflowing)
        # while reader processes kept serving the last one.
        SloSpec("reader_staleness", "gauge",
                gauge="readerServeAgeMs", limit=5000.0, **kw),
    ]


def tenant_specs(tenant: str, short_s: float = 60.0, long_s: float = 300.0,
                 burn_threshold: float = 2.0,
                 objective: float = 0.99) -> List[SloSpec]:
    """Tenant-scoped SLOs: shed ratio over ONE tenant's own
    offered/shed counters (published per-tenant by the admission table
    via the overload controller's counter export), so tenant A's error
    budget cannot be consumed by tenant B's flood — the SLO twin of the
    isolation property itself. Instantiated per TPU_TENANT_SLO entry
    using the same grammar as :func:`default_specs`; counter name
    suffixes use the tenant's prometheus-safe slug."""
    from zipkin_tpu_torch.runtime.tenant import tenant_slug

    slug = tenant_slug(tenant)
    kw = dict(short_s=short_s, long_s=long_s, burn_threshold=burn_threshold)
    return [
        SloSpec(f"tenant_{slug}_shed_ratio", "ratio", objective=objective,
                bad=f"tenantShed_{slug}", total=f"tenantOffered_{slug}",
                **kw),
    ]


class SloWatchdog:
    """Evaluates specs against a :class:`WindowedTelemetry` plane."""

    def __init__(self, windows: WindowedTelemetry,
                 specs: Optional[Sequence[SloSpec]] = None,
                 subscribe: bool = True) -> None:
        self._win = windows
        self.specs: List[SloSpec] = list(specs if specs is not None
                                         else default_specs())
        self._lock = threading.Lock()
        self._alerts: Dict[str, bool] = {s.name: False for s in self.specs}
        self._verdicts: List[Dict] = []
        self.trips = 0
        self.clears = 0
        # on_trip(name, verdict) hooks fire once per alert transition
        # into the tripped state — incident capture registers here.
        self.on_trip: List = []
        if subscribe:
            windows.on_tick(lambda _w: self.evaluate())

    def add_spec(self, spec: SloSpec) -> None:
        """Register one more spec after construction (tenant-scoped
        instances). Idempotent by name — re-adding an
        existing spec is a no-op, so wiring code can be re-entered."""
        with self._lock:
            if any(s.name == spec.name for s in self.specs):
                return
            self.specs.append(spec)
            self._alerts.setdefault(spec.name, False)

    # -- burn math -----------------------------------------------------

    @staticmethod
    def _bad_fraction_latency(spec: SloSpec, w: WindowStats) -> tuple:
        stat = w.stage(spec.stage)
        if stat.count <= 0:
            return 0.0, 0
        bad = sum(c for b, c in enumerate(stat.buckets)
                  if c and bucket_le_us(b) > spec.threshold_us)
        return bad / stat.count, stat.count

    @staticmethod
    def _bad_fraction_ratio(spec: SloSpec, w: WindowStats) -> tuple:
        deltas = w.counter_deltas
        bad = max(0.0, deltas.get(spec.bad, 0.0))
        if spec.total:
            total = max(0.0, deltas.get(spec.total, 0.0))
        else:
            total = bad + max(0.0, deltas.get(spec.good, 0.0))
        if total <= 0:
            return 0.0, 0
        return min(1.0, bad / total), int(total)

    def _burn(self, spec: SloSpec, w: WindowStats) -> Dict:
        if spec.kind == "gauge":
            value = self._win.current_counters().get(spec.gauge, 0.0)
            return {"burn": value / spec.limit, "events": 1,
                    "value": value}
        if spec.kind == "latency":
            frac, events = self._bad_fraction_latency(spec, w)
        else:
            frac, events = self._bad_fraction_ratio(spec, w)
        budget = max(1e-9, 1.0 - spec.objective)
        return {"burn": frac / budget, "events": events,
                "badFraction": round(frac, 6)}

    # -- evaluation ----------------------------------------------------

    def evaluate(self) -> List[Dict]:
        """Evaluate every spec; returns (and caches) the verdict list."""
        verdicts: List[Dict] = []
        tripped: List[int] = []  # verdict indexes that transitioned
        with self._lock:
            for spec in self.specs:
                short = self._burn(spec, self._win.window(spec.short_s))
                long_ = self._burn(spec, self._win.window(spec.long_s))
                thr = 1.0 if spec.kind == "gauge" else spec.burn_threshold
                burning = short["burn"] >= thr and long_["burn"] >= thr
                calm = short["burn"] < thr and long_["burn"] < thr
                was = self._alerts[spec.name]
                now = burning or (was and not calm)
                if now and not was:
                    self.trips += 1
                    tripped.append(len(verdicts))
                elif was and not now:
                    self.clears += 1
                self._alerts[spec.name] = now
                verdicts.append({
                    "name": spec.name,
                    "kind": spec.kind,
                    "alert": now,
                    "burnThreshold": thr,
                    "objective": spec.objective,
                    "windows": {
                        f"{int(spec.short_s)}s": {
                            **short, "burn": round(short["burn"], 4)},
                        f"{int(spec.long_s)}s": {
                            **long_, "burn": round(long_["burn"], 4)},
                    },
                })
            self._verdicts = verdicts
        # Hooks run outside the lock: capture sources read back into the
        # watchdog (status()) and must not deadlock.
        for i in tripped:
            v = verdicts[i]
            for cb in list(self.on_trip):
                try:
                    cb(v["name"], v)
                except Exception:
                    pass
        return verdicts

    def verdicts(self) -> List[Dict]:
        """Latest cached verdicts (evaluates once if never run)."""
        with self._lock:
            cached = list(self._verdicts)
        if cached:
            return cached
        return self.evaluate()

    def alerts(self) -> Dict[str, bool]:
        with self._lock:
            return dict(self._alerts)

    @property
    def alerting(self) -> bool:
        with self._lock:
            return any(self._alerts.values())

    def status(self) -> Dict:
        """Full dict for the ``/statusz`` slo section."""
        return {
            "specs": self.verdicts(),
            "alerting": self.alerting,
            "trips": self.trips,
            "clears": self.clears,
        }

"""Overload control plane: the brownout ladder over the signal floor (the
port's copy of ``zipkin_tpu/runtime/overload.py``; names, counters, status
keys, defaults and arithmetic are the reference's, so a controller of
either package fed the same ticks takes the same steps).

- **Load index**: each telemetry tick folds the published signals into one
  scalar. Each signal is divided by its design limit (the SLO specs'
  limits); the fold is a MAX (overload is a bottleneck property), and the
  result is EMA-smoothed so one noisy tick cannot flap the ladder.
- **Brownout ladder** B0-B3, hysteretic: stepping up is immediate and may
  jump levels; stepping down is one level per ``dwell_ticks`` and only
  below the level's enter threshold less ``exit_margin``.

  - **B0** normal operation.
  - **B1** sheds self-spans and slowest-chunk timelines and serves reads
    cache-first within ``max_stale_ms``.
  - **B2** adds admission by value class: error-carrying payloads always
    admit, bulk admits with a probability that falls from 1 at the B2
    threshold to ``min_bulk_admit`` at B3's (a fractional credit, so the
    admit rate tracks the target exactly); each bulk shed nudges the
    sampling ``RateController``'s pressure hook.
  - **B3** serves cached-only reads and admits the error class only. A
    shed is an explicit 429 with backoff guidance, never a silent 2xx.

- **Backoff guidance** carries a scope: a global shed's delay grows with
  the load index (jittered +-30%); a tenant shed's is that tenant's own
  bucket deficit (:mod:`zipkin_tpu_torch.runtime.tenant`).
- **Tenant fold**: with a :class:`TenantAdmission` attached, :meth:`admit`
  consults the tenant's budget first, so a flooding tenant sheds alone
  while the global ladder stays where the aggregate signals put it.

The server wires the controller with one ``windows.on_tick`` subscription;
tests drive :meth:`OverloadController.evaluate` with synthetic counters.
The module imports neither torch nor numpy (the collector and the spawn
paths import it): the default HBM gauge is the port's
``obs.device.hbm_stats`` (allocator bytes over ``mem_get_info``'s total),
read only when torch is already loaded.
"""


from __future__ import annotations

import collections
import random
import threading
import time
from typing import Callable, Dict, List, Optional

B0, B1, B2, B3 = 0, 1, 2, 3
LEVEL_NAMES = ("B0", "B1", "B2", "B3")

# value classes for admission accounting; "error" is the essential
# class (B3 still admits it), everything unclassified is "bulk"
CLASS_ERROR = "error"
CLASS_BULK = "bulk"

# cheap value-class probe: Zipkin JSON/proto error spans carry the
# literal tag key "error" in their serialized bytes; a substring scan
# is one C-level memmem pass over a payload we have not parsed yet —
# the boundary cannot afford a parse just to decide admission. It
# over-matches (any "error" annotation text), which errs on the side
# of admitting: acceptable for a shed heuristic, fatal the other way.
_ERROR_PROBE = b"error"


def _default_hbm_stats() -> Dict:
    """The card's memory gauge (``obs.device.hbm_stats``) once torch is
    loaded; ``{}`` before, so this module never imports torch itself."""
    import sys

    if "torch" not in sys.modules:
        return {}
    from zipkin_tpu_torch.obs.device import hbm_stats

    return hbm_stats()


class OverloadController:
    """Folds published signals into a hysteretic brownout ladder."""

    def __init__(
        self,
        *,
        short_s: float = 10.0,
        enter: tuple = (0.70, 0.85, 0.95),
        exit_margin: float = 0.10,
        dwell_ticks: int = 5,
        ema_alpha: float = 0.5,
        min_bulk_admit: float = 0.05,
        max_stale_ms: int = 5000,
        retry_base_s: float = 0.25,
        retry_cap_s: float = 30.0,
        rate_controller=None,
        history: int = 64,
        seed: Optional[int] = None,
        clock: Callable[[], float] = time.monotonic,
        # per-signal design limits: gauge value / limit = pressure 1.0
        queue_saturation_limit: float = 0.9,
        occupancy_limit: float = 0.95,
        wire_to_ack_p99_limit_us: int = 250_000,
        wal_fsync_p99_limit_us: int = 100_000,
        query_wall_p99_limit_us: int = 50_000,
        lock_waiters_limit: float = 4.0,
        snapshot_age_limit_s: float = 1800.0,
        hbm_limit_frac: float = 0.92,
        hbm_stats: Optional[Callable[[], Dict]] = None,
    ) -> None:
        if not (len(enter) == 3 and enter[0] < enter[1] < enter[2]):
            raise ValueError("enter thresholds must be 3 ascending values")
        self.short_s = float(short_s)
        self.enter = tuple(float(x) for x in enter)
        self.exit_margin = float(exit_margin)
        self.dwell_ticks = max(1, int(dwell_ticks))
        self.ema_alpha = min(1.0, max(0.01, float(ema_alpha)))
        self.min_bulk_admit = min(1.0, max(0.0, float(min_bulk_admit)))
        self.max_stale_ms = int(max_stale_ms)
        self.retry_base_s = float(retry_base_s)
        self.retry_cap_s = float(retry_cap_s)
        self.rate_controller = rate_controller
        # per-tenant budget table (runtime/tenant.py); admit() consults
        # it first so a flooding tenant sheds alone while the global
        # ladder stays wherever the aggregate signals put it
        self.tenant_admission = None
        self._clock = clock
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._level = B0
        self._load = 0.0
        self._raw_load = 0.0
        self._signals: Dict[str, float] = {}
        self._top_signal = ""
        self._ticks_at_level = 0
        self._limits = dict(
            queue_saturation=queue_saturation_limit,
            occupancy=occupancy_limit,
            wire_to_ack_p99_us=float(wire_to_ack_p99_limit_us),
            wal_fsync_p99_us=float(wal_fsync_p99_limit_us),
            query_wall_p99_us=float(query_wall_p99_limit_us),
            lock_waiters=lock_waiters_limit,
            snapshot_age_s=snapshot_age_limit_s,
            hbm=hbm_limit_frac,
        )
        self._hbm_stats = hbm_stats if hbm_stats is not None else _default_hbm_stats
        # admission state: fractional-credit scheduler so a p of 0.25
        # admits exactly every 4th bulk payload instead of relying on a
        # coin flip to average out over a short flood
        self._bulk_credit = 0.0
        # counters (monotonic; merged into the /metrics gauge export)
        self.transitions = 0
        self.admitted_total = 0
        self.admitted_essential = 0
        self.shed_bulk = 0
        self.shed_total = 0
        self.shed_tenant = 0
        self.deadline_expired = 0
        self.ticks = 0
        self.history: collections.deque = collections.deque(maxlen=history)
        # on_transition(event_dict) fires once per level change, outside
        # the controller lock — the incident recorder registers here
        self.on_transition: List[Callable[[Dict], None]] = []

    # -- signal fold ---------------------------------------------------

    def on_tick(self, win) -> None:
        """``WindowedTelemetry.on_tick`` subscriber: sample the signal
        set from the windowed plane and advance the ladder."""
        counters = win.current_counters()
        w = win.window(self.short_s)
        p99 = {}
        for stage in ("wire_to_ack", "wal_fsync", "query_wall"):
            try:
                stat = w.stage(stage)
                p99[stage] = float(stat.p99_us) if stat.count else 0.0
            except KeyError:
                p99[stage] = 0.0
        self.evaluate(counters, p99)

    def evaluate(self, counters: Dict[str, float],
                 p99_us: Optional[Dict[str, float]] = None) -> int:
        """One control step from explicit inputs (the testable core).
        Returns the post-step level."""
        p99_us = p99_us or {}
        lim = self._limits
        signals = {
            "queue_saturation":
                float(counters.get("critpathQueueSaturation", 0.0))
                / lim["queue_saturation"],
            "occupancy":
                float(counters.get("critpathWorkerOccupancy", 0.0))
                / lim["occupancy"],
            "wire_to_ack_p99":
                p99_us.get("wire_to_ack", 0.0) / lim["wire_to_ack_p99_us"],
            "wal_fsync_p99":
                p99_us.get("wal_fsync", 0.0) / lim["wal_fsync_p99_us"],
            "query_wall_p99":
                p99_us.get("query_wall", 0.0) / lim["query_wall_p99_us"],
            "lock_waiters":
                float(counters.get("queryLockWaiters", 0.0))
                / lim["lock_waiters"],
            "snapshot_age":
                float(counters.get("snapshotAgeS", 0.0))
                / lim["snapshot_age_s"],
        }
        hbm = None
        try:
            hbm = self._hbm_stats()
        except Exception:
            hbm = None
        if hbm and hbm.get("bytesLimit"):
            signals["hbm"] = (
                hbm["bytesInUse"] / hbm["bytesLimit"] / lim["hbm"]
            )
        raw = max(signals.values()) if signals else 0.0
        top = max(signals, key=signals.get) if signals else ""
        with self._lock:
            self.ticks += 1
            self._raw_load = raw
            self._signals = signals
            self._top_signal = top
            self._load = (
                self.ema_alpha * raw + (1.0 - self.ema_alpha) * self._load
            )
            event = self._step_locked()
        ta = self.tenant_admission
        if ta is not None:
            try:
                ta.tick()
            except Exception:
                pass
        if event is not None:
            for cb in list(self.on_transition):
                try:
                    cb(event)
                except Exception:
                    pass
        return self._level

    def _step_locked(self) -> Optional[Dict]:
        """Advance the ladder one tick. UP is immediate (jumps to the
        highest entered level); DOWN is one level per dwell window and
        only once the load has cleared the level's exit threshold
        (enter - exit_margin) — classic hysteresis so the ladder cannot
        flap around a threshold."""
        load = self._load
        target_up = B0
        for i, thr in enumerate(self.enter):
            if load >= thr:
                target_up = i + 1
        new = self._level
        if target_up > self._level:
            new = target_up
        else:
            self._ticks_at_level += 1
            if self._level > B0 and self._ticks_at_level >= self.dwell_ticks:
                exit_thr = self.enter[self._level - 1] - self.exit_margin
                if load < exit_thr:
                    new = self._level - 1
        if new == self._level:
            return None
        event = {
            "at": time.time(),
            "mono": self._clock(),
            "from": LEVEL_NAMES[self._level],
            "to": LEVEL_NAMES[new],
            "fromLevel": self._level,
            "toLevel": new,
            "loadIndex": round(load, 4),
            "topSignal": self._top_signal,
            "signals": {k: round(v, 4) for k, v in self._signals.items()},
        }
        self._level = new
        self._ticks_at_level = 0
        self.transitions += 1
        self.history.append(event)
        return event

    # -- read side -----------------------------------------------------

    @property
    def level(self) -> int:
        return self._level

    @property
    def level_name(self) -> str:
        return LEVEL_NAMES[self._level]

    @property
    def load_index(self) -> float:
        return self._load

    def shed_observability(self) -> bool:
        """B1+: skip self-span emission and slowest-chunk timeline
        capture — the observability the observer can live without."""
        return self._level >= B1

    def read_mode(self) -> str:
        """``normal`` | ``cache_first`` | ``cache_only``. Cache-first
        serves a cached result within ``max_stale_ms`` before touching
        the device plane; cache-only (B3) never touches it."""
        if self._level >= B3:
            return "cache_only"
        if self._level >= B1:
            return "cache_first"
        return "normal"

    # -- admission -----------------------------------------------------

    @staticmethod
    def classify(data: bytes) -> str:
        """Cheap value-class probe over unparsed payload bytes."""
        return CLASS_ERROR if _ERROR_PROBE in data else CLASS_BULK

    def admit(self, data: bytes = b"", tenant: Optional[str] = None,
              value_class: Optional[str] = None):
        """Tenant-aware admission chokepoint: classify once, consult
        the tenant's own budget first (scope ``tenant`` — everyone else
        is unaffected), then the global brownout ladder (scope
        ``global``). Returns an :class:`AdmitVerdict` carrying the
        scope and per-scope Retry-After guidance, so the boundary can
        tell a limited tenant apart from a browning-out system.
        """
        # zt-tenant-admission: single chokepoint every boundary-
        # reachable ingest path must traverse before device dispatch
        from zipkin_tpu_torch.runtime.tenant import DEFAULT_TENANT, AdmitVerdict

        t = tenant if tenant else DEFAULT_TENANT
        ta = self.tenant_admission
        cls = value_class
        if cls is None:
            # classify only when someone will act on the class — the
            # substring probe is cheap but not free at B0 line rate.
            # An accounting-only tenant table (no byte budget, no
            # retained table) can never shed, so it does not count.
            ta_can_shed = (
                ta is not None and ta.enabled
                and (ta.bytes_per_s > 0 or ta.retained_table is not None)
            )
            if ta_can_shed or self._level >= B2:
                cls = self.classify(data)
            else:
                cls = CLASS_BULK
        if ta is not None and ta.enabled:
            ok, retry = ta.admit(t, len(data), cls)
            if not ok:
                with self._lock:
                    self.shed_tenant += 1
                rc = self.rate_controller
                if rc is not None:
                    try:
                        rc.note_pressure()
                    except Exception:
                        pass
                return AdmitVerdict(False, cls, "tenant", t, retry)
        admitted, cls = self.admit_ingest(data, value_class=cls)
        if not admitted:
            return AdmitVerdict(False, cls, "global", t,
                                self.retry_after_s())
        return AdmitVerdict(True, cls, "none", t, 0.0)

    def admit_ingest(self, data: bytes = b"",
                     value_class: Optional[str] = None) -> tuple:
        """GLOBAL-ladder admission verdict for one ingest payload:
        ``(admitted, value_class)``. B0/B1 admit everything; B2 always
        admits the error class and sheds bulk probabilistically
        (fractional-credit, so the admit rate tracks the target
        exactly); B3 admits the error class only. Every bulk shed
        nudges the sampling controller's pressure hook. Tenant-scoped
        budgets do NOT apply here — the boundary goes through
        :meth:`admit`, which folds them in first."""
        cls = value_class if value_class is not None else (
            self.classify(data) if self._level >= B2 else CLASS_BULK
        )
        level = self._level
        if level < B2:
            with self._lock:
                self.admitted_total += 1
            return True, cls
        if cls == CLASS_ERROR:
            with self._lock:
                self.admitted_total += 1
                self.admitted_essential += 1
            return True, cls
        if level >= B3:
            self._note_shed()
            return False, cls
        p = self._bulk_admit_p()
        with self._lock:
            self._bulk_credit += p
            if self._bulk_credit >= 1.0:
                self._bulk_credit -= 1.0
                self.admitted_total += 1
                return True, cls
        self._note_shed()
        return False, cls

    def _bulk_admit_p(self) -> float:
        """Bulk admit probability in B2: 1.0 at the B2 threshold,
        falling linearly to ``min_bulk_admit`` at the B3 threshold."""
        lo, hi = self.enter[1], self.enter[2]
        frac = (self._load - lo) / max(1e-9, hi - lo)
        return max(self.min_bulk_admit, 1.0 - min(1.0, max(0.0, frac)))

    def _note_shed(self) -> None:
        with self._lock:
            self.shed_total += 1
            self.shed_bulk += 1
        rc = self.rate_controller
        if rc is not None:
            try:
                rc.note_pressure()
            except Exception:
                pass

    def note_deadline_expired(self, n: int = 1) -> None:
        """Server boundary dropped work already past its deadline."""
        with self._lock:
            self.deadline_expired += n

    # -- backoff guidance ----------------------------------------------

    def retry_after_s(self, tenant: Optional[str] = None) -> float:
        """Shed backoff. With a ``tenant`` and an attached tenant
        table, guidance is that tenant's own bucket-refill horizon —
        its load, not global load. Otherwise (global sheds) it grows
        with the load index, jittered ±30% so a synchronized client
        fleet decorrelates its retries instead of re-flooding on one
        boundary."""
        ta = self.tenant_admission
        if tenant is not None and ta is not None and ta.enabled:
            try:
                return ta.retry_after_s(tenant)
            except Exception:
                pass
        base = self.retry_base_s * (
            1.0 + 4.0 * min(2.0, max(0.0, self._load))
            + 2.0 * self._level
        )
        jitter = 0.7 + 0.6 * self._rng.random()
        return min(self.retry_cap_s, max(0.05, base * jitter))

    # -- export --------------------------------------------------------

    def counters(self) -> Dict[str, float]:
        """Scalar gauges for the /metrics merge."""
        out = {
            "overloadLevel": self._level,
            "overloadLoadIndex": round(self._load, 4),
            "overloadRawLoadIndex": round(self._raw_load, 4),
            "overloadTransitions": self.transitions,
            "overloadAdmitted": self.admitted_total,
            "overloadAdmittedEssential": self.admitted_essential,
            "overloadShedBulk": self.shed_bulk,
            "overloadShedTotal": self.shed_total,
            "overloadShedTenant": self.shed_tenant,
            "overloadObsShed": int(self.shed_observability()),
            "deadlineExpired": self.deadline_expired,
        }
        ta = self.tenant_admission
        if ta is not None:
            try:
                out.update(ta.counters())
            except Exception:
                pass
        return out

    def status(self) -> Dict:
        """Full dict for the statusz ``overload`` section."""
        ta = self.tenant_admission
        tenants = None
        if ta is not None:
            try:
                tenants = ta.status()
            except Exception:
                tenants = None
        with self._lock:
            return {
                "tenants": tenants,
                "level": self._level,
                "levelName": LEVEL_NAMES[self._level],
                "loadIndex": round(self._load, 4),
                "rawLoadIndex": round(self._raw_load, 4),
                "topSignal": self._top_signal,
                "signals": {k: round(v, 4)
                            for k, v in self._signals.items()},
                "readMode": self.read_mode(),
                "maxStaleMs": self.max_stale_ms,
                "bulkAdmitP": round(self._bulk_admit_p(), 4)
                if self._level >= B2 else 1.0,
                "enterThresholds": list(self.enter),
                "exitMargin": self.exit_margin,
                "dwellTicks": self.dwell_ticks,
                "ticks": self.ticks,
                "counters": {
                    "admitted": self.admitted_total,
                    "admittedEssential": self.admitted_essential,
                    "shedBulk": self.shed_bulk,
                    "shedTotal": self.shed_total,
                    "shedTenant": self.shed_tenant,
                    "deadlineExpired": self.deadline_expired,
                    "transitions": self.transitions,
                },
                "history": list(self.history),
            }

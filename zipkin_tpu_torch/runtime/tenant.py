"""Tenant admission: per-tenant identity, budgets and flood containment
(the port's copy of ``zipkin_tpu/runtime/tenant.py``; names, counters,
status keys and defaults are the reference's).

The tenant id enters at the transport boundary, the ``X-Tenant-Id`` HTTP
header, and rides a contextvar (:data:`CURRENT_TENANT`) into the
collector's admission chokepoint. The port's server runs each request on
an ``http.server`` thread, so the handler sets the contextvar on that
thread before the collector runs and resets it after. Traffic with no
header lands on :data:`DEFAULT_TENANT`, so a single-tenant deployment
behaves as before.

:class:`TenantAdmission` is the budget side of the overload plane
(:mod:`zipkin_tpu_torch.runtime.overload`): where the global ladder folds
aggregate signals, this table holds one token bucket a tenant over ingest
bytes/s plus a demand/budget pressure EMA, and drives only the flooding
tenant to B2/B3-style admission while every other tenant stays B0. A shed
here has scope ``"tenant"``, with a retry delay from that tenant's own
bucket deficit.

The table is a bounded LRU: a stream of unique tenant ids evicts the
oldest entry (never the default tenant) and counts the eviction. The
module imports neither torch nor numpy.
"""


from __future__ import annotations

import contextvars
import re
import threading
import time
from collections import OrderedDict
from typing import Dict, NamedTuple, Optional

DEFAULT_TENANT = "default"
TENANT_HEADER = "X-Tenant-Id"
TENANT_METADATA_KEY = "x-tenant-id"

# Boundary handlers set this on the request's thread; the collector
# chokepoint reads it on the same thread. Nothing carries it across to
# another thread: the fan-out tier takes the tenant as an argument.
CURRENT_TENANT: contextvars.ContextVar[str] = contextvars.ContextVar(
    "zipkin_tpu_tenant", default=DEFAULT_TENANT
)

_TENANT_RE = re.compile(r"^[A-Za-z0-9._-]{1,64}$")


def normalize_tenant(raw: Optional[str]) -> str:
    """Map a wire-supplied tenant id onto the bounded id alphabet.

    Empty, missing, over-long, or hostile ids (label-breaking quotes,
    control bytes, path separators) collapse to the default tenant
    rather than erroring: tenancy must never turn a legacy client's
    traffic into 4xx noise.
    """
    if not raw:
        return DEFAULT_TENANT
    s = str(raw).strip()
    if not s or not _TENANT_RE.match(s):
        return DEFAULT_TENANT
    return s


def tenant_slug(tenant: str) -> str:
    """Flat-counter-safe slug (``tenantShed_<slug>`` etc.)."""
    return re.sub(r"[^A-Za-z0-9_]", "_", tenant)


class AdmitVerdict(NamedTuple):
    """Rich admission verdict from ``OverloadController.admit``.

    ``scope`` says who is shedding: ``"tenant"`` — this tenant's budget
    (everyone else is fine), ``"global"`` — the brownout ladder (the
    system is degrading), ``"none"`` — admitted.
    """

    admitted: bool
    cls: str
    scope: str
    tenant: str
    retry_after_s: float


class _TenantState:
    """Per-tenant bucket + ladder posture. Mutated under the table lock."""

    __slots__ = (
        "tokens", "last_refill", "level", "calm_ticks", "pressure",
        "offered", "offered_bytes", "admitted", "shed",
        "retained_spans", "retained_shed",
    )

    def __init__(self, now: float, burst_bytes: float) -> None:
        self.tokens = burst_bytes
        self.last_refill = now
        self.level = 0          # 0=B0 admit, 2=B2 bulk-shed, 3=B3 essential
        self.calm_ticks = 0
        self.pressure = 0.0     # EMA of offered-rate / budget-rate
        self.offered = 0
        self.offered_bytes = 0
        self.admitted = 0
        self.shed = 0
        self.retained_spans = 0
        self.retained_shed = 0


class TenantAdmission:
    """Bounded-LRU table of per-tenant ingest budgets.

    ``bytes_per_s <= 0`` means accounting-only: every tenant is
    admitted, but offered/admitted tallies, the pressure EMA, and the
    ``{tenant=}`` observability families still populate. With a budget
    set, each tenant gets a token bucket of ``bytes_per_s`` with
    ``burst_s`` seconds of burst; a payload that cannot be paid for is
    shed with scope ``"tenant"`` unless it is error-class (error
    payloads keep the same lifeline the global ladder's B3 grants).

    The per-tenant ladder is demand-driven: sustained demand at
    ``flood_ratio``x budget escalates the tenant to level 2 (bulk
    shed), 2x that to level 3 (essential-only); ``dwell_ticks`` calm
    ticks (no sheds, bucket refilled) step back down one level at a
    time — the same enter-fast/exit-slow hysteresis the global ladder
    uses, scoped to one tenant.
    """

    def __init__(
        self,
        *,
        bytes_per_s: float = 0.0,
        burst_s: float = 2.0,
        max_tenants: int = 64,
        flood_ratio: float = 2.0,
        dwell_ticks: int = 3,
        ema_alpha: float = 0.5,
        clock=time.monotonic,
        retained_table=None,
    ) -> None:
        self.bytes_per_s = float(bytes_per_s)
        self.burst_s = float(burst_s)
        self.max_tenants = max(1, int(max_tenants))
        self.flood_ratio = max(1.0, float(flood_ratio))
        self.dwell_ticks = max(1, int(dwell_ticks))
        self.ema_alpha = float(ema_alpha)
        self.clock = clock
        # Optional sampling-tier coupling: retained-spans/sec budgets
        # live in the RateController's TenantBudgetTable; admission
        # consults its over-budget verdict so a tenant that floods the
        # *retention* budget is bulk-shed at the boundary too.
        self.retained_table = retained_table
        self.enabled = True
        self.evictions = 0
        self._lock = threading.Lock()
        self._tenants: "OrderedDict[str, _TenantState]" = OrderedDict()
        # Demand accounting for the tick-driven pressure EMA.
        self._tick_t = float(clock())

    # -- internals -----------------------------------------------------

    @property
    def burst_bytes(self) -> float:
        if self.bytes_per_s <= 0:
            return 0.0
        return self.bytes_per_s * self.burst_s

    def _state(self, tenant: str, now: float) -> _TenantState:
        st = self._tenants.get(tenant)
        if st is not None:
            self._tenants.move_to_end(tenant)
            return st
        while len(self._tenants) >= self.max_tenants:
            # Evict the least-recently-offered tenant — but never the
            # default tenant, which anchors all legacy traffic.
            for victim in self._tenants:
                if victim != DEFAULT_TENANT:
                    break
            else:
                break
            del self._tenants[victim]
            self.evictions += 1
        st = _TenantState(now, self.burst_bytes)
        self._tenants[tenant] = st
        return st

    def _refill(self, st: _TenantState, now: float) -> None:
        if self.bytes_per_s <= 0:
            return
        dt = max(0.0, now - st.last_refill)
        st.last_refill = now
        st.tokens = min(self.burst_bytes,
                        st.tokens + dt * self.bytes_per_s)

    # -- admission -----------------------------------------------------

    def admit(self, tenant: str, n_bytes: int,
              cls: str = "bulk") -> tuple:
        """Charge ``tenant``'s bucket for ``n_bytes``; returns
        ``(admitted, retry_after_s)``. ``retry_after_s`` is 0.0 on
        admit, else this tenant's own refill horizon.
        """
        now = float(self.clock())
        with self._lock:
            st = self._state(tenant, now)
            st.offered += 1
            st.offered_bytes += int(n_bytes)
            if not self.enabled:
                st.admitted += 1
                return True, 0.0
            self._refill(st, now)
            over_retained = bool(
                self.retained_table is not None
                and self.retained_table.over_budget(tenant)
            )
            if cls == "error" and st.level < 3:
                # Error-class lifeline: mirrors global B3 semantics —
                # the signal about the outage rides through even when
                # the flooder's bucket is dry.
                st.admitted += 1
                if self.bytes_per_s > 0:
                    st.tokens = max(0.0, st.tokens - n_bytes)
                return True, 0.0
            if self.bytes_per_s > 0 and st.tokens < n_bytes:
                st.shed += 1
                if st.level < 2:
                    st.level = 2
                st.calm_ticks = 0
                return False, self._retry_locked(st, n_bytes)
            if over_retained and cls != "error":
                st.retained_shed += 1
                st.shed += 1
                if st.level < 2:
                    st.level = 2
                st.calm_ticks = 0
                return False, self._retry_locked(st, n_bytes)
            if st.level >= 3 and cls != "error":
                st.shed += 1
                st.calm_ticks = 0
                return False, self._retry_locked(st, n_bytes)
            st.admitted += 1
            if self.bytes_per_s > 0:
                st.tokens -= n_bytes
            return True, 0.0

    def note_retained(self, tenant: str, n_spans: int) -> None:
        """Dispatcher-side retained-spans accounting (thread-safe —
        called from the dispatcher thread at ack time). Forwards to the
        sampling tier's per-tenant budget table when one is attached.
        """
        now = float(self.clock())
        with self._lock:
            st = self._state(tenant, now)
            st.retained_spans += int(n_spans)
        rt = self.retained_table
        if rt is not None:
            rt.charge(tenant, n_spans)

    def retry_after_s(self, tenant: str, n_bytes: int = 0) -> float:
        """Per-tenant backoff guidance: this tenant's bucket-refill
        horizon scaled by its ladder level — NOT global load."""
        now = float(self.clock())
        with self._lock:
            st = self._tenants.get(tenant)
            if st is None:
                return 0.05
            self._refill(st, now)
            return self._retry_locked(st, n_bytes)

    def _retry_locked(self, st: _TenantState, n_bytes: int) -> float:
        if self.bytes_per_s > 0:
            deficit = max(0.0, float(n_bytes) - st.tokens)
            base = deficit / self.bytes_per_s if deficit else 0.05
        else:
            base = 0.05
        out = base * (1.0 + st.level)
        return min(30.0, max(0.05, out))

    # -- ladder tick ---------------------------------------------------

    def tick(self, dt_s: float = 1.0) -> None:
        """Demand-pressure EMA + exit hysteresis; call once per
        controller evaluation tick."""
        now = float(self.clock())
        dt = max(1e-6, float(dt_s))
        with self._lock:
            for st in self._tenants.values():
                offered_rate = st.offered_bytes / dt
                st.offered_bytes = 0
                if self.bytes_per_s > 0:
                    ratio = offered_rate / self.bytes_per_s
                else:
                    ratio = 0.0
                a = self.ema_alpha
                st.pressure = (1 - a) * st.pressure + a * ratio
                self._refill(st, now)
                # Enter fast: sustained demand at 2x the flood ratio is
                # an active flood — go essential-only for this tenant.
                if st.pressure >= 2.0 * self.flood_ratio:
                    st.level = 3
                    st.calm_ticks = 0
                    continue
                # Exit slow: one level per dwell of calm ticks, and
                # only once the bucket has refilled past half burst.
                refilled = (self.bytes_per_s <= 0
                            or st.tokens >= 0.5 * self.burst_bytes)
                if st.level > 0 and st.pressure < 1.0 and refilled:
                    st.calm_ticks += 1
                    if st.calm_ticks >= self.dwell_ticks:
                        st.level = 2 if st.level > 2 else 0
                        st.calm_ticks = 0
                else:
                    st.calm_ticks = 0

    # -- observability -------------------------------------------------

    def level_of(self, tenant: str) -> int:
        with self._lock:
            st = self._tenants.get(tenant)
            return st.level if st is not None else 0

    def counters(self) -> Dict[str, float]:
        """Flat counters for the windowed plane / metrics merge: global
        tallies plus ``tenantOffered_<slug>`` / ``tenantShed_<slug>``
        per live tenant (bounded by the LRU cap)."""
        with self._lock:
            out: Dict[str, float] = {
                "tenantTableSize": len(self._tenants),
                "tenantEvictions": self.evictions,
                "tenantShedTotal": sum(
                    st.shed for st in self._tenants.values()
                ),
                "tenantAdmittedTotal": sum(
                    st.admitted for st in self._tenants.values()
                ),
            }
            for name, st in self._tenants.items():
                slug = tenant_slug(name)
                out[f"tenantOffered_{slug}"] = st.offered
                out[f"tenantAdmitted_{slug}"] = st.admitted
                out[f"tenantShed_{slug}"] = st.shed
                out[f"tenantLevel_{slug}"] = st.level
            return out

    def status(self) -> Dict:
        """Nested dict for ``/statusz`` and the prometheus render."""
        now = float(self.clock())
        with self._lock:
            tenants = {}
            for name, st in self._tenants.items():
                self._refill(st, now)
                tenants[name] = {
                    "level": st.level,
                    "pressure": round(st.pressure, 4),
                    "offered": st.offered,
                    "admitted": st.admitted,
                    "shed": st.shed,
                    "retainedSpans": st.retained_spans,
                    "retainedShed": st.retained_shed,
                    "tokens": round(st.tokens, 1),
                }
            return {
                "enabled": self.enabled,
                "budgetBytesPerS": self.bytes_per_s,
                "burstS": self.burst_s,
                "maxTenants": self.max_tenants,
                "floodRatio": self.flood_ratio,
                "evictions": self.evictions,
                "tenants": tenants,
            }

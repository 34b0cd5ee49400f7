"""Adaptive per-service rate controller for the sampling tier (port of
``zipkin_tpu/sampling/controller.py``, numpy only; each tick that
publishes is the flight recorder's ``sampler_tick`` stage).

Closes the loop on a retained-spans/sec budget: each interval it reads
the host-exact seen/kept tallies, nudges every service's hash-keep rate
toward the budget's fair ratio, refreshes the per-key tail thresholds
from the live t-digests, and PUBLISHES the new tables — host reference
and device leaves swapped together under the aggregator lock, with a
sparse ``sctl`` WAL record logged at the same point of the batch stream
so crash-resume replays land the identical tables (and therefore the
identical verdicts) between the same two batches.

The controller itself runs free-floating host float math — determinism
does NOT depend on reproducing its decisions, only on replaying the
TABLES it published, which the sctl records carry exactly.

Under throttle pressure (``note_pressure``: a batch the admission
throttle rejected outright) the next interval tightens the effective
budget, so sustained overload degrades into lower sampling rates — the
graceful mode — instead of more rejections.

Tenant budgets: :class:`TenantBudgetTable` tracks per-tenant
retained-spans/sec token buckets, charged at dispatcher ack time (span
counts are only known post-parse) and consulted by the admission
chokepoint (``runtime/tenant.py``) so a tenant that retains beyond its
budget is shed at the door with tenant-scoped guidance while the GLOBAL
sampling budget — and every other tenant — is untouched. The table is
bounded (LRU, evictions counted) so a hostile tenant-id stream cannot
grow controller state.
"""

from __future__ import annotations

import logging
import math
import threading
import time
from collections import OrderedDict

import numpy as np

from zipkin_tpu_torch import obs
from zipkin_tpu_torch.sampling import RATE_ONE

logger = logging.getLogger(__name__)


class TenantBudgetTable:
    """Per-tenant retained-spans/sec token buckets.

    One bucket per tenant over RETAINED spans — the durable cost a
    tenant imposes downstream of sampling — refilled at
    ``spans_per_s`` with ``spans_per_s * burst_s`` of burst headroom.
    ``charge`` deducts at dispatcher ack time and may drive a bucket
    negative (the spans are already retained; the debt throttles the
    NEXT admission decision); ``over_budget`` is the read-only probe
    the admission chokepoint consults before accepting more bytes from
    that tenant.

    Bounded: at most ``max_tenants`` rows, LRU-evicted (the "default"
    tenant is never evicted — it anchors legacy traffic), evictions
    counted — a hostile tenant-id stream cannot grow controller state.
    ``spans_per_s <= 0`` disables enforcement (``over_budget`` is
    always False) while still tallying per-tenant retained counts.
    """

    def __init__(
        self,
        spans_per_s: float = 0.0,
        burst_s: float = 2.0,
        max_tenants: int = 64,
        clock=time.monotonic,
    ) -> None:
        self.spans_per_s = float(spans_per_s)
        self.burst_s = float(burst_s)
        self.max_tenants = max(1, int(max_tenants))
        self.evictions = 0
        self._clock = clock
        self._lock = threading.Lock()
        # tenant -> [tokens, last_refill, retained_total]
        self._rows: "OrderedDict[str, list]" = OrderedDict()

    @property
    def enabled(self) -> bool:
        return self.spans_per_s > 0.0

    @property
    def burst_spans(self) -> float:
        return self.spans_per_s * self.burst_s

    def _row(self, tenant: str) -> list:
        row = self._rows.get(tenant)
        if row is None:
            while len(self._rows) >= self.max_tenants:
                victim = next(
                    (k for k in self._rows if k != "default"), None
                )
                if victim is None:
                    break
                self._rows.pop(victim)
                self.evictions += 1
            row = [self.burst_spans, self._clock(), 0]
            self._rows[tenant] = row
        else:
            self._rows.move_to_end(tenant)
        return row

    def _refill(self, row: list) -> None:
        now = self._clock()
        dt = now - row[1]
        if dt > 0:
            row[0] = min(self.burst_spans, row[0] + dt * self.spans_per_s)
            row[1] = now

    def charge(self, tenant: str, n_spans: int) -> bool:
        """Deduct ``n_spans`` retained spans from ``tenant``'s bucket;
        returns True while the tenant stays within budget. May drive
        the bucket negative — the debt gates future admission."""
        with self._lock:
            row = self._row(tenant)
            row[2] += int(n_spans)
            if not self.enabled:
                return True
            self._refill(row)
            row[0] -= float(n_spans)
            return row[0] >= 0.0

    def over_budget(self, tenant: str) -> bool:
        """Read-only probe: is this tenant's retained-spans bucket in
        debt right now? Never creates a row."""
        if not self.enabled:
            return False
        with self._lock:
            row = self._rows.get(tenant)
            if row is None:
                return False
            self._refill(row)
            return row[0] < 0.0

    def retained(self, tenant: str) -> int:
        with self._lock:
            row = self._rows.get(tenant)
            return int(row[2]) if row is not None else 0

    def counters(self) -> dict:
        with self._lock:
            return {
                "tenantBudgetTableSize": len(self._rows),
                "tenantBudgetEvictions": self.evictions,
                "tenantRetainedTotal": sum(
                    int(r[2]) for r in self._rows.values()
                ),
            }


class RateController:
    def __init__(
        self,
        store,
        budget_spans_per_sec: float,
        interval_s: float = 5.0,
        min_rate: int = 256,
        tail_quantile: float = 0.99,
        pressure_tighten: float = 0.7,
    ) -> None:
        self.store = store
        self.budget = float(budget_spans_per_sec)
        self.interval_s = float(interval_s)
        self.min_rate = int(min_rate)
        self.tail_quantile = float(tail_quantile)
        self.pressure_tighten = float(pressure_tighten)
        self.publishes = 0
        self.pressure_events = 0
        self._pressure_pending = 0
        self.last_utilization = 0.0
        # optional per-tenant retained-spans budgets; set by
        # server wiring so tenant counters ride this controller's export
        self.tenant_table: "TenantBudgetTable | None" = None
        self._thread = None
        self._stop = threading.Event()

    # -- throttle integration -------------------------------------------

    def note_pressure(self) -> None:
        """Record one admission-throttle rejection: the next tick treats
        the budget as tighter, shifting degradation from rejecting
        batches to sampling harder."""
        self.pressure_events += 1
        self._pressure_pending += 1

    # -- the control step ------------------------------------------------

    def tick(self, dt_s: float) -> bool:
        """One control interval over ``dt_s`` seconds of tallies; returns
        True when new tables were published. Safe to call from a test
        with a synthetic dt — nothing here reads the wall clock."""
        sampler = self.store.agg.sampler
        if sampler is None or dt_s <= 0:
            return False
        t0 = time.perf_counter()
        seen, kept = sampler.take_tallies()
        total_seen = int(seen.sum())
        total_kept = int(kept.sum())
        budget = self.budget
        if self._pressure_pending:
            budget *= self.pressure_tighten ** min(self._pressure_pending, 8)
            self._pressure_pending = 0
        budget_spans = budget * dt_s
        self.last_utilization = (
            total_kept / dt_s / self.budget if self.budget > 0 else 0.0
        )
        rate = sampler.rate.astype(np.float64)
        if total_seen > 0 and budget_spans > 0:
            ratio = min(1.0, budget_spans / total_seen)
            active = seen > 0
            kept_frac = np.maximum(kept / np.maximum(seen, 1), 1e-6)
            # proportional step toward each service keeping ~ratio of its
            # traffic, slew-limited so one noisy interval can't slam the
            # rate; error/tail/rare keeps count against kept_frac, so
            # services whose mandatory keeps already exceed the ratio
            # converge to the min_rate floor rather than oscillating
            factor = np.clip(ratio / kept_frac, 0.25, 4.0)
            rate = np.where(
                active,
                np.clip(rate * factor, self.min_rate, RATE_ONE),
                rate,
            )
        new_rate = np.rint(rate).astype(np.uint32)
        new_tail = self._tail_thresholds(sampler)
        new_link = sampler.link_snapshot()
        self._publish(sampler, new_rate, new_tail, new_link)
        obs.record("sampler_tick", time.perf_counter() - t0)
        return True

    def _tail_thresholds(self, sampler) -> np.ndarray:
        """Per-key u32 tail cut from the live t-digests: keys with
        traffic get ceil(q_tail); silent keys keep the unreachable
        sentinel so the tail clause can never fire for them."""
        q, counts = self.store.agg.quantiles(
            [self.tail_quantile], source="digest"
        )
        tail = sampler.tail.copy()
        have = counts > 0
        thr = np.ceil(np.maximum(q[:, 0], 1.0))
        tail[have] = np.minimum(thr[have], float(0xFFFFFFFF)).astype(np.uint32)
        return tail

    def _publish(self, sampler, rate, tail, link) -> None:
        agg = self.store.agg
        with agg.lock:
            delta = sampler.sctl_delta(rate, tail, link)
            if delta and agg.wal_hook is not None:
                # a zero-lane record at THIS point of the WAL stream:
                # replay applies the delta between the same batches the
                # live run published between, so every replayed verdict
                # reads the same tables the original run did
                empty = np.zeros((agg.n_shards, 11, 0), np.uint32)
                agg.wal_seq = agg.wal_hook(
                    empty, 0, 0, 0, None, extra={"sctl": delta}
                )
            sampler.set_tables(rate, tail, link)
            agg.set_sampler_tables(sampler.rate, sampler.tail, sampler.link)
            self.publishes += 1

    # -- background thread ----------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def loop() -> None:
            last = time.monotonic()
            while not self._stop.wait(self.interval_s):
                now = time.monotonic()
                try:
                    self.tick(now - last)
                except Exception:  # pragma: no cover - keep the loop alive
                    logger.exception("sampling controller tick failed")
                last = now

        self._thread = threading.Thread(
            target=loop, name="sampling-controller", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=self.interval_s + 5)
        self._thread = None

    def counters(self) -> dict:
        """Scalar gauges merged into store.ingest_counters()."""
        out = {
            "samplerPublishes": self.publishes,
            "samplerPressure": self.pressure_events,
            "budgetUtilization": round(self.last_utilization, 6),
        }
        sampler = self.store.agg.sampler
        if sampler is not None:
            r = sampler.rate
            out["samplerRateMin"] = int(r.min()) / RATE_ONE
            out["samplerRateMean"] = float(r.mean()) / RATE_ONE
        if self.tenant_table is not None:
            out.update(self.tenant_table.counters())
        return out

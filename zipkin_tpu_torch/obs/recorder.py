"""Lock-free stage-latency recorder: the pipeline flight recorder core.

Concurrency design (the "Fast Concurrent Data Sketches" split): each
recording thread owns a private ``_LocalHist`` — writers never contend,
never take a lock, never wait. A per-local even/odd ``gen`` counter is
the seqlock: the writer bumps it to odd, mutates its three arrays
(bucket counts, per-stage µs sums, per-stage maxes), and bumps it back
to even. ``snapshot()`` is the compact query side (the SF-sketch-style
export): it copies each local under a gen-stable retry loop — odd or
changed gen means the copy may be torn across the three arrays, so it
re-reads — then merges everything into one immutable ``Snapshot``.
Under CPython the GIL makes each individual list op atomic; the gen
stamp is what makes the *cross-array* view consistent.

Latency buckets are log2 in µs: bucket 0 holds 0 µs, bucket ``b`` holds
``[2^(b-1), 2^b)`` µs, the top bucket is clipped (≈ ≥9 min). Exact
inclusive upper bound of bucket ``b`` is ``(1 << b) - 1`` µs, which is
what the Prometheus ``le`` labels and quantile reads report.

The only work on the record hot path beyond the histogram update is a
single budget comparison; crossing the budget takes the (rare) slow
path: an event dict appended to a bounded ring, plus an optional hook
(installed by ``selfspans.SelfSpanEmitter``) that runs on the recording
thread so it can read request-scoped context vars.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

from zipkin_tpu_torch.obs.stages import (
    DEFAULT_BUDGETS_US,
    NUM_STAGES,
    STAGE_INDEX,
    STAGES,
)

NUM_BUCKETS = 31

# A torn read lasts a few bytecodes; retries beyond this mean a writer
# died mid-update (impossible without a killed thread) — take the read.
_TORN_RETRIES = 1000


def bucket_index(dur_s: float) -> int:
    """Bucket for a duration in seconds (µs resolution, rounded)."""
    us = int(dur_s * 1_000_000 + 0.5)
    if us <= 0:
        return 0
    b = us.bit_length()
    return b if b < NUM_BUCKETS else NUM_BUCKETS - 1


def bucket_le_us(b: int) -> int:
    """Exact inclusive upper bound of bucket ``b`` in µs.

    The top bucket is clipped and has no finite bound; callers export
    it as ``+Inf`` (Prometheus) or fall back to the observed max.
    """
    return (1 << b) - 1


class _LocalHist:
    """One writer thread's private histogram block (seqlock-stamped)."""

    __slots__ = ("gen", "counts", "sums", "maxes")

    def __init__(self) -> None:
        self.gen = 0
        self.counts = [0] * (NUM_STAGES * NUM_BUCKETS)
        self.sums = [0] * NUM_STAGES
        self.maxes = [0] * NUM_STAGES


class StageStat:
    """Merged per-stage view inside a :class:`Snapshot`."""

    __slots__ = ("stage", "count", "sum_us", "max_us", "buckets")

    def __init__(self, stage: str, count: int, sum_us: int, max_us: int,
                 buckets: List[int]) -> None:
        self.stage = stage
        self.count = count
        self.sum_us = sum_us
        self.max_us = max_us
        self.buckets = buckets

    def quantile_us(self, q: float) -> int:
        """Upper-bound estimate of the q-quantile in µs.

        Log2-bucket resolution: the true value lies within 2x below the
        returned bound. The top (clipped) bucket and any bucket whose
        bound exceeds the observed max report the max instead.
        """
        if self.count <= 0:
            return 0
        target = q * self.count
        cum = 0
        for b, c in enumerate(self.buckets):
            cum += c
            if c and cum >= target:
                if b >= NUM_BUCKETS - 1:
                    return self.max_us
                return min(bucket_le_us(b), self.max_us)
        return self.max_us

    @property
    def p50_us(self) -> int:
        return self.quantile_us(0.50)

    @property
    def p99_us(self) -> int:
        return self.quantile_us(0.99)


class Snapshot:
    """Immutable merge of every writer's histograms at one generation."""

    __slots__ = ("counts", "sums", "maxes", "generation", "locals_seen")

    def __init__(self, counts: List[int], sums: List[int], maxes: List[int],
                 generation: int, locals_seen: int) -> None:
        self.counts = counts
        self.sums = sums
        self.maxes = maxes
        self.generation = generation
        self.locals_seen = locals_seen

    def stage(self, name: str) -> StageStat:
        idx = STAGE_INDEX[name]
        buckets = self.counts[idx * NUM_BUCKETS:(idx + 1) * NUM_BUCKETS]
        return StageStat(name, sum(buckets), self.sums[idx],
                         self.maxes[idx], buckets)

    def stages(self) -> List[StageStat]:
        return [self.stage(name) for name in STAGES]

    def nonzero(self) -> List[StageStat]:
        return [s for s in self.stages() if s.count]

    @property
    def total_count(self) -> int:
        return sum(self.counts)


class StageRecorder:
    """Process-wide flight recorder; one instance lives at ``obs.RECORDER``."""

    def __init__(self, enabled: bool = True, slow_ring_size: int = 64) -> None:
        self._enabled = bool(enabled)
        self._tl = threading.local()
        self._reg_lock = threading.Lock()  # registration only — never on record()
        self._locals: List[_LocalHist] = []
        self._budget_scale = 1.0
        self._budgets_us: List[float] = [
            float(DEFAULT_BUDGETS_US[s]) for s in STAGES
        ]
        self._slow_ring: deque = deque(maxlen=slow_ring_size)
        self._slow_hook: Optional[Callable[[Dict], None]] = None

    # -- hot path ------------------------------------------------------

    def record(self, stage: str, dur_s: float) -> None:
        """Record one observation of ``stage`` taking ``dur_s`` seconds.

        Wait-free for the writer: no locks, no allocation beyond the
        first call on a thread, one budget compare at the end.
        """
        if not self._enabled:
            return
        idx = STAGE_INDEX[stage]
        us = int(dur_s * 1_000_000 + 0.5)
        if us < 0:
            us = 0
        b = us.bit_length()
        if b >= NUM_BUCKETS:
            b = NUM_BUCKETS - 1
        try:
            h = self._tl.hist
        except AttributeError:
            h = self._new_local()
        h.gen += 1  # odd: local mid-update
        h.counts[idx * NUM_BUCKETS + b] += 1
        h.sums[idx] += us
        if us > h.maxes[idx]:
            h.maxes[idx] = us
        h.gen += 1  # even: stable again
        if us > self._budgets_us[idx]:
            self._slow(stage, us, self._budgets_us[idx])

    def record_relayed(self, stage: str, dur_s: float) -> None:
        """Record a stage wall that was *measured on another thread or
        process* and relayed here (e.g. worker parse/pack/route timings
        riding MP batch messages). Histogram-only: no budget compare, no
        slow ring, no self-span hook — the recording thread's request
        context has nothing to do with where the time was spent, so a
        budget crossing must not emit a self-span B3-linked to it."""
        if not self._enabled:
            return
        idx = STAGE_INDEX[stage]
        us = int(dur_s * 1_000_000 + 0.5)
        if us < 0:
            us = 0
        b = us.bit_length()
        if b >= NUM_BUCKETS:
            b = NUM_BUCKETS - 1
        try:
            h = self._tl.hist
        except AttributeError:
            h = self._new_local()
        h.gen += 1  # odd: local mid-update
        h.counts[idx * NUM_BUCKETS + b] += 1
        h.sums[idx] += us
        if us > h.maxes[idx]:
            h.maxes[idx] = us
        h.gen += 1  # even: stable again

    def _new_local(self) -> _LocalHist:
        h = _LocalHist()
        with self._reg_lock:
            self._locals.append(h)
        self._tl.hist = h
        return h

    # -- slow path -----------------------------------------------------

    def _slow(self, stage: str, us: int, budget_us: float) -> None:
        event = {
            "stage": stage,
            "durUs": us,
            "budgetUs": int(budget_us),
            "tsUs": int(time.time() * 1_000_000),
            "thread": threading.current_thread().name,
        }
        hook = self._slow_hook
        if hook is not None:
            try:
                hook(event)  # may enrich the event with B3 ids
            except Exception:
                pass
        self._slow_ring.append(event)

    def slow_events(self) -> List[Dict]:
        """Recent over-budget events, oldest first (bounded ring)."""
        return list(self._slow_ring)

    def set_slow_hook(self, hook: Optional[Callable[[Dict], None]]) -> None:
        self._slow_hook = hook

    # -- configuration -------------------------------------------------

    @property
    def enabled(self) -> bool:
        return self._enabled

    def set_enabled(self, on: bool) -> None:
        self._enabled = bool(on)

    @property
    def budget_scale(self) -> float:
        return self._budget_scale

    def set_budget_scale(self, scale: float) -> None:
        self._budget_scale = float(scale)
        self._budgets_us = [
            DEFAULT_BUDGETS_US[s] * self._budget_scale for s in STAGES
        ]

    def budget_us(self, stage: str) -> float:
        return self._budgets_us[STAGE_INDEX[stage]]

    @property
    def locals_count(self) -> int:
        with self._reg_lock:
            return len(self._locals)

    # -- query side ----------------------------------------------------

    def snapshot(self) -> Snapshot:
        """Merge every writer's local into one torn-read-free view."""
        with self._reg_lock:
            locals_ = list(self._locals)
        counts = [0] * (NUM_STAGES * NUM_BUCKETS)
        sums = [0] * NUM_STAGES
        maxes = [0] * NUM_STAGES
        generation = 0
        for h in locals_:
            c = h.counts
            s = h.sums
            m = h.maxes
            g1 = -1
            for _ in range(_TORN_RETRIES):
                g1 = h.gen
                if g1 & 1:
                    continue
                c = h.counts[:]
                s = h.sums[:]
                m = h.maxes[:]
                if h.gen == g1:
                    break
            generation += max(g1, 0)
            for i in range(NUM_STAGES * NUM_BUCKETS):
                counts[i] += c[i]
            for i in range(NUM_STAGES):
                sums[i] += s[i]
                if m[i] > maxes[i]:
                    maxes[i] = m[i]
        return Snapshot(counts, sums, maxes, generation, len(locals_))

    def measure_overhead(self, n: int = 2000) -> float:
        """ns per record(), measured against a scratch recorder so the
        published histograms are not polluted by the self-measurement."""
        scratch = StageRecorder(enabled=True, slow_ring_size=1)
        scratch.set_budget_scale(float("inf"))
        rec = scratch.record
        t0 = time.perf_counter_ns()
        for _ in range(n):
            rec("parse", 9.9e-07)
        dt = time.perf_counter_ns() - t0
        return dt / max(1, n)

    def reset(self) -> None:
        """Zero all histograms and the slow ring. Test helper — callers
        must be quiesced (no concurrent writers)."""
        with self._reg_lock:
            locals_ = list(self._locals)
        for h in locals_:
            h.gen += 1
            h.counts = [0] * (NUM_STAGES * NUM_BUCKETS)
            h.sums = [0] * NUM_STAGES
            h.maxes = [0] * NUM_STAGES
            h.gen += 1
        self._slow_ring.clear()

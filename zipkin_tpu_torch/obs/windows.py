"""Windowed telemetry plane: per-tick delta rings over the flight recorder.

The cumulative flight recorder (:mod:`zipkin_tpu_torch.obs.recorder`) answers
"since boot"; this module answers "over the last 10s/1m/5m/1h". The
windowed-merge idiom from "Sketch Disaggregation Across Time and Space"
applies directly because the recorder's log2 buckets are mergeable: a
window quantile is a bucket-wise sum of per-tick *deltas* followed by
the same cumulative-walk ``StageStat`` read the cumulative plane uses.

Each ``tick()`` takes one seqlock-consistent ``recorder.snapshot()``
(never blocking writers — the query side of the "Fast Concurrent Data
Sketches" split), subtracts the previous snapshot, and pushes the delta
into a two-tier ring:

- a **fine ring** of ``slots`` one-tick deltas (default 64 × 1s), and
- a **coarse ring** of ``coarse_slots`` block deltas, each merging
  ``coarse_factor`` ticks (default 64 × 60s ≈ 65 min of coverage).

A window read merges the newest fine slots back to the last completed
coarse block boundary, then whole coarse blocks — so long lookbacks are
block-aligned and may cover up to ``coarse_factor - 1`` extra ticks;
``WindowStats.ticks`` reports the exact coverage. Because deltas are
exact differences of monotonic counters, the merge over any covered
tick range equals a from-scratch histogram of the same interval (the
oracle property the tests pin).

Counter *rates* (spans/s, 429/s, queries/s) fall out of the same rings:
each tick also samples a caller-supplied numeric counter dict, and a
rate is the difference of two samples divided by the covered wall.

Threading: ``tick()`` is expected from one caller at a time (the
server's 1 Hz ticker or ``tick_if_due()`` on a read path); the ring
lock makes concurrent window reads and ticks safe either way. A
``recorder.reset()`` shows up as a negative delta and clears the rings.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from zipkin_tpu_torch.obs.recorder import (
    NUM_BUCKETS,
    Snapshot,
    StageStat,
    bucket_le_us,
)
from zipkin_tpu_torch.obs.stages import NUM_STAGES, STAGES

_FLAT = NUM_STAGES * NUM_BUCKETS

CounterSource = Callable[[], Dict[str, float]]


def _numeric(counters: Dict) -> Dict[str, float]:
    """Keep only scalar values — sources may carry nested tables."""
    out = {}
    for k, v in counters.items():
        if isinstance(v, bool):
            out[k] = float(v)
        elif isinstance(v, (int, float)):
            out[k] = v
    return out


class WindowStats:
    """One merged window: per-stage histogram view plus counter deltas."""

    __slots__ = ("counts", "sums", "maxes", "ticks", "span_s",
                 "counter_deltas", "end_tick")

    def __init__(self, counts: List[int], sums: List[int], maxes: List[int],
                 ticks: int, span_s: float,
                 counter_deltas: Dict[str, float], end_tick: int) -> None:
        self.counts = counts
        self.sums = sums
        self.maxes = maxes
        self.ticks = ticks
        self.span_s = span_s
        self.counter_deltas = counter_deltas
        self.end_tick = end_tick

    def stage(self, name: str) -> StageStat:
        from zipkin_tpu_torch.obs.stages import STAGE_INDEX

        idx = STAGE_INDEX[name]
        buckets = self.counts[idx * NUM_BUCKETS:(idx + 1) * NUM_BUCKETS]
        return StageStat(name, sum(buckets), self.sums[idx],
                         self.maxes[idx], buckets)

    def nonzero(self) -> List[StageStat]:
        return [s for s in (self.stage(n) for n in STAGES) if s.count]

    def rate(self, counter: str) -> float:
        """Events/second for one sampled counter over this window."""
        if self.span_s <= 0:
            return 0.0
        return self.counter_deltas.get(counter, 0.0) / self.span_s

    @property
    def total_count(self) -> int:
        return sum(self.counts)


class WindowedTelemetry:
    """Tiered delta rings over a :class:`StageRecorder` + counter source."""

    def __init__(self, recorder, counter_source: Optional[CounterSource] = None,
                 *, tick_s: float = 1.0, slots: int = 64,
                 coarse_slots: int = 64, coarse_factor: int = 60,
                 clock: Callable[[], float] = time.monotonic) -> None:
        if slots < coarse_factor:
            raise ValueError("fine ring must cover one coarse block")
        self._rec = recorder
        self._source = counter_source
        self.tick_s = float(tick_s)
        self.slots = int(slots)
        self.coarse_slots = int(coarse_slots)
        self.coarse_factor = int(coarse_factor)
        self._clock = clock
        self._lock = threading.Lock()
        # serializes whole ticks (snapshot + push): concurrent tickers
        # (thread + lazy read-path catch-up) must not interleave their
        # snapshots or a stale one would produce a phantom negative delta
        self._tick_mutex = threading.Lock()
        self._enabled = True
        self._on_tick: List[Callable[["WindowedTelemetry"], None]] = []
        self._ticker: Optional[threading.Thread] = None
        self._ticker_stop = threading.Event()
        self.resets = 0
        self._init_rings()
        # Baseline at construction: observations recorded after this
        # point land in tick 1's delta; pre-existing totals stay in the
        # cumulative plane only.
        base = recorder.snapshot()
        self._base_counts = base.counts
        self._base_sums = base.sums
        self._base_maxes = base.maxes
        self._base_counters = self._sample_counters()
        # the epoch sample backs full-coverage counter deltas (tick -1);
        # _base_counters advances every tick, this only moves on ring reset
        self._epoch_counters = self._base_counters
        self._last_tick: Optional[float] = None

    # -- internals -----------------------------------------------------

    def _init_rings(self) -> None:
        self.ticks = 0  # completed ticks; fine slot i holds tick i % slots
        self._fine_counts: List[Optional[List[int]]] = [None] * self.slots
        self._fine_sums: List[Optional[List[int]]] = [None] * self.slots
        self._fine_counters: List[Optional[Dict[str, float]]] = \
            [None] * self.slots
        self._coarse_counts: List[Optional[List[int]]] = \
            [None] * self.coarse_slots
        self._coarse_sums: List[Optional[List[int]]] = [None] * self.coarse_slots
        self._coarse_counters: List[Optional[Dict[str, float]]] = \
            [None] * self.coarse_slots
        self._accum_counts = [0] * _FLAT
        self._accum_sums = [0] * NUM_STAGES
        self._accum_ticks = 0

    def _sample_counters(self) -> Dict[str, float]:
        if self._source is None:
            return {}
        try:
            return _numeric(self._source())
        except Exception:
            return {}

    # -- tick side -----------------------------------------------------

    def tick(self, now: Optional[float] = None) -> bool:
        """Capture one delta slot. Returns False when disabled or when a
        recorder reset forced a ring clear (the tick re-baselines)."""
        if not self._enabled:
            return False
        with self._tick_mutex:
            return self._tick_inner(now)

    def _tick_inner(self, now: Optional[float]) -> bool:
        if now is None:
            now = self._clock()
        snap = self._rec.snapshot()
        counters = self._sample_counters()
        with self._lock:
            ok = self._push_locked(snap, counters, now)
        if ok:
            for cb in list(self._on_tick):
                try:
                    cb(self)
                except Exception:
                    pass
        return ok

    # every caller (_tick_inner, tick_if_due) holds self._lock
    def _push_locked(self, snap: Snapshot, counters: Dict[str, float],
                     now: float) -> bool:
        d_counts = [a - b for a, b in zip(snap.counts, self._base_counts)]
        d_sums = [a - b for a, b in zip(snap.sums, self._base_sums)]
        self._base_counts = snap.counts
        self._base_sums = snap.sums
        self._base_maxes = snap.maxes
        self._base_counters = counters
        self._last_tick = now
        if any(d < 0 for d in d_counts):
            # recorder.reset() happened mid-stream: history is
            # incomparable with the new baseline, start over
            self._init_rings()
            self._epoch_counters = counters
            self.resets += 1
            return False
        slot = self.ticks % self.slots
        self._fine_counts[slot] = d_counts
        self._fine_sums[slot] = d_sums
        self._fine_counters[slot] = counters
        for i in range(_FLAT):
            self._accum_counts[i] += d_counts[i]
        for i in range(NUM_STAGES):
            self._accum_sums[i] += d_sums[i]
        self._accum_ticks += 1
        self.ticks += 1
        if self._accum_ticks >= self.coarse_factor:
            block = (self.ticks // self.coarse_factor - 1) % self.coarse_slots
            self._coarse_counts[block] = self._accum_counts
            self._coarse_sums[block] = self._accum_sums
            self._coarse_counters[block] = counters
            self._accum_counts = [0] * _FLAT
            self._accum_sums = [0] * NUM_STAGES
            self._accum_ticks = 0
        return True

    def tick_if_due(self, now: Optional[float] = None) -> int:
        """Catch up on missed ticks (the read path's catch-up when no ticker
        thread runs). Idle gaps produce empty slots — the snapshot is
        only taken for the newest tick, so a long-idle read costs one
        snapshot, not one per missed second."""
        if not self._enabled:
            return 0
        if now is None:
            now = self._clock()
        with self._tick_mutex:
            with self._lock:
                last = self._last_tick
            if last is None:
                return 1 if self._tick_inner(now) else 0
            due = int((now - last) / self.tick_s)
            if due <= 0:
                return 0
            if due > self.slots + self.coarse_factor:
                # gap longer than the fine ring: history aged out anyway
                with self._lock:
                    self._init_rings()
                    self._epoch_counters = self._base_counters
            else:
                with self._lock:
                    for i in range(due - 1):
                        self._push_locked(
                            Snapshot(self._base_counts, self._base_sums,
                                     self._base_maxes, 0, 0),
                            self._base_counters,
                            last + (i + 1) * self.tick_s,
                        )
            self._tick_inner(now)
            return due

    def on_tick(self, cb: Callable[["WindowedTelemetry"], None]) -> None:
        self._on_tick.append(cb)

    # -- ticker thread -------------------------------------------------

    def start_ticker(self) -> None:
        if self._ticker is not None:
            return
        self._ticker_stop.clear()

        def _loop() -> None:
            while not self._ticker_stop.wait(self.tick_s):
                try:
                    self.tick()
                except Exception:
                    pass

        t = threading.Thread(target=_loop, name="obs-windows-ticker",
                             daemon=True)
        self._ticker = t
        t.start()

    def stop_ticker(self) -> None:
        t = self._ticker
        if t is None:
            return
        self._ticker_stop.set()
        t.join(timeout=5.0)
        self._ticker = None

    @property
    def ticker_running(self) -> bool:
        return self._ticker is not None

    def set_enabled(self, on: bool) -> None:
        self._enabled = bool(on)

    @property
    def enabled(self) -> bool:
        return self._enabled

    # -- window side ---------------------------------------------------

    def window(self, lookback_s: float) -> WindowStats:
        """Merge the newest deltas covering ``lookback_s`` seconds.

        Exact at fine (one-tick) resolution inside the fine ring;
        block-aligned beyond it. Returns an empty window before the
        first tick."""
        want = max(1, int(round(lookback_s / self.tick_s)))
        with self._lock:
            return self._window_locked(want)

    def _window_locked(self, want: int) -> WindowStats:
        counts = [0] * _FLAT
        sums = [0] * NUM_STAGES
        t = self.ticks
        covered = 0
        if t > 0:
            avail_fine = min(t, self.slots)
            if want <= avail_fine:
                # exact: the fine ring holds every requested tick
                fine_lo = t - want
            else:
                # block-aligned: fine segment back to the last completed
                # coarse boundary (always inside the fine ring because
                # slots >= coarse_factor), whole coarse blocks beyond
                fine_lo = (t // self.coarse_factor) * self.coarse_factor
            for tick_i in range(fine_lo, t):
                dc = self._fine_counts[tick_i % self.slots]
                ds = self._fine_sums[tick_i % self.slots]
                if dc is None:
                    continue
                for i in range(_FLAT):
                    counts[i] += dc[i]
                for i in range(NUM_STAGES):
                    sums[i] += ds[i]
                covered += 1
            remaining = want - covered
            if remaining > 0 and want > avail_fine:
                n_blocks = (remaining + self.coarse_factor - 1) \
                    // self.coarse_factor
                avail_blocks = min(t // self.coarse_factor, self.coarse_slots)
                n_blocks = min(n_blocks, avail_blocks)
                newest_block = t // self.coarse_factor - 1
                for k in range(n_blocks):
                    block = (newest_block - k) % self.coarse_slots
                    bc = self._coarse_counts[block]
                    bs = self._coarse_sums[block]
                    if bc is None:
                        continue
                    for i in range(_FLAT):
                        counts[i] += bc[i]
                    for i in range(NUM_STAGES):
                        sums[i] += bs[i]
                    covered += self.coarse_factor
        maxes = self._window_maxes(counts)
        deltas = self._counter_deltas_locked(covered)
        return WindowStats(counts, sums, maxes, covered,
                           covered * self.tick_s, deltas, t)

    def _window_maxes(self, counts: List[int]) -> List[int]:
        """Per-window max is not delta-decomposable; bound it by the top
        nonzero bucket's upper edge, capped by the cumulative max."""
        maxes = [0] * NUM_STAGES
        for s in range(NUM_STAGES):
            base = s * NUM_BUCKETS
            for b in range(NUM_BUCKETS - 1, -1, -1):
                if counts[base + b]:
                    maxes[s] = min(bucket_le_us(b), self._base_maxes[s]) \
                        if self._base_maxes[s] else bucket_le_us(b)
                    break
        return maxes

    def _counter_deltas_locked(self, covered: int) -> Dict[str, float]:
        if covered <= 0 or self.ticks == 0:
            return {}
        newest = self._fine_counters[(self.ticks - 1) % self.slots]
        if newest is None:
            return {}
        old = self._counters_at_locked(self.ticks - 1 - covered)
        if old is None:
            return {}
        return {k: v - old.get(k, 0.0) for k, v in newest.items()}

    def _counters_at_locked(self, tick_i: int) -> Optional[Dict[str, float]]:
        """Cumulative counter sample at completed tick index ``tick_i``
        (-1 means the construction baseline). Window decomposition only
        asks at fine-ring indices or coarse block ends, so exact samples
        always exist while the data is retained."""
        if tick_i < 0:
            # the window covers every tick: delta against the epoch
            # (construction or last ring reset)
            return self._epoch_counters
        if tick_i >= self.ticks - self.slots:
            return self._fine_counters[tick_i % self.slots]
        if (tick_i + 1) % self.coarse_factor != 0:
            return None
        block = (tick_i + 1) // self.coarse_factor - 1
        if block < self.ticks // self.coarse_factor - self.coarse_slots:
            return None
        return self._coarse_counters[block % self.coarse_slots]

    def current_counters(self) -> Dict[str, float]:
        """Newest cumulative counter sample (gauge reads)."""
        with self._lock:
            if self.ticks:
                c = self._fine_counters[(self.ticks - 1) % self.slots]
            else:
                c = self._base_counters
        return dict(c or {})

    def rates(self, lookback_s: float) -> Dict[str, float]:
        """Counter rates (events/s) over the newest covered window."""
        w = self.window(lookback_s)
        if w.span_s <= 0:
            return {}
        return {k: v / w.span_s for k, v in w.counter_deltas.items()}

    # -- introspection -------------------------------------------------

    def status(self, lookbacks: Tuple[float, ...] = (10.0, 60.0, 300.0,
                                                     3600.0)) -> Dict:
        """Compact dict for the ``/statusz`` windows section."""
        body: Dict = {
            "tickS": self.tick_s,
            "ticks": self.ticks,
            "fineSlots": self.slots,
            "coarseSlots": self.coarse_slots,
            "coarseFactor": self.coarse_factor,
            "resets": self.resets,
            "tickerRunning": self.ticker_running,
            "lookbacks": {},
        }
        for lb in lookbacks:
            w = self.window(lb)
            stages = {
                s.stage: {
                    "count": s.count,
                    "p50Us": s.p50_us,
                    "p99Us": s.p99_us,
                    "maxUs": s.max_us,
                }
                for s in w.nonzero()
            }
            rates = {}
            if w.span_s > 0:
                for key in ("spans", "accepted", "mpAccepted", "mpRejected"):
                    if key in w.counter_deltas:
                        rates[key + "PerSec"] = round(
                            w.counter_deltas[key] / w.span_s, 3)
            body["lookbacks"][f"{int(lb)}s"] = {
                "coveredS": round(w.span_s, 3),
                "stages": stages,
                "rates": rates,
            }
        return body

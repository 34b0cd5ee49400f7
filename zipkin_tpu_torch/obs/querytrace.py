"""Query-plane observatory: per-query critical paths + lock contention.

The ingest half of the pipeline is observable wire-to-durable
(obs/critpath.py); this module is the read-side mirror. ROADMAP item 4
says the store must serve many concurrent dashboard readers at
p99 < 50 ms; the refactor that got there — the epoch-published read
mirror in ``tpu/mirror.py`` that takes reads off the aggregator lock —
is judged by this instrument: mirror serves stamp the lock-free
``mirror_serve`` segment, and a fresh read that still queues on the
lock shows up as ``lock_wait``. Three pieces:

- A **thread-local :class:`QueryTrace`** armed at the storage read
  entrypoints (``tpu/store.py``) and stamped — without taking any lock
  on the hot path — by the layers a query crosses: the read-cache probe,
  the instrumented aggregator lock (wait only; the hold is ledger
  state), the device-program dispatch (via ``obs/device.py``), the
  dispatch-to-ready device wall, the single packed device→host pull and
  its zero-copy unpack (``readpack.py``), vocab link resolution, and row
  serialization. Stamps are plain list appends on the owning thread;
  an unarmed thread pays one thread-local read.
- An **instrumented re-entrant lock** (:class:`InstrumentedRLock`) that
  replaces the aggregator's bare ``threading.RLock``. The outermost
  acquire measures wait (uncontended acquires take a non-blocking fast
  path), the outermost release measures hold; both land in log2-µs
  histograms next to live waiter depth, a high-water mark, and per-label
  holder attribution (the active query's name, or the label ingest set).
  Every outermost wait is also relayed into the ``query_lock_wait``
  recorder stage so the windowed plane and the SLO watchdog see
  contention the moment it exists. Re-entrant acquires (read paths nest:
  ``dependency_edges`` → ``window_fully_rolled``) are counted but never
  measured — an RLock re-acquire by its holder cannot block.
- A **stitcher** (:class:`QueryObservatory`) folding completed traces at
  windows-tick cadence into per-segment count/sum/max aggregates, query
  wall percentiles, and a conservation check (segments + attributed gaps
  must sum to the measured wall); each folded wall is relayed into the
  ``query_wall`` stage, and the slowest query per stitch is emitted as a
  real self-span timeline through the SelfSpanEmitter.

``begin``/``finish``/``stamp_active`` run on host threads only, never
inside a device program. The store's mirror serve stamps ``mirror_serve``
and a reader process's serve (``serving/shape.py``) ``reader_serve``.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional

from zipkin_tpu_torch import obs as _obs
from zipkin_tpu_torch.obs.recorder import NUM_BUCKETS, bucket_le_us

# -- segment taxonomy ----------------------------------------------------
# Stamped segments carry measured intervals; QSEG_OTHER is derived — the
# gap sweep attributes every unstamped nanosecond of the query wall to
# it, so conservation holds by construction and "other" shrinking is the
# measure of attribution coverage.

QSEG_LOCK_WAIT = 0          # outermost contended wait on the aggregator lock
QSEG_CACHE_PROBE = 1        # read-cache lock + version check + lookup
QSEG_DEVICE_DISPATCH = 2    # enqueue wall of a wrapped device read program
QSEG_DEVICE_WALL = 3        # dispatch done -> packed result device-ready
QSEG_READPACK_TRANSFER = 4  # the single packed device->host pull
QSEG_UNPACK = 5             # zero-copy view carve of the packed buffer
QSEG_LINK_RESOLVE = 6       # id->name vocab resolution into DependencyLinks
QSEG_SERIALIZE = 7          # row shaping of device output into API objects
QSEG_OTHER = 8              # derived: unstamped query time (gap sweep)
QSEG_MIRROR_SERVE = 9       # lock-free serve from the epoch-published mirror
QSEG_READER_SERVE = 10      # reader-process serve from the shm mirror segment
N_QSEGS = 11

QSEG_NAMES = (
    "lock_wait", "cache_probe", "device_dispatch", "device_wall",
    "readpack_transfer", "unpack", "link_resolve", "serialize", "other",
    "mirror_serve", "reader_serve",
)
_QWAIT = frozenset((QSEG_LOCK_WAIT, QSEG_OTHER))
QSEG_KIND = tuple(
    "wait" if i in _QWAIT else "service" for i in range(N_QSEGS)
)


def _env_on(name: str, default: str = "1") -> bool:
    return os.environ.get(name, default).strip().lower() \
        not in ("0", "false", "no")


def _default_enabled() -> bool:
    return _env_on("TPU_OBS_QUERY") and _env_on("TPU_OBS")


def _pctl(sorted_vals, q: float):
    if not sorted_vals:
        return 0
    i = min(len(sorted_vals) - 1, int(q * (len(sorted_vals) - 1) + 0.5))
    return sorted_vals[i]


def _hist_quantile_us(hist: List[int], q: float) -> int:
    total = sum(hist)
    if total <= 0:
        return 0
    rank = int(q * (total - 1))
    seen = 0
    for b, n in enumerate(hist):
        seen += n
        if seen > rank:
            return bucket_le_us(b)
    return bucket_le_us(len(hist) - 1)


def _bucket(us: int) -> int:
    return min(NUM_BUCKETS - 1, int(us).bit_length())


# -- thread-local active trace -------------------------------------------

_active = threading.local()
_label = threading.local()


class QueryTrace:
    """One query's interval timeline; owned by exactly one thread."""

    __slots__ = ("name", "t0_ns", "wall_ns", "ivs")

    def __init__(self, name: str) -> None:
        self.name = name
        self.t0_ns = time.perf_counter_ns()
        self.wall_ns = 0
        self.ivs: List[tuple] = []   # (code, t0_ns, t1_ns)


def active() -> Optional[QueryTrace]:
    """The calling thread's in-flight trace, if any."""
    return getattr(_active, "trace", None)


def stamp_active(code: int, t0_ns: int, t1_ns: int) -> None:  # zt-dispatch-critical: one thread-local read + list append when armed; pure no-op otherwise
    # one thread-local read + list append when armed; a no-op otherwise
    tr = getattr(_active, "trace", None)
    if tr is None:
        return
    tr.ivs.append((code, t0_ns, t1_ns))


@contextmanager
def lock_label(label: str):
    """Attribute aggregator-lock holds on this thread to ``label`` when
    no query trace is active (the write path has no trace)."""
    prev = getattr(_label, "v", None)
    _label.v = label
    try:
        yield
    finally:
        _label.v = prev


def current_label() -> str:
    tr = getattr(_active, "trace", None)
    if tr is not None:
        return "query:" + tr.name
    return getattr(_label, "v", None) or "unattributed"


# -- the instrumented aggregator lock ------------------------------------


class InstrumentedRLock:
    """Re-entrant lock with a contention ledger.

    Drop-in for ``threading.RLock`` under ``with`` discipline. Counter
    writes that happen while holding the inner lock are serialized by
    it; the waiter depth/high-water pair is the only state mutated by
    threads that do NOT hold the lock, so it lives under ``_meta``.
    Histogram reads from the counters path may be torn by one in-flight
    increment — these are debug gauges, same contract as obs/device.py.
    """

    def __init__(self, name: str = "agg", recorder=None,
                 enabled: Optional[bool] = None) -> None:
        self.name = name
        self._inner = threading.RLock()
        self._tl = threading.local()
        self._meta = threading.Lock()
        self._recorder = recorder
        self._enabled = _default_enabled() if enabled is None else bool(enabled)
        self.waiters = 0
        self.waiters_high_water = 0
        self.acquisitions = 0
        self.contended = 0
        self.reentries = 0
        self.wait_sum_us = 0
        self.wait_max_us = 0
        self.hold_sum_us = 0
        self.hold_max_us = 0
        self._wait_hist = [0] * NUM_BUCKETS
        self._hold_hist = [0] * NUM_BUCKETS
        self._holders: Dict[str, List[int]] = {}  # label -> [count, holdSumUs]
        self._hold_t0 = 0
        self._holder_label = "unattributed"

    # -- configuration --------------------------------------------------

    @property
    def enabled(self) -> bool:
        return self._enabled

    def set_enabled(self, on: bool) -> None:
        self._enabled = bool(on)

    def reset_counters(self) -> None:
        """Zero the ledger (bench A/B helper); live depth is preserved."""
        with self._meta:
            self.waiters_high_water = self.waiters
        self.acquisitions = 0
        self.contended = 0
        self.reentries = 0
        self.wait_sum_us = 0
        self.wait_max_us = 0
        self.hold_sum_us = 0
        self.hold_max_us = 0
        self._wait_hist = [0] * NUM_BUCKETS
        self._hold_hist = [0] * NUM_BUCKETS
        self._holders = {}

    # -- lock protocol ---------------------------------------------------

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        depth = getattr(self._tl, "depth", 0)
        if depth:
            got = self._inner.acquire(blocking, timeout)
            if got:
                self._tl.depth = depth + 1
                self.reentries += 1  # holder-thread write: serialized
            return got
        if not self._enabled or not blocking or timeout != -1:
            got = self._inner.acquire(blocking, timeout)
            if got:
                self._tl.depth = 1
                self.acquisitions += 1
                self._hold_t0 = 0  # unmeasured acquire: skip hold math
            return got
        t0 = time.perf_counter_ns()
        if self._inner.acquire(blocking=False):
            wait_ns = 0
        else:
            with self._meta:
                self.waiters += 1
                if self.waiters > self.waiters_high_water:
                    self.waiters_high_water = self.waiters
            self._inner.acquire()
            with self._meta:
                self.waiters -= 1
            wait_ns = time.perf_counter_ns() - t0
            self.contended += 1
        # Holding from here on: counter writes serialized by the lock.
        self._tl.depth = 1
        self.acquisitions += 1
        wait_us = wait_ns // 1000
        self._wait_hist[_bucket(wait_us)] += 1
        self.wait_sum_us += wait_us
        if wait_us > self.wait_max_us:
            self.wait_max_us = wait_us
        self._hold_t0 = time.perf_counter_ns()
        self._holder_label = current_label()
        if wait_ns:
            stamp_active(QSEG_LOCK_WAIT, t0, t0 + wait_ns)
        rec = self._recorder if self._recorder is not None else _obs.RECORDER
        rec.record_relayed("query_lock_wait", wait_ns / 1e9)
        return True

    def release(self) -> None:
        depth = getattr(self._tl, "depth", 0)
        if depth > 1:
            self._tl.depth = depth - 1
            self._inner.release()
            return
        if self._enabled and self._hold_t0:
            hold_us = (time.perf_counter_ns() - self._hold_t0) // 1000
            self._hold_hist[_bucket(hold_us)] += 1
            self.hold_sum_us += hold_us
            if hold_us > self.hold_max_us:
                self.hold_max_us = hold_us
            ent = self._holders.get(self._holder_label)
            if ent is None:
                ent = self._holders[self._holder_label] = [0, 0]
            ent[0] += 1
            ent[1] += hold_us
        self._hold_t0 = 0
        self._tl.depth = 0
        self._inner.release()

    def would_block(self) -> bool:
        """Non-blocking contention probe: True when ANOTHER thread
        holds the lock right now (a read here would queue). Touches
        neither the ledger (``contended`` is its counter) nor the
        re-entrancy depth — a probe is not an acquisition. The
        mirror's serve arbitration uses this: a version-stale epoch
        may serve a default request only while the fresh path would
        actually block."""
        if getattr(self._tl, "depth", 0):
            return False
        if self._inner.acquire(blocking=False):
            self._inner.release()
            return False
        return True

    def relabel(self, label: str) -> None:
        """Override the holder attribution for the CURRENT outermost
        hold; no-op when called from a nested (re-entrant) hold so an
        enclosing query keeps the attribution for work it caused."""
        if getattr(self._tl, "depth", 0) == 1:
            self._holder_label = label

    def __enter__(self) -> "InstrumentedRLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    # -- ledger reads ----------------------------------------------------

    def counters(self) -> Dict:
        wait_hist = list(self._wait_hist)
        hold_hist = list(self._hold_hist)
        holders = {
            k: {"count": v[0], "holdSumUs": v[1]}
            for k, v in list(self._holders.items())
        }
        return {
            "queryLockAcquisitions": self.acquisitions,
            "queryLockContended": self.contended,
            "queryLockReentries": self.reentries,
            "queryLockWaiters": self.waiters,
            "queryLockWaitersHighWater": self.waiters_high_water,
            "queryLockWaitSumUs": self.wait_sum_us,
            "queryLockWaitMaxUs": self.wait_max_us,
            "queryLockWaitP50Us": _hist_quantile_us(wait_hist, 0.50),
            "queryLockWaitP99Us": _hist_quantile_us(wait_hist, 0.99),
            "queryLockHoldSumUs": self.hold_sum_us,
            "queryLockHoldMaxUs": self.hold_max_us,
            "queryLockHoldP50Us": _hist_quantile_us(hold_hist, 0.50),
            "queryLockHoldP99Us": _hist_quantile_us(hold_hist, 0.99),
            # nested table: skipped by the flat gauge loops, consumed by
            # the /prometheus zipkin_tpu_query_lock_* renderer
            "queryLock": {
                "waitHist": wait_hist,
                "waitSumUs": self.wait_sum_us,
                "holdHist": hold_hist,
                "holdSumUs": self.hold_sum_us,
                "holders": holders,
            },
        }

    def status(self) -> Dict:
        body = {k: v for k, v in self.counters().items() if k != "queryLock"}
        body["name"] = self.name
        body["enabled"] = self._enabled
        body["holders"] = self.counters()["queryLock"]["holders"]
        return body


# -- the stitcher --------------------------------------------------------


class QueryObservatory:
    """Owns the completed-trace queue and the fold aggregates for one
    store. ``begin``/``finish`` bracket a query on its serving thread;
    ``on_tick`` (registered with the windows ticker, before the SLO
    watchdog so alerts lag at most one tick) folds what completed."""

    def __init__(self, recorder=None,
                 enabled: Optional[bool] = None) -> None:
        self.enabled = _default_enabled() if enabled is None else bool(enabled)
        self._recorder = recorder
        self._lock = threading.Lock()
        self._done: deque = deque(maxlen=8192)   # GIL-atomic appends
        self.emitter = None          # SelfSpanEmitter, wired by the server
        self.lock_provider: Optional[Callable] = None  # -> InstrumentedRLock
        self.queries = 0
        self.wall_sum_us = 0
        self.seg_count = [0] * N_QSEGS
        self.seg_sum_us = [0] * N_QSEGS
        self.seg_max_us = [0] * N_QSEGS
        self._walls: deque = deque(maxlen=16384)   # µs
        self._cons: deque = deque(maxlen=4096)
        self._slowest: Optional[Dict] = None

    # -- trace lifecycle (serving threads) -------------------------------

    def begin(self, name: str) -> Optional[QueryTrace]:
        """Arm a trace for this thread; None when disabled or when an
        enclosing query already owns the thread (nested reads fold into
        the outer timeline)."""
        if not self.enabled:
            return None
        if getattr(_active, "trace", None) is not None:
            return None
        tr = QueryTrace(name)
        _active.trace = tr
        return tr

    def finish(self, tr: Optional[QueryTrace]) -> None:
        if tr is None:
            return
        if getattr(_active, "trace", None) is tr:
            _active.trace = None
        tr.wall_ns = max(1, time.perf_counter_ns() - tr.t0_ns)
        self._done.append(tr)

    # -- stitching (ticker thread) ---------------------------------------

    def on_tick(self, _windows=None) -> None:
        self.stitch()

    def stitch(self) -> int:
        with self._lock:
            return self._stitch_locked()

    def _stitch_locked(self) -> int:
        # the sole caller, stitch(), holds self._lock: drain and fold are one critical section
        rec = self._recorder if self._recorder is not None else _obs.RECORDER
        folded = 0
        slowest = None
        while True:
            try:
                tr = self._done.popleft()
            except IndexError:
                break
            f = self._fold(tr)
            folded += 1
            self.queries += 1
            for c, d_ns in enumerate(f["durs_ns"]):
                if not d_ns:
                    continue
                us = d_ns // 1000
                self.seg_count[c] += 1
                self.seg_sum_us[c] += us
                if us > self.seg_max_us[c]:
                    self.seg_max_us[c] = us
            wall_us = f["wall_ns"] // 1000
            self.wall_sum_us += wall_us
            self._walls.append(wall_us)
            self._cons.append(f["conservation"])
            rec.record_relayed("query_wall", f["wall_ns"] / 1e9)
            if slowest is None or f["wall_ns"] > slowest["wall_ns"]:
                slowest = f
        if slowest is not None:
            self._slowest = slowest
            if self.emitter is not None:
                try:
                    self.emitter.emit_spans(self._spans_for(slowest))
                except Exception:
                    pass
        return folded

    def _fold(self, tr: QueryTrace) -> Dict:
        wall = tr.wall_ns
        t0, t_end = tr.t0_ns, tr.t0_ns + wall
        durs = [0] * N_QSEGS
        clipped = []
        for code, a, b in tr.ivs:
            a = max(a, t0)
            b = min(b, t_end)
            if b > a:
                clipped.append((a, b, code))
                durs[code] += b - a
        clipped.sort()
        cur = t0
        for a, b, _code in clipped:
            if a > cur:
                durs[QSEG_OTHER] += a - cur
            if b > cur:
                cur = b
        if t_end > cur:
            durs[QSEG_OTHER] += t_end - cur
        return {
            "name": tr.name,
            "t0_ns": t0,
            "wall_ns": wall,
            "durs_ns": durs,
            "ivs": clipped,
            "conservation": sum(durs) / wall,
        }

    def _spans_for(self, f: Dict):
        from zipkin_tpu_torch.model import Endpoint, Span
        from zipkin_tpu_torch.obs.selfspans import SERVICE_NAME, _new_id

        bridge_ns = time.time_ns() - time.perf_counter_ns()
        ep = Endpoint.create(service_name=SERVICE_NAME, ip="127.0.0.1")
        trace_id = _new_id()
        root_id = _new_id()
        spans = [Span.create(
            trace_id=trace_id,
            id=root_id,
            name="query_" + f["name"],
            timestamp=max(1, (f["t0_ns"] + bridge_ns) // 1000),
            duration=max(1, f["wall_ns"] // 1000),
            local_endpoint=ep,
            tags={
                "obs.querytrace.kind": f["name"],
                "obs.querytrace.conservation": "%.3f" % f["conservation"],
                "obs.querytrace.wall_us": str(f["wall_ns"] // 1000),
            },
        )]
        for a, b, code in f["ivs"]:
            spans.append(Span.create(
                trace_id=trace_id,
                id=_new_id(),
                parent_id=root_id,
                name=QSEG_NAMES[code],
                timestamp=max(1, (a + bridge_ns) // 1000),
                duration=max(1, (b - a) // 1000),
                local_endpoint=ep,
                tags={"obs.querytrace.segkind": QSEG_KIND[code]},
            ))
        return spans

    # -- reads -----------------------------------------------------------

    def reset(self) -> None:
        """Drop aggregates and pending traces; zero the lock ledger too
        (bench legs and tests want a clean baseline)."""
        with self._lock:
            self._done.clear()
            self.queries = 0
            self.wall_sum_us = 0
            self.seg_count = [0] * N_QSEGS
            self.seg_sum_us = [0] * N_QSEGS
            self.seg_max_us = [0] * N_QSEGS
            self._walls.clear()
            self._cons.clear()
            self._slowest = None
        lock = self.lock_provider() if self.lock_provider else None
        if lock is not None and hasattr(lock, "reset_counters"):
            lock.reset_counters()

    def counters(self) -> Dict:
        with self._lock:
            walls = sorted(self._walls)
            cons = sorted(self._cons)
            segs = {}
            for c in range(N_QSEGS):
                if not self.seg_count[c]:
                    continue
                segs[QSEG_NAMES[c]] = {
                    "kind": QSEG_KIND[c],
                    "count": self.seg_count[c],
                    "sumUs": self.seg_sum_us[c],
                    "maxUs": self.seg_max_us[c],
                }
            out = {
                "queryTraces": self.queries,
                "queryWallSumUs": self.wall_sum_us,
                "queryWallP50Us": _pctl(walls, 0.50),
                "queryWallP99Us": _pctl(walls, 0.99),
                "queryWallMaxUs": walls[-1] if walls else 0,
                "queryConservationP50Milli": int(
                    _pctl(cons, 0.50) * 1000) if cons else 0,
                "querySegments": segs,
            }
        lock = self.lock_provider() if self.lock_provider else None
        if lock is not None and hasattr(lock, "counters"):
            out.update(lock.counters())
        return out

    def waterfall(self) -> Dict:
        """Full dict for the ``/statusz`` queries section."""
        self.stitch()
        with self._lock:
            walls = sorted(self._walls)
            cons = sorted(self._cons)
            wait_us = sum(
                self.seg_sum_us[c] for c in range(N_QSEGS) if c in _QWAIT)
            service_us = sum(
                self.seg_sum_us[c] for c in range(N_QSEGS)
                if c not in _QWAIT)
            body = {
                "enabled": self.enabled,
                "queries": self.queries,
                "wall": {
                    "count": len(walls),
                    "p50Us": _pctl(walls, 0.50),
                    "p99Us": _pctl(walls, 0.99),
                    "maxUs": walls[-1] if walls else 0,
                },
                "conservation": {
                    "p50": round(_pctl(cons, 0.50), 4) if cons else 0.0,
                    "min": round(cons[0], 4) if cons else 0.0,
                    "max": round(cons[-1], 4) if cons else 0.0,
                },
                "waitVsService": {
                    "waitUs": wait_us,
                    "serviceUs": service_us,
                    "waitFraction": round(
                        wait_us / max(1, wait_us + service_us), 4),
                },
                "segments": [
                    {
                        "name": QSEG_NAMES[c],
                        "kind": QSEG_KIND[c],
                        "count": self.seg_count[c],
                        "sumUs": self.seg_sum_us[c],
                        "maxUs": self.seg_max_us[c],
                        "meanUs": round(
                            self.seg_sum_us[c] / self.seg_count[c], 1),
                    }
                    for c in range(N_QSEGS) if self.seg_count[c]
                ],
            }
            slow = self._slowest
            if slow is not None:
                body["slowest"] = {
                    "name": slow["name"],
                    "wallUs": slow["wall_ns"] // 1000,
                    "conservation": round(slow["conservation"], 4),
                    "segments": {
                        QSEG_NAMES[c]: d // 1000
                        for c, d in enumerate(slow["durs_ns"]) if d
                    },
                }
        lock = self.lock_provider() if self.lock_provider else None
        if lock is not None and hasattr(lock, "status"):
            body["lock"] = lock.status()
        return body

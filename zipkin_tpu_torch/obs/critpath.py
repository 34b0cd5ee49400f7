"""Ingest critical-path tracer: cross-process wire-to-durable timelines
(the port's copy of ``zipkin_tpu/obs/critpath.py``).

The fan-out tier (tpu/mp_ingest.py) splits one ingest request across
three clock domains — the server boundary thread, a spawn parse worker,
and the dispatcher thread — so the per-stage recorder totals cannot say
*where* a slow chunk spent its time: queue-wait and service are folded
together, and ``mp_record`` hides four very different substages. This
module is the instrument that separates them:

- A **chunk-scoped trace context** is assigned at the server boundary
  (``WIRE_T0_NS`` contextvar, stamped before the body leaves the event
  loop) and threaded through ``submit()`` into the worker queue item.
- A **fixed-slot shared-memory interval ledger** holds one slot per
  in-flight traced payload. Each slot has two independently
  generation-stamped regions — one written only by the owning worker
  process, one written only by main-process threads (boundary stamps
  happen-before the queue put; dispatcher stamps happen-after the
  worker's result message, so main-side writers are causally serialized)
  — the same single-writer seqlock idiom as ``obs/recorder.py``, over
  raw int64 words so nothing pickles on the dispatch-critical path.
- **Clock-domain alignment**: every process publishes a seqlocked
  ``(perf_counter_ns, time_ns)`` calibration pair; worker timestamps map
  into the main monotonic domain via the wall-clock bridge
  ``t_main = t_worker + (wall_w - mono_w) - (wall_m - mono_m)``.
- A **stitcher** folds DONE slots at windows-tick cadence into exact
  wire-to-durable percentiles (relayed into the ``wire_to_durable``
  recorder stage so the windowed/SLO planes see it), a per-segment
  queue-wait vs service decomposition with Little's-law occupancy and
  saturation gauges, and per-chunk timelines whose segments must sum to
  the measured wall within a conservation bound — the bound is what
  absorbs residual cross-domain clock noise. The slowest timeline per
  stitch is emitted as a self-span tree through the SelfSpanEmitter, so
  a slow chunk is a retrievable trace in the server's own UI.

Orphan safety: a SIGKILL'd worker leaves its slots OPEN forever; the
stitcher reclaims OPEN slots older than ``reclaim_age_s`` and the
dispatcher's fallback path abandons slots explicitly, so timelines can
skew but never stick. Late stamps against a reclaimed-and-reused slot
are rejected by the payload-id guard.

This module is imported by spawn workers: keep it free of torch and of
anything heavier than numpy. The shared-memory layout (``SLOT_WORDS``, the
``_OFF_*`` offsets, ``_MAGIC`` and the calibration rows) is the reference's
word for word, so a ledger either package's workers fill is stitched by
either package's :class:`CritPathStitcher`.
"""

from __future__ import annotations

import contextvars
import threading
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np

# Set at the server boundary (HTTP body read / gRPC request
# deserialization) in the main monotonic domain; read by
# MultiProcessIngester.submit() on the same context (contextvars
# propagate through asyncio.to_thread). 0 = no boundary stamp.
WIRE_T0_NS: contextvars.ContextVar[int] = contextvars.ContextVar(
    "zipkin_tpu_wire_t0_ns", default=0
)

# -- segment taxonomy ----------------------------------------------------
# Stamped segments carry measured intervals; derived segments are the
# gaps between them, classified by pipeline phase. ``kind`` drives the
# queue-wait vs service rollup.

SEG_BOUNDARY = 0        # derived: wire receipt -> submit registration
SEG_ENQUEUE = 1         # stamped (boundary thread): registration + queue put
SEG_QUEUE_WAIT = 2      # derived: queue put -> worker first touch
SEG_PARSE = 3           # stamped (worker): native parse + intern + sample
SEG_SLOT_WAIT = 4       # stamped (worker): waiting on a free shm slot
SEG_PACK = 5            # stamped (worker): columnar pack
SEG_ROUTE = 6           # stamped (worker): shard routing
SEG_WORKER_OTHER = 7    # derived: unstamped time inside the worker phase
SEG_HANDOFF_WAIT = 8    # derived: worker done -> dispatcher first touch
SEG_SHM_COPY = 9        # stamped (dispatcher): shm slot -> private copy
SEG_VOCAB_REPLAY = 10   # stamped (dispatcher): vocab journal replay
SEG_LUT_REMAP = 11      # stamped (dispatcher): local->global LUT remap
SEG_DEVICE_FEED = 12    # stamped (dispatcher): ingest_fused dispatch wall
SEG_WAL_APPEND = 13     # stamped (dispatcher, via wal.py): append sans fsync
SEG_WAL_FSYNC = 14      # stamped (dispatcher, via wal.py): the fsync
SEG_DISPATCH_OTHER = 15  # derived: unstamped time inside dispatcher phase
SEG_ACK = 16            # derived: last stamped interval -> ack bookkeeping
SEG_RING_WAIT = 17      # stamped (worker): waiting on a free span-ring slot
SEG_COALESCE = 18       # stamped (dispatcher): multi-chunk concat+remap gather
N_SEGS = 19

SEG_NAMES = (
    "boundary", "enqueue", "queue_wait", "parse", "slot_wait", "pack",
    "route", "worker_other", "handoff_wait", "shm_copy", "vocab_replay",
    "lut_remap", "device_feed", "wal_append", "wal_fsync",
    "dispatch_other", "ack", "ring_wait", "coalesce",
)
_WAIT = frozenset((SEG_QUEUE_WAIT, SEG_SLOT_WAIT, SEG_WORKER_OTHER,
                   SEG_HANDOFF_WAIT, SEG_DISPATCH_OTHER, SEG_RING_WAIT))
SEG_KIND = tuple("wait" if i in _WAIT else "service" for i in range(N_SEGS))
_WORKER_SEGS = frozenset((SEG_PARSE, SEG_SLOT_WAIT, SEG_PACK, SEG_ROUTE,
                          SEG_RING_WAIT))

# -- shared-memory layout (int64 words) ----------------------------------
# header | calibration rows (main + one per worker) | slots
#
# slot: [state gen_d pid widx wire_t0 ack_t open_t flags n_d
#        d_intervals(3*MAX_D) gen_w n_w w_intervals(3*MAX_W) tenant]
# The main-side region (gen_d guards pid..d_intervals) and the worker
# region (gen_w guards n_w..w_intervals) have disjoint writers, so each
# keeps the single-writer seqlock invariant even while a worker packs
# the payload the dispatcher has not yet seen.

MAX_W_IV = 25   # 1 parse + 3 per chunk: covers 8 packed chunks
MAX_D_IV = 28   # enqueue + 3 per chunk + feed/wal stamps per flush

_ST_FREE, _ST_OPEN, _ST_DONE = 0, 1, 2

_OFF_STATE = 0
_OFF_GEN_D = 1
_OFF_PID = 2
_OFF_WIDX = 3
_OFF_WIRE_T0 = 4
_OFF_ACK_T = 5
_OFF_OPEN_T = 6
_OFF_FLAGS = 7
_OFF_N_D = 8
_OFF_D_IV = 9
_OFF_GEN_W = _OFF_D_IV + 3 * MAX_D_IV
_OFF_N_W = _OFF_GEN_W + 1
_OFF_W_IV = _OFF_N_W + 1
# tenant intern idx: written once at alloc while the slot is
# still FREE (invisible), so it needs no gen bracket of its own
_OFF_TENANT = _OFF_W_IV + 3 * MAX_W_IV
SLOT_WORDS = _OFF_TENANT + 1

_HDR_WORDS = 8
_CAL_WORDS = 4          # [gen, perf_counter_ns, time_ns, pad]
_MAGIC = 0x43504C44     # 'CPLD'

_FLAG_TRUNC_D = 1       # dispatcher region ran out of interval capacity
_FLAG_DEGRADED = 2      # timeline known-incomplete (fallback path touched it)

_TORN_RETRIES = 1000


def _now_ns() -> int:
    return time.perf_counter_ns()


class CritPathLedger:
    """Fixed-slot shm interval ledger. Create in the main process before
    the worker pool spawns; workers attach via :class:`CritPathWorkerView`
    with ``params()``. Slot lifecycle: FREE -> OPEN (``alloc``, boundary
    thread) -> DONE (``ack``, dispatcher) -> FREE (stitcher fold), or
    OPEN -> FREE (``abandon``: fallback/reclaim)."""

    def __init__(self, n_workers: int, slots: int = 256, *,
                 name: Optional[str] = None) -> None:
        from multiprocessing import shared_memory

        self.n_workers = int(n_workers)
        self.slots = int(slots)
        self._base = _HDR_WORDS + _CAL_WORDS * (self.n_workers + 1)
        words = self._base + self.slots * SLOT_WORDS
        if name is None:
            self._shm = shared_memory.SharedMemory(create=True, size=words * 8)
            self._owner = True
        else:  # attach (tests exercising cross-process views)
            self._shm = shared_memory.SharedMemory(name=name)
            self._owner = False
        self._a = np.frombuffer(self._shm.buf, np.int64, count=words)
        if self._owner:
            self._a[:] = 0
            self._a[0] = _MAGIC
            self._a[1] = self.slots
            self._a[2] = self.n_workers + 1
            self.calibrate()
        self._lock = threading.Lock()
        self._free: List[int] = list(range(self.slots - 1, -1, -1))
        self.alloc_failed = 0
        self.abandoned = 0
        self._closed = False

    def params(self) -> dict:
        """Spawn-safe attach info for :class:`CritPathWorkerView`."""
        return {"name": self._shm.name, "slots": self.slots,
                "n_workers": self.n_workers}

    # -- clock calibration ------------------------------------------------

    def calibrate(self) -> None:
        """Publish the main process's (mono, wall) pair (seqlocked)."""
        _write_cal(self._a, _HDR_WORDS)

    def _cal(self, row: int):
        return _read_cal(self._a, _HDR_WORDS + _CAL_WORDS * row)

    def worker_offset_ns(self, widx: int) -> int:
        """Additive correction mapping worker ``widx`` perf_counter_ns
        stamps into the main process's monotonic domain."""
        mono_m, wall_m = self._cal(0)
        mono_w, wall_w = self._cal(1 + widx)
        if mono_w == 0:  # worker never calibrated: assume shared clock
            return 0
        return (wall_w - mono_w) - (wall_m - mono_m)

    # -- slot lifecycle (main process only) -------------------------------

    def alloc(self, pid: int, widx: int, wire_t0_ns: int, tenant: int = 0) -> int:  # zt-lint: disable=ZT11 — the slot is FREE (invisible to readers) until the trailing _OFF_STATE=_ST_OPEN store publishes it; interval counts are RESET here, not mutated under readers, so no gen bracket applies
        """Claim a slot for payload ``pid`` routed to worker ``widx``.
        Returns -1 (trace skipped, counted) when the ledger is full."""
        with self._lock:
            if not self._free:
                self.alloc_failed += 1
                return -1
            s = self._free.pop()
        a, b = self._a, self._base + s * SLOT_WORDS
        a[b + _OFF_GEN_D] = 0
        a[b + _OFF_GEN_W] = 0
        a[b + _OFF_N_D] = 0
        a[b + _OFF_N_W] = 0
        a[b + _OFF_PID] = pid
        a[b + _OFF_WIDX] = widx
        a[b + _OFF_WIRE_T0] = wire_t0_ns
        a[b + _OFF_TENANT] = tenant
        a[b + _OFF_ACK_T] = 0
        a[b + _OFF_FLAGS] = 0
        a[b + _OFF_OPEN_T] = _now_ns()
        a[b + _OFF_STATE] = _ST_OPEN
        return s

    def stamp(self, slot: int, code: int, t0_ns: int, t1_ns: int, pid: int = -1) -> None:  # zt-dispatch-critical: appends one interval on the dispatcher/boundary hot path; seqlock bump + 3 word stores, no allocation
        if slot < 0 or self._closed:
            return
        a, b = self._a, self._base + slot * SLOT_WORDS
        if a[b + _OFF_STATE] != _ST_OPEN:
            return  # slot reclaimed out from under a straggler
        if pid >= 0 and a[b + _OFF_PID] != pid:
            return  # reclaimed AND reallocated: don't pollute the new owner
        n = int(a[b + _OFF_N_D])
        if n >= MAX_D_IV:
            a[b + _OFF_FLAGS] |= _FLAG_TRUNC_D
            return
        a[b + _OFF_GEN_D] += 1
        iv = b + _OFF_D_IV + 3 * n
        a[iv] = code
        a[iv + 1] = t0_ns
        a[iv + 2] = t1_ns
        a[b + _OFF_N_D] = n + 1
        a[b + _OFF_GEN_D] += 1

    def ack(self, slot: int, pid: int = -1, t_ns: int = 0) -> None:  # zt-dispatch-critical: final durable-ack stamp; two word stores
        if slot < 0 or self._closed:
            return
        a, b = self._a, self._base + slot * SLOT_WORDS
        if a[b + _OFF_STATE] != _ST_OPEN:
            return
        if pid >= 0 and a[b + _OFF_PID] != pid:
            return
        a[b + _OFF_ACK_T] = t_ns or _now_ns()
        a[b + _OFF_STATE] = _ST_DONE

    def flag_degraded(self, slot: int) -> None:
        if slot < 0 or self._closed:
            return
        b = self._base + slot * SLOT_WORDS
        with self._lock:
            self._a[b + _OFF_FLAGS] |= _FLAG_DEGRADED

    def abandon(self, slot: int) -> None:
        """Free an OPEN slot whose timeline will never complete."""
        if slot < 0 or self._closed:
            return
        b = self._base + slot * SLOT_WORDS
        with self._lock:
            if self._a[b + _OFF_STATE] != _ST_FREE:
                self._a[b + _OFF_STATE] = _ST_FREE
                self._free.append(slot)
                self.abandoned += 1

    def release(self, slot: int) -> None:
        """Return a folded DONE slot to the free list (stitcher only)."""
        b = self._base + slot * SLOT_WORDS
        with self._lock:
            if self._a[b + _OFF_STATE] == _ST_DONE:
                self._a[b + _OFF_STATE] = _ST_FREE
                self._free.append(slot)

    # -- reader side ------------------------------------------------------

    def state(self, slot: int) -> int:
        return int(self._a[self._base + slot * SLOT_WORDS + _OFF_STATE])

    def open_age_ns(self, slot: int, now_ns: int) -> int:
        b = self._base + slot * SLOT_WORDS
        return now_ns - int(self._a[b + _OFF_OPEN_T])

    def read_slot(self, slot: int) -> Optional[np.ndarray]:
        """Generation-consistent copy of one slot (both regions), or
        None if a writer kept it torn for the whole retry budget."""
        a, b = self._a, self._base + slot * SLOT_WORDS
        for _ in range(_TORN_RETRIES):
            gd = int(a[b + _OFF_GEN_D])
            gw = int(a[b + _OFF_GEN_W])
            if gd % 2 or gw % 2:
                continue
            blk = a[b:b + SLOT_WORDS].copy()
            if (int(a[b + _OFF_GEN_D]) == gd
                    and int(a[b + _OFF_GEN_W]) == gw):
                return blk
        return None

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        with self._lock:
            self._a = None
        self._shm.close()
        if self._owner:
            try:
                self._shm.unlink()
            except FileNotFoundError:  # pragma: no cover
                pass


def _write_cal(a: np.ndarray, off: int) -> None:
    a[off] += 1
    a[off + 1] = time.perf_counter_ns()
    a[off + 2] = time.time_ns()
    a[off] += 1


def _read_cal(a: np.ndarray, off: int):
    mono = wall = 0
    for _ in range(_TORN_RETRIES):
        g = int(a[off])
        mono, wall = int(a[off + 1]), int(a[off + 2])
        if g % 2 == 0 and int(a[off]) == g:
            break
    return mono, wall


class CritPathWorkerView:
    """The worker-process half of the ledger: calibration + worker-region
    stamps for slots handed to this worker. Single writer per region —
    a payload is owned by exactly one worker."""

    def __init__(self, params: dict, widx: int) -> None:
        from multiprocessing import shared_memory

        self.widx = int(widx)
        self._shm = shared_memory.SharedMemory(name=params["name"])
        base = _HDR_WORDS + _CAL_WORDS * (params["n_workers"] + 1)
        words = base + params["slots"] * SLOT_WORDS
        self._a = np.frombuffer(self._shm.buf, np.int64, count=words)
        self._base = base
        self._cal_off = _HDR_WORDS + _CAL_WORDS * (1 + self.widx)

    def calibrate(self) -> None:
        """Refresh this worker's clock pair; called per payload so the
        alignment bridge tracks NTP slew instead of drifting from it."""
        _write_cal(self._a, self._cal_off)

    def stamp(self, slot: int, code: int, t0_ns: int, t1_ns: int) -> None:  # zt-dispatch-critical: worker-region interval append on the parse hot path; seqlock bump + 3 word stores, no allocation
        if slot < 0:
            return
        a, b = self._a, self._base + slot * SLOT_WORDS
        n = int(a[b + _OFF_N_W])
        if n >= MAX_W_IV:
            return  # stitcher detects truncation via n_w at capacity
        a[b + _OFF_GEN_W] += 1
        iv = b + _OFF_W_IV + 3 * n
        a[iv] = code
        a[iv + 1] = t0_ns
        a[iv + 2] = t1_ns
        a[b + _OFF_N_W] = n + 1
        a[b + _OFF_GEN_W] += 1

    def close(self) -> None:
        self._a = None
        self._shm.close()


# -- dispatcher-thread active slot (wal.py stamps ride this) --------------

_active = threading.local()


def set_active(ledger: Optional[CritPathLedger], slot: int, pid: int) -> None:
    """Arm ``stamp_active`` for the current thread while a traced
    payload's device/durability feed runs (dispatcher's flush)."""
    _active.ledger = ledger if slot >= 0 else None
    _active.slot = slot
    _active.pid = pid
    _active.group = None


def set_active_group(ledger: Optional[CritPathLedger], pairs) -> None:  # zt-dispatch-critical: arms the coalesced-flush timeline map on the dispatch core
    """Arm ``stamp_active`` for a COALESCED flush: ``pairs`` is a list of
    ``(slot, pid)`` timelines sharing one device/WAL interval. Each
    traced member gets the same stamped wall window — the flush really
    did serve all of them at once, so per-timeline conservation holds."""
    pairs = [(s, p) for s, p in pairs if s >= 0]  # zt-lint: disable=ZT09 — per traced group MEMBER (≤ coalesce_max), tuple filter only
    _active.ledger = ledger if pairs else None
    _active.slot = -1
    _active.pid = -1
    _active.group = pairs or None


def clear_active() -> None:
    _active.ledger = None
    _active.slot = -1
    _active.group = None


def stamp_active(code: int, t0_ns: int, t1_ns: int) -> None:  # zt-dispatch-critical: no-op unless a traced payload is being flushed on this thread
    led = getattr(_active, "ledger", None)
    if led is None:
        return
    group = getattr(_active, "group", None)
    if group is None:
        led.stamp(_active.slot, code, t0_ns, t1_ns, _active.pid)
        return
    for slot, pid in group:  # zt-lint: disable=ZT09 — bounded by coalesce_max traced members, word stores only
        led.stamp(slot, code, t0_ns, t1_ns, pid)


def _pctl(sorted_vals: List[int], q: float) -> int:
    if not sorted_vals:
        return 0
    i = min(len(sorted_vals) - 1, int(q * (len(sorted_vals) - 1) + 0.5))
    return sorted_vals[i]


class CritPathStitcher:
    """Folds completed ledger slots into aggregate critical-path surfaces.

    Runs at windows-tick cadence (``on_tick``) and on-demand from the
    statusz/bench report path; both entrances serialize on one lock —
    nothing here touches the dispatch-critical path."""

    def __init__(self, ledger: CritPathLedger, *,
                 queue_capacity: int = 1,
                 recorder=None,
                 reclaim_age_s: float = 60.0,
                 gauge_stale_s: float = 60.0) -> None:
        self._ledger = ledger
        self._queue_capacity = max(1, int(queue_capacity))
        self._recorder = recorder
        self.emitter = None  # SelfSpanEmitter, attached by the server
        self._reclaim_age_ns = int(reclaim_age_s * 1e9)
        self._gauge_stale_ns = int(gauge_stale_s * 1e9)
        self._gauges_at_ns = 0
        self._lock = threading.Lock()
        self.seg_count = [0] * N_SEGS
        self.seg_sum_us = [0] * N_SEGS
        self.seg_max_us = [0] * N_SEGS
        self.timelines = 0
        self.degraded = 0
        self.truncated = 0
        self.reclaimed = 0
        self.wall_sum_us = 0
        self._walls: deque = deque(maxlen=16384)
        self._cons: deque = deque(maxlen=4096)
        self._last_ns = _now_ns()
        self.lambda_cps = 0.0
        self.little_l = 0.0
        self.worker_occupancy = 0.0
        self.queue_saturation = 0.0
        self._slowest: Optional[dict] = None

    def on_tick(self, _windows=None) -> None:
        self.stitch()

    # -- folding ----------------------------------------------------------

    def stitch(self) -> int:
        """Fold every DONE slot, reclaim orphaned OPEN slots, refresh the
        Little's-law gauges. Returns timelines folded."""
        with self._lock:
            return self._stitch_locked()

    def _stitch_locked(self) -> int:
        led = self._ledger
        now = _now_ns()
        folded = 0
        walls_us: List[int] = []
        qwait_us = 0
        wserv_us = 0
        slow: Optional[dict] = None
        for s in range(led.slots):
            st = led.state(s)
            if st == _ST_DONE:
                blk = led.read_slot(s)
                tl = self._fold(blk) if blk is not None else None
                led.release(s)
                if tl is None:
                    self.degraded += 1
                    continue
                folded += 1
                self.timelines += 1
                if tl["truncated"]:
                    self.truncated += 1
                durs = tl["durs_us"]
                for i in range(N_SEGS):
                    d = durs[i]
                    if d <= 0:
                        continue
                    self.seg_count[i] += 1
                    self.seg_sum_us[i] += d
                    if d > self.seg_max_us[i]:
                        self.seg_max_us[i] = d
                wall = tl["wall_us"]
                self.wall_sum_us += wall
                walls_us.append(wall)
                self._walls.append(wall)
                self._cons.append(tl["conservation"])
                qwait_us += (durs[SEG_QUEUE_WAIT] + durs[SEG_SLOT_WAIT]
                             + durs[SEG_RING_WAIT])
                wserv_us += (durs[SEG_PARSE] + durs[SEG_PACK]
                             + durs[SEG_ROUTE])
                if self._recorder is not None:
                    self._recorder.record_relayed(
                        "wire_to_durable", wall / 1e6
                    )
                if slow is None or wall > slow["wall_us"]:
                    slow = tl
            elif (st == _ST_OPEN
                    and led.open_age_ns(s, now) > self._reclaim_age_ns):
                led.abandon(s)
                self.reclaimed += 1
        # Little's law over this stitch window: L = lambda * W. The
        # gauges describe the most recent non-idle window; an idle tick
        # KEEPS them (a report-path stitch after a drained load is always
        # idle and would clobber the real window) and only a sustained idle spell past the
        # staleness horizon zeroes them, so a stale saturation reading
        # still cannot hold an SLO alert forever.
        dt_s = max(1e-9, (now - self._last_ns) / 1e9)
        self._last_ns = now
        if folded:
            lam = folded / dt_s
            mean_wall_s = (sum(walls_us) / folded) / 1e6
            self.lambda_cps = lam
            self.little_l = lam * mean_wall_s
            self.worker_occupancy = (
                lam * (wserv_us / folded) / 1e6 / led.n_workers
            )
            self.queue_saturation = (
                lam * (qwait_us / folded) / 1e6 / self._queue_capacity
            )
            self._gauges_at_ns = now
        elif (self._gauges_at_ns
                and now - self._gauges_at_ns > self._gauge_stale_ns):
            self.lambda_cps = 0.0
            self.little_l = 0.0
            self.worker_occupancy = 0.0
            self.queue_saturation = 0.0
        if slow is not None:
            self._slowest = slow
            if self.emitter is not None:
                try:
                    self.emitter.emit_spans(self._spans_for(slow))
                except Exception:  # pragma: no cover - surface never fatal
                    pass
        return folded

    def _fold(self, blk: np.ndarray) -> Optional[dict]:
        """One slot -> a timeline dict, or None when the slot cannot be
        decomposed (no ack, non-positive wall after alignment, flagged
        degraded by the fallback path)."""
        wire = int(blk[_OFF_WIRE_T0])
        ack = int(blk[_OFF_ACK_T])
        widx = int(blk[_OFF_WIDX])
        flags = int(blk[_OFF_FLAGS])
        if flags & _FLAG_DEGRADED or ack <= wire or wire <= 0:
            return None
        wall_ns = ack - wire
        off = self._ledger.worker_offset_ns(widx)
        n_d = min(int(blk[_OFF_N_D]), MAX_D_IV)
        n_w = min(int(blk[_OFF_N_W]), MAX_W_IV)
        truncated = bool(flags & _FLAG_TRUNC_D) or n_w >= MAX_W_IV
        ivs: List[tuple] = []
        for i in range(n_d):
            o = _OFF_D_IV + 3 * i
            ivs.append((int(blk[o]), int(blk[o + 1]), int(blk[o + 2])))
        for i in range(n_w):
            o = _OFF_W_IV + 3 * i
            ivs.append((int(blk[o]), int(blk[o + 1]) + off,
                        int(blk[o + 2]) + off))
        # raw service durations, with the two known nestings deduped:
        # wal stamps land inside the device_feed window (the WAL append
        # rides ingest_fused), so feed's own time excludes them
        durs_ns = [0] * N_SEGS
        for code, t0, t1 in ivs:
            if 0 <= code < N_SEGS and t1 > t0:
                durs_ns[code] += t1 - t0
        durs_ns[SEG_DEVICE_FEED] = max(
            0, durs_ns[SEG_DEVICE_FEED]
            - durs_ns[SEG_WAL_APPEND] - durs_ns[SEG_WAL_FSYNC]
        )
        # phase boundaries for gap classification
        w_ts = [(t0, t1) for c, t0, t1 in ivs if c in _WORKER_SEGS]
        d_ts = [(t0, t1) for c, t0, t1 in ivs
                if c not in _WORKER_SEGS and c != SEG_ENQUEUE]
        enq = [(t0, t1) for c, t0, t1 in ivs if c == SEG_ENQUEUE]
        enq_t0 = enq[0][0] if enq else wire
        w_t0 = min(t[0] for t in w_ts) if w_ts else 0
        w_t1 = max(t[1] for t in w_ts) if w_ts else 0
        d_t0 = min(t[0] for t in d_ts) if d_ts else 0
        d_t1 = max(t[1] for t in d_ts) if d_ts else 0
        # sweep the stamped intervals clipped to [wire, ack]; every
        # uncovered range is a derived wait, classified by phase
        clipped = sorted(
            (max(t0, wire), min(t1, ack)) for _, t0, t1 in ivs
        )
        cursor = wire
        for t0, t1 in clipped:
            if t0 > cursor:
                self._classify_gap(durs_ns, cursor, t0, enq_t0,
                                   w_ts, w_t0, w_t1, d_ts, d_t0, d_t1)
            if t1 > cursor:
                cursor = t1
        if cursor < ack:
            durs_ns[SEG_ACK] += ack - cursor
        durs_us = [d // 1000 for d in durs_ns]
        wall_us = wall_ns // 1000
        conservation = sum(durs_ns) / wall_ns
        return {
            "wall_us": wall_us,
            "conservation": conservation,
            "durs_us": durs_us,
            "pid": int(blk[_OFF_PID]),
            "widx": widx,
            "tenant": int(blk[_OFF_TENANT]),
            "wire_ns": wire,
            "ack_ns": ack,
            "intervals": ivs,
            "truncated": truncated,
        }

    @staticmethod
    def _classify_gap(durs_ns, a, b, enq_t0, w_ts, w_t0, w_t1,
                      d_ts, d_t0, d_t1) -> None:
        dur = b - a
        if b <= enq_t0:
            durs_ns[SEG_BOUNDARY] += dur
        elif w_ts and b <= w_t0:
            durs_ns[SEG_QUEUE_WAIT] += dur
        elif w_ts and a < w_t1:
            durs_ns[SEG_WORKER_OTHER] += dur
        elif d_ts and b <= d_t0:
            durs_ns[SEG_HANDOFF_WAIT] += dur
        elif d_ts and a < d_t1:
            durs_ns[SEG_DISPATCH_OTHER] += dur
        else:
            durs_ns[SEG_ACK] += dur

    # -- self-span emission ----------------------------------------------

    def _spans_for(self, tl: dict) -> list:
        """A slowest-chunk timeline as a root wire_to_durable span plus
        one child per stamped interval — retrievable in the server's own
        trace UI like any user trace."""
        from zipkin_tpu_torch.model import Endpoint, Span
        from zipkin_tpu_torch.obs.selfspans import SERVICE_NAME, _new_id

        mono_m, wall_m = self._ledger._cal(0)
        bridge_ns = wall_m - mono_m
        ep = Endpoint.create(service_name=SERVICE_NAME, ip="127.0.0.1")
        trace_id = _new_id()
        root_id = _new_id()
        root_ts = max(1, (tl["wire_ns"] + bridge_ns) // 1000)
        spans = [Span.create(
            trace_id=trace_id, id=root_id, name="wire_to_durable",
            timestamp=root_ts, duration=max(1, tl["wall_us"]),
            local_endpoint=ep,
            tags={
                "obs.critpath.conservation": "%.3f" % tl["conservation"],
                "obs.critpath.pid": str(tl["pid"]),
                "obs.critpath.worker": str(tl["widx"]),
                "obs.critpath.tenant": str(tl.get("tenant", 0)),
                "obs.critpath.queue_wait_us":
                    str(tl["durs_us"][SEG_QUEUE_WAIT]),
            },
        )]
        for code, t0, t1 in tl["intervals"]:
            if not (0 <= code < N_SEGS) or t1 <= t0:
                continue
            spans.append(Span.create(
                trace_id=trace_id, id=_new_id(), parent_id=root_id,
                name=SEG_NAMES[code],
                timestamp=max(1, (t0 + bridge_ns) // 1000),
                duration=max(1, (t1 - t0) // 1000),
                local_endpoint=ep,
                tags={"obs.critpath.kind": SEG_KIND[code]},
            ))
        return spans

    # -- surfaces ---------------------------------------------------------

    def counters(self) -> Dict[str, object]:
        """Flat gauges for the counter/SLO plane plus one nested
        segment table (scalar-only consumers skip it)."""
        with self._lock:
            cons = sorted(self._cons)
            segs = {
                SEG_NAMES[i]: {
                    "kind": SEG_KIND[i],
                    "count": self.seg_count[i],
                    "sumUs": self.seg_sum_us[i],
                    "maxUs": self.seg_max_us[i],
                }
                for i in range(N_SEGS)
            }
            return {
                "critpathTimelines": self.timelines,
                "critpathSkipped": self._ledger.alloc_failed,
                "critpathAbandoned": self._ledger.abandoned,
                "critpathReclaimed": self.reclaimed,
                "critpathDegraded": self.degraded,
                "critpathTruncated": self.truncated,
                "critpathLambdaCps": round(self.lambda_cps, 3),
                "critpathLittleL": round(self.little_l, 4),
                "critpathWorkerOccupancy": round(self.worker_occupancy, 4),
                "critpathQueueSaturation": round(self.queue_saturation, 4),
                "critpathConservationP50Milli": int(
                    _pctl(cons, 0.50) * 1000
                ),
                "critpathSegments": segs,
            }

    def waterfall(self) -> Dict[str, object]:
        """The statusz/bench report: wire-to-durable percentiles, the
        ordered segment decomposition, wait-vs-service rollup, gauges,
        and the slowest stitched timeline."""
        self.stitch()  # fold anything completed since the last tick
        with self._lock:
            walls = sorted(self._walls)
            cons = sorted(self._cons)
            wait_us = sum(self.seg_sum_us[i] for i in range(N_SEGS)
                          if SEG_KIND[i] == "wait")
            serv_us = sum(self.seg_sum_us[i] for i in range(N_SEGS)
                          if SEG_KIND[i] == "service")
            segments = [
                {
                    "segment": SEG_NAMES[i],
                    "kind": SEG_KIND[i],
                    "count": self.seg_count[i],
                    "sumUs": self.seg_sum_us[i],
                    "maxUs": self.seg_max_us[i],
                    "meanUs": round(
                        self.seg_sum_us[i] / max(1, self.seg_count[i]), 1
                    ),
                }
                for i in range(N_SEGS) if self.seg_count[i]
            ]
            slow = None
            if self._slowest is not None:
                tl = self._slowest
                slow = {
                    "wallUs": tl["wall_us"],
                    "pid": tl["pid"],
                    "worker": tl["widx"],
                    "conservation": round(tl["conservation"], 3),
                    "segments": [
                        {"segment": SEG_NAMES[i], "kind": SEG_KIND[i],
                         "us": tl["durs_us"][i]}
                        for i in range(N_SEGS) if tl["durs_us"][i] > 0
                    ],
                }
            return {
                "timelines": self.timelines,
                "skipped": self._ledger.alloc_failed,
                "abandoned": self._ledger.abandoned,
                "reclaimed": self.reclaimed,
                "degraded": self.degraded,
                "wireToDurable": {
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
                "queueWaitVsService": {
                    "waitUs": wait_us,
                    "serviceUs": serv_us,
                    "waitFraction": round(
                        wait_us / max(1, wait_us + serv_us), 4
                    ),
                },
                "littlesLaw": {
                    "lambdaCps": round(self.lambda_cps, 3),
                    "littleL": round(self.little_l, 4),
                    "workerOccupancy": round(self.worker_occupancy, 4),
                    "queueSaturation": round(self.queue_saturation, 4),
                },
                "segments": segments,
                "slowest": slow,
            }

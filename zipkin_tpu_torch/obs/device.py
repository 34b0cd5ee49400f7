"""Device-program observatory over CUDA events (the port's counterpart of
``zipkin_tpu/obs/device.py``, rewritten for the card).

Every device entry point of the aggregator (the ingest step variants, the
flush and rollup, the ``spmd_*`` reads) and the hand kernel itself
(``hll_update_step``, ``hll_update``) is wrapped in
:meth:`DeviceObservatory.wrap`, under the reference's program names, which
captures:

- **calls and the host wall of each call** (``callWallMs``,
  ``maxCallMs``): the Python the entry point runs, its launches and any
  host read inside it. Torch launches are asynchronous, so on the card this
  is mostly the host's enqueue cost, as the reference's dispatch wall is;
- **the per-call device wall**: on a CUDA device, a pair of
  ``torch.cuda.Event(enable_timing=True)`` recorded on the device's current
  stream before and after the call (the stream the step and the kernel
  launch on). The pairs wait in a bounded per-program queue and are
  resolved with ``Event.query()`` only when :meth:`status` or
  :meth:`programs` is read — the wrapper never synchronizes, so the
  asynchronous dispatch the ingest path relies on is untouched. A pair
  measures from the first to the last work the call queued, gaps
  included; queued work of other threads on the same stream lands inside
  it too;
- **compiles and recompiles**: the port's compile is the capture of a
  step variant's CUDA graph (``tpu/graphs.py``), as the reference's is a
  jit cache entry. Each capture counts one compile of that variant's
  ``spmd_step*`` program (:meth:`ProgramStats.compiled`, called by the
  aggregator for every capture, at boot or inside a step), with the
  capture's wall; a capture that a step had to make after the store's
  boot captures (``capture_steps``: a lane count off the ladder) also
  counts one recompile, the case the reference pages on after warm-up.
  For the hand kernel's wrappers ``compiles`` counts the first-use
  ``nvcc`` build of its library when a wrapped call ran it
  (``compile_probe``). Every other program compiles nothing. ``cost`` and
  ``memory`` are absent, as the reference leaves them when its analysis
  fails;
- **live device memory and host-transfer gauges**:
  ``torch.cuda.memory_stats()`` and ``torch.cuda.mem_get_info()`` on the
  card (``{}`` on the CPU), and the readpack transfer count and bytes.

An S-shard aggregator's program runs every shard inside one wrapped call
(one call a step or a read, as the reference's one SPMD program), and its
event pair is recorded on the first shard's device: on a mesh of several
cards the other cards' work shows only where the merge waits for it.

Counter updates are plain attribute writes: the aggregator's programs run
under its lock and these are debug gauges. The registry is process-global
and name-keyed; every aggregator wraps its own programs, so one name may
hold several builds — reads merge them. This is the one obs module that
uses torch, and it imports it at the first CUDA call, never at load.

**The step timeline** (:class:`StepTimeline`, ``OBSERVATORY.timeline``):
one bounded record per ingest step, the step's host spans and its device
intervals on the host's ``time.perf_counter_ns`` clock (the clock
``querytrace`` and ``critpath`` stamp). A record carries the step's batch
number (the store's ``host_counters["batches"]`` after the step, the
identifier all its spans share), its variant (``plain``, ``flush``,
``rollup``, ``flush_rollup``), whether a ``torch.profiler`` session was
active, and the spans of :data:`SPANS`, each ``(name, start, end, parent,
batch)``:

- ``ingest``, the root: ``TorchAggregator.ingest`` from entry to return
  (``ingest_fused`` for callers that enter there, as the fan-out tier
  does); its self time (its duration less its children) is the counters,
  the resident ranges and this timeline's own cost;
- ``route``: ``route_fused``;
- ``lock_wait``: the outermost wait on the aggregator's lock, as
  :class:`~zipkin_tpu_torch.obs.querytrace.InstrumentedRLock` measures it;
- ``upload``: staging the wire image into pinned memory and enqueueing its
  copy;
- ``replay``: the step graph's replay and its launch tally (on the CPU, the
  eager step).

On a card ``StepGraphs.step`` records three CUDA timing events on the
step's stream: before the copy is enqueued (after the staging), between
the copy and the replay, and after the replay. They give the
``h2d_copy`` and ``graph`` device intervals, and they feed the
``spmd_step*`` programs' ``deviceMs`` (the copy and the graph, without
the host staging), in place of the wrapper's event pair, which the read
programs keep. The ring holds :data:`TIMELINE_STEPS` steps; each slot owns
its three events and reuses them at every wrap, and
``TorchAggregator.capture_steps`` creates them at boot, so a step creates
no event. Events are resolved only when the timeline is read (a slot
overwritten unread counts in its program's ``eventsDropped``); the step
path never synchronizes. Under ``TPU_OBS=0`` it records nothing.

Device events reach the host clock through **anchors**: an event recorded
just after a sync the program already makes (``block_until_ready``, a
read's pull), beside the host time read at that moment; between two
anchors the mapping is linear. No copy can start on the card before the
host enqueued it, so the largest amount by which a mapped copy start lands
before its enqueue stamp is the mapping's error, reported as its
correction.

:func:`step_timeline` returns the newest steps with their mapped device
intervals; :func:`idle_gaps` names the card's idle gaps between them by the
deepest host span open when each gap ends (:data:`OUTSIDE` when none is).
An operator reads the summary of the newest 1,024 steps on ``/statusz``'s
``device.timeline`` (card idle share, idle seconds by host span, the
largest mapping correction) to see why the card sat idle: a share near 0
says the card sets the ingest rate; idle seconds under a span name the
host work it waited for.
"""

from __future__ import annotations

import bisect
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

from zipkin_tpu_torch.obs import querytrace

# unresolved event pairs a program keeps; past it the oldest is dropped
# (counted), so a program nobody reads holds bounded memory
EVENT_QUEUE = 4096


class ProgramStats:
    """Counters for one wrapped program build."""

    __slots__ = ("name", "calls", "compiles", "recompiles", "call_wall_s", "compile_wall_s",
                 "last_compile_s", "max_call_s", "device_ms", "device_calls",
                 "max_device_ms", "min_device_ms", "events_dropped", "_pending",
                 "_qlock", "_compile_probe", "events", "timeline_pending")

    def __init__(self, name: str, compile_probe: Optional[Callable[[], int]] = None,
                 events: bool = True) -> None:
        self.name = name
        self.calls = 0
        self.compiles = 0
        self.recompiles = 0
        self.call_wall_s = 0.0
        self.compile_wall_s = 0.0
        self.last_compile_s = 0.0
        self.max_call_s = 0.0
        self.device_ms = 0.0
        self.device_calls = 0
        self.max_device_ms = 0.0
        self.min_device_ms = 0.0
        self.events_dropped = 0
        self._pending: deque = deque()
        # the queue's drop in observe() and the peek-then-pop in resolve()
        # run on different threads (the caller's, statusz's)
        self._qlock = threading.Lock()
        self._compile_probe = compile_probe
        # False: the step timeline times the program's calls (its own events)
        self.events = events
        # the program's finished steps in the timeline not resolved yet
        self.timeline_pending = 0

    def compiled(self, n: int, wall_s: float, recompiles: int = 0) -> None:
        """``n`` compiles that took ``wall_s``, ``recompiles`` of them
        after warm-up."""
        self.compiles += n
        self.recompiles += recompiles
        self.compile_wall_s += wall_s
        self.last_compile_s = wall_s

    def observe(self, fn: Callable, device, args: tuple, kw: dict) -> Any:
        probe = self._compile_probe
        before = probe() if probe is not None else 0
        stream = None
        dev = _cuda_device(device, args) if self.events else None
        if dev is not None:
            import torch

            stream = torch.cuda.current_stream(dev)
            e0 = torch.cuda.Event(enable_timing=True)
            e0.record(stream)
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        dt = time.perf_counter() - t0
        if stream is not None:
            e1 = torch.cuda.Event(enable_timing=True)
            e1.record(stream)
            with self._qlock:
                if len(self._pending) >= EVENT_QUEUE:
                    self._pending.popleft()
                    self.events_dropped += 1
                self._pending.append((e0, e1))
        # a traced query's device_dispatch segment is this call's host wall
        # (perf_counter and perf_counter_ns share a clock)
        querytrace.stamp_active(querytrace.QSEG_DEVICE_DISPATCH, int(t0 * 1e9), int((t0 + dt) * 1e9))
        self.calls += 1
        self.call_wall_s += dt
        if dt > self.max_call_s:
            self.max_call_s = dt
        if probe is not None:
            built = probe() - before
            if built > 0:
                self.compiled(built, dt)
        return out

    def resolve(self) -> None:
        """Fold every finished event pair, oldest first, into the device
        wall; stop at the first unfinished one (a stream finishes in
        order). ``query()`` never blocks."""
        pending = self._pending
        while True:
            with self._qlock:
                if not pending or not pending[0][1].query():
                    return
                e0, e1 = pending.popleft()
            self.add_device_ms(float(e0.elapsed_time(e1)))

    def add_device_ms(self, ms: float) -> None:
        """Fold one call's device ms into the device wall."""
        if self.device_calls == 0 or ms < self.min_device_ms:
            self.min_device_ms = ms
        self.device_calls += 1
        self.device_ms += ms
        if ms > self.max_device_ms:
            self.max_device_ms = ms

    def reset(self) -> None:
        self.calls = self.compiles = self.recompiles = 0
        self.call_wall_s = self.compile_wall_s = self.last_compile_s = self.max_call_s = 0.0
        self.device_ms = self.max_device_ms = self.min_device_ms = 0.0
        self.device_calls = 0
        with self._qlock:
            # the drop count moves with the queue, under the queue's lock
            self.events_dropped = 0
            self._pending.clear()
        self.timeline_pending = 0

    def as_dict(self) -> Dict:
        return {
            "calls": self.calls,
            "compiles": self.compiles,
            "recompiles": self.recompiles,
            "callWallMs": round(self.call_wall_s * 1e3, 3),
            "compileWallMs": round(self.compile_wall_s * 1e3, 3),
            "lastCompileMs": round(self.last_compile_s * 1e3, 3),
            "maxCallMs": round(self.max_call_s * 1e3, 3),
            "deviceCalls": self.device_calls,
            "deviceMs": self.device_ms,
            "maxDeviceMs": self.max_device_ms,
            "minDeviceMs": self.min_device_ms,
            "eventsPending": len(self._pending) + self.timeline_pending,
            "eventsDropped": self.events_dropped,
        }


def _cuda_device(device, args: tuple):
    """The CUDA device a call runs on, or None (no events off the card).
    ``device`` is the one given at wrap time; without it, the first
    argument's ``.device`` (a kernel wrapper's register file)."""
    if device is None and args:
        device = getattr(args[0], "device", None)
    if device is None or getattr(device, "type", None) != "cuda":
        return None
    return device


# -- the step timeline ----------------------------------------------------

# ingest steps the timeline keeps
TIMELINE_STEPS = 4096
# the newest steps a summary reads
SUMMARY_STEPS = 1024
# the host spans of one ingest step, the root first (``ingest``, or
# ``ingest_fused`` for callers that enter there); a closed tuple, not
# flight-recorder stages
SPANS = ("ingest", "route", "lock_wait", "upload", "replay")
ROOT, ROUTE, LOCK_WAIT, UPLOAD, REPLAY = range(len(SPANS))
# the step variants, by 2 * (flush due) + (rollup due)
VARIANTS = ("plain", "flush", "rollup", "flush_rollup")
# the device intervals of a step on a card
INTERVALS = ("h2d_copy", "graph")
# an idle gap's name when no host span of the program is open at its end
OUTSIDE = "outside the program"
# anchors kept per card
ANCHORS = 256
# slots resolved in one hold of the timeline's lock (the step path's claim
# waits behind a hold)
RESOLVE_CHUNK = 64

_NO_SPANS = (0,) * (2 * len(SPANS))
_profiling: Optional[Callable[[], bool]] = None


def _profiler_active() -> bool:
    global _profiling
    if _profiling is None:
        import torch

        _profiling = torch._C._autograd._profiler_enabled
    return _profiling()


class Span(NamedTuple):
    """One host span of a step, on ``perf_counter_ns``."""
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[str]
    batch: int


class StepRecord:
    """One ingest step's slot in the timeline, written by the thread that
    runs the step (under the aggregator's lock from the lock wait on) and
    reused at every wrap. ``raw`` is the resolved device side: the copy's
    start in the card's anchor frame (ns; None without an anchor before
    it) and the copy's and the graph's ns, or :data:`_NO_DEVICE` where the
    step recorded no event."""

    __slots__ = ("timeline", "seq", "done", "root", "batch", "variant", "profiled", "ns",
                 "enqueue_ns", "device", "stream", "events", "stats", "raw")

    def __init__(self, timeline: "StepTimeline") -> None:
        self.timeline = timeline
        self.seq = -1
        self.done = False
        self.root = SPANS[ROOT]
        self.batch = 0
        self.variant = 0
        self.profiled = False
        self.ns = list(_NO_SPANS)
        self.enqueue_ns = 0
        self.device = None
        self.stream = None
        self.events = None
        self.stats: Optional[ProgramStats] = None
        self.raw = None

    def span(self, i: int, t0_ns: int, t1_ns: int) -> None:
        self.ns[2 * i] = t0_ns
        self.ns[2 * i + 1] = t1_ns

    def lock_wait(self, stamp: Optional[Tuple[int, int]]) -> None:
        """The outermost lock wait as the lock stamped it; one that began
        before this step's root is an enclosing hold's, not this step's."""
        if stamp is not None and stamp[0] >= self.ns[0]:
            self.span(LOCK_WAIT, stamp[0], stamp[1])

    def step(self, batch: int, variant: int, stats: ProgramStats) -> None:
        self.batch = batch
        self.variant = variant
        self.stats = stats

    def copy_begin(self, device) -> None:
        """Just before the step's copy is enqueued: the host's enqueue
        stamp, then the first event on the device's current stream."""
        import torch

        if self.events is None or self.device != device:
            self.events = _new_events()
            self.device = device
        self.stream = torch.cuda.current_stream(device)
        self.enqueue_ns = time.perf_counter_ns()
        self.events[0].record(self.stream)

    def copy_end(self) -> None:
        if self.stream is not None:
            self.events[1].record(self.stream)

    def graph_end(self) -> None:
        if self.stream is not None:
            self.events[2].record(self.stream)

    def end(self) -> None:
        """The root returns: the record is whole."""
        self.ns[2 * ROOT + 1] = time.perf_counter_ns()
        with self.timeline._lock:
            self.done = True
            if self.stream is None:
                self.raw = _NO_DEVICE
            elif self.stats is not None:
                self.stats.timeline_pending += 1


_NO_DEVICE = (None, None, None)


def _new_events() -> list:
    import torch

    return [torch.cuda.Event(enable_timing=True) for _ in range(3)]


class _AnchorChain:
    """One card's anchors: ``[host_ns, event, frame_ns]`` in the order they
    were taken. The frame is the card's event clock offset so that the
    first anchor's frame time is its host time; an anchor is placed in it
    (``frame_ns`` set) once it and the one before it have finished."""

    def __init__(self) -> None:
        self.items: deque = deque(maxlen=ANCHORS)

    def place(self) -> None:
        prev = None
        for item in self.items:
            if item[2] is None:
                if not item[1].query():
                    return
                item[2] = item[0] if prev is None else \
                    prev[2] + float(prev[1].elapsed_time(item[1])) * 1e6
            prev = item

    def frame(self, event, enqueue_ns: int) -> Optional[float]:
        """``event``'s frame time, measured from the newest placed anchor
        taken before ``enqueue_ns``; None when there is none."""
        for item in reversed(self.items):
            if item[2] is not None and item[0] <= enqueue_ns:
                return item[2] + float(item[1].elapsed_time(event)) * 1e6
        return None

    def points(self) -> List[Tuple[float, int]]:
        return [(item[2], item[0]) for item in self.items if item[2] is not None]


def map_clock(points: Sequence[Tuple[float, int]], frame_ns: float) -> float:
    """A card's frame time on ``perf_counter_ns``, piecewise linear through
    the anchors ``points`` ((frame ns, host ns), in order). Beyond the
    first or the last anchor it follows the rate between those two, the
    longest baseline (an anchor's own latency tilts a short segment); with
    one anchor, the card's own rate."""
    (f0, h0), (fn, hn) = points[0], points[-1]
    rate = (hn - h0) / (fn - f0) if fn > f0 else 1.0
    if frame_ns <= f0:
        return h0 + (frame_ns - f0) * rate
    if frame_ns >= fn:
        return hn + (frame_ns - fn) * rate
    i = bisect.bisect_right([p[0] for p in points], frame_ns) - 1
    (d0, g0), (d1, g1) = points[i], points[i + 1]
    return g0 + (frame_ns - d0) * (g1 - g0) / (d1 - d0)


def map_step(raw, points) -> list:
    """A resolved step's device intervals on ``perf_counter_ns``:
    ``[(name, start, end)]`` for :data:`INTERVALS`, or ``[]`` where the step
    has no device side or no anchor places it."""
    d0, copy_ns, graph_ns = raw
    if d0 is None or not points:
        return []
    t0, t1, t2 = (map_clock(points, d) for d in (d0, d0 + copy_ns, d0 + copy_ns + graph_ns))
    return [(INTERVALS[0], t0, t1), (INTERVALS[1], t1, t2)]


def union(intervals: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Intervals merged where they overlap, in order."""
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def deepest_open(spans: Sequence[Span], t: float, longest: float = float("inf")) -> str:
    """The deepest host span open at ``t`` (a root's child before the root;
    the latest begun among equals), or :data:`OUTSIDE`. ``spans`` are
    sorted by start; ``longest`` bounds their durations."""
    i = bisect.bisect_right(spans, t, key=lambda s: s.start_ns)
    best = None
    while i > 0:
        i -= 1
        s = spans[i]
        if s.start_ns < t - longest:
            break
        if t < s.end_ns and (best is None or (s.parent is not None and best.parent is None)):
            best = s
    return OUTSIDE if best is None else best.name


def idle_gaps(records: Sequence[dict]) -> Optional[dict]:
    """The card's idle gaps between the steps' device intervals, from the
    first copy's start to the last graph's end: ``window_s``, ``busy_s``,
    ``idle_share`` (1 - the union of the intervals over the window),
    ``gaps`` ``[(start_ns, end_ns, name)]`` each named by the deepest host
    span open when it ends (:data:`OUTSIDE` when none is), the idle
    seconds ``by_span``, and ``max_correction_ns``, the largest amount by
    which a mapped copy start lands before its host enqueue (0 when none
    does). None when no record has a device interval."""
    busy = union([(s, e) for r in records for _, s, e in r["device"]])
    if not busy:
        return None
    spans = sorted((s for r in records for s in r["spans"]), key=lambda s: s.start_ns)
    longest = max((s.end_ns - s.start_ns for s in spans), default=0)
    gaps, by_span = [], {}
    for (_, prev_end), (start, _) in zip(busy, busy[1:]):
        name = deepest_open(spans, start, longest)
        gaps.append((prev_end, start, name))
        by_span[name] = by_span.get(name, 0.0) + (start - prev_end) / 1e9
    window = busy[-1][1] - busy[0][0]
    busy_ns = sum(e - s for s, e in busy)
    return {
        "window_s": window / 1e9,
        "busy_s": busy_ns / 1e9,
        "idle_share": 1.0 - busy_ns / window if window > 0 else 0.0,
        "gaps": gaps,
        "by_span": by_span,
        "max_correction_ns": max([0.0] + [r["enqueue_ns"] - r["device"][0][1]
                                          for r in records if r["device"]]),
    }


class StepTimeline:
    """The ring of the newest :data:`TIMELINE_STEPS` ingest steps and each
    card's anchors. ``_lock`` orders a slot's claim, its end and its
    resolution; the fields between are the stepping thread's."""

    def __init__(self, steps: int = TIMELINE_STEPS) -> None:
        self._lock = threading.Lock()
        self._slots = [StepRecord(self) for _ in range(steps)]
        self._next = 0  # the sequence number of the next claim
        self._resolved_to = 0  # every step below it is resolved or gone
        self._anchors: Dict[Any, _AnchorChain] = {}

    def begin(self, root: str) -> StepRecord:
        """Claim the next slot for a step whose root opens now."""
        t0 = time.perf_counter_ns()
        profiled = _profiler_active()
        with self._lock:
            seq = self._next
            self._next = seq + 1
            rec = self._slots[seq % len(self._slots)]
            if rec.done and rec.raw is None and rec.stats is not None:
                # overwritten before anyone read it
                rec.stats.events_dropped += 1
                rec.stats.timeline_pending -= 1
            rec.seq = seq
            rec.done = False
            rec.stats = rec.raw = rec.stream = None
        rec.root = root
        rec.profiled = profiled
        rec.batch = rec.variant = rec.enqueue_ns = 0
        rec.ns[:] = _NO_SPANS
        rec.ns[0] = t0
        return rec

    def arm(self, device) -> None:
        """Give every slot its three events on ``device`` and record each
        once on its current stream, so that no step creates one (boot)."""
        import torch

        stream = torch.cuda.current_stream(device)
        for rec in self._slots:
            if rec.events is None:
                events = _new_events()
                for e in events:
                    e.record(stream)
                with self._lock:
                    rec.events, rec.device = events, device

    def anchor(self, device) -> None:
        """An anchor of ``device``'s event clock: call just after a sync of
        its current stream, when the event runs as soon as it is queued."""
        import torch

        if not torch.cuda.is_initialized():  # nothing ran on a card yet
            return
        event = torch.cuda.Event(enable_timing=True)
        stream = torch.cuda.current_stream(device)
        host_ns = time.perf_counter_ns()
        event.record(stream)
        with self._lock:
            chain = self._anchors.get(device)
            if chain is None:
                chain = self._anchors[device] = _AnchorChain()
            chain.place()
            chain.items.append([host_ns, event, None])

    def reset(self) -> None:
        """Forget every step (the slots keep their events, the cards their
        anchors)."""
        with self._lock:
            for rec in self._slots:
                rec.done = False
                rec.stats = rec.raw = rec.stream = None
            self._resolved_to = self._next

    def _resolve_one(self, rec: StepRecord) -> None:
        """Resolve a finished step's events if the card has run them
        (callers hold the lock)."""
        e0, e1, e2 = rec.events
        if not e2.query():
            return
        copy_ns = float(e0.elapsed_time(e1)) * 1e6
        graph_ns = float(e1.elapsed_time(e2)) * 1e6
        chain = self._anchors.get(rec.device)
        d0 = chain.frame(e0, rec.enqueue_ns) if chain is not None else None
        rec.raw = (d0, copy_ns, graph_ns)
        if rec.stats is not None:
            rec.stats.timeline_pending -= 1
            rec.stats.add_device_ms((copy_ns + graph_ns) / 1e6)

    def resolve(self) -> None:
        """Resolve every finished step the card has run, oldest first, a
        chunk of slots a hold of the lock; never blocks on the card."""
        with self._lock:
            for chain in self._anchors.values():
                chain.place()
            lo = max(self._resolved_to, self._next - len(self._slots))
        settled = True
        while True:
            with self._lock:
                lo = max(lo, self._next - len(self._slots))
                hi = min(self._next, lo + RESOLVE_CHUNK)
                if lo >= hi:
                    return
                for seq in range(lo, hi):
                    rec = self._slots[seq % len(self._slots)]
                    if rec.seq == seq and rec.done and rec.raw is None:
                        self._resolve_one(rec)
                    # the cursor stops at the first step still open or unrun
                    settled = settled and (rec.seq != seq or (rec.done and rec.raw is not None))
                    if settled:
                        self._resolved_to = seq + 1
            lo = hi

    def records(self, n: int = SUMMARY_STEPS) -> List[dict]:
        """The newest ``n`` whole steps, oldest first, each with its spans
        and its device intervals on ``perf_counter_ns``."""
        self.resolve()
        taken = []
        with self._lock:
            points = {d: c.points() for d, c in self._anchors.items()}
            seq = self._next - 1
            while seq >= max(0, self._next - len(self._slots)) and len(taken) < n:
                rec = self._slots[seq % len(self._slots)]
                if rec.seq == seq and rec.done:
                    taken.append((rec.root, rec.batch, rec.variant, rec.profiled, tuple(rec.ns),
                                  rec.enqueue_ns, rec.raw, rec.device))
                seq -= 1
        return [_as_record(*t, points.get(t[-1], [])) for t in reversed(taken)]

    def summary(self, n: int = SUMMARY_STEPS) -> Dict:
        """The newest ``n`` steps for ``/statusz``: the card's idle share
        and its idle seconds by host span between the steps' device
        intervals, and the largest mapping correction (None where no step
        has a device interval, as on the CPU)."""
        recs = self.records(n)
        gaps = idle_gaps(recs)
        return {
            "steps": len(recs),
            "stepsOnDevice": sum(1 for r in recs if r["device"]),
            "profiledSteps": sum(1 for r in recs if r["profiled"]),
            "cardIdleShare": None if gaps is None else gaps["idle_share"],
            "idleSecondsBySpan": {} if gaps is None else gaps["by_span"],
            "maxCorrectionUs": None if gaps is None else gaps["max_correction_ns"] / 1e3,
        }


def _as_record(root, batch, variant, profiled, ns, enqueue_ns, raw, device, points) -> dict:
    spans = []
    for i, name in enumerate(SPANS):
        t0, t1 = ns[2 * i], ns[2 * i + 1]
        if i == ROOT:
            spans.append(Span(root, t0, t1, None, batch))
        elif t1:
            spans.append(Span(name, t0, t1, root, batch))
    return {"batch": batch, "variant": VARIANTS[variant], "root": root, "profiled": profiled,
            "spans": spans, "enqueue_ns": enqueue_ns, "device": map_step(raw or _NO_DEVICE, points)}


class DeviceObservatory:
    """Process-global registry of wrapped device programs."""

    def __init__(self, enabled: bool = True) -> None:
        self._enabled = bool(enabled)
        self._lock = threading.Lock()
        self._programs: Dict[str, List[ProgramStats]] = {}
        self.timeline = StepTimeline()

    def wrap(self, name: str, fn: Callable, device=None,
             compile_probe: Optional[Callable[[], int]] = None, events: bool = True) -> Callable:
        """Wrap one device entry point; transparent when disabled.
        ``device`` (a ``torch.device``) is where its work runs: without it,
        the first argument's device. ``compile_probe`` returns a count that
        grows when the call built the kernel it launches. ``events=False``:
        no event pair around the call; the step timeline feeds its device
        wall."""
        entry = ProgramStats(name, compile_probe, events)
        with self._lock:
            self._programs.setdefault(name, []).append(entry)
        obs = self

        def wrapper(*args, **kw):
            if not obs._enabled:
                return fn(*args, **kw)
            return entry.observe(fn, device, args, kw)

        wrapper.__name__ = name
        wrapper.__wrapped__ = fn
        wrapper.program_stats = entry
        return wrapper

    # -- configuration -------------------------------------------------

    @property
    def enabled(self) -> bool:
        return self._enabled

    def set_enabled(self, on: bool) -> None:
        self._enabled = bool(on)

    def reset_counters(self) -> None:
        """Forget every entry's counters and pending events, and the
        timeline's steps; keeps wraps."""
        for e in self._entries():
            e.reset()
        self.timeline.reset()

    # -- the step timeline's write side ----------------------------------

    def begin_step(self, root: str) -> Optional[StepRecord]:
        """A new step's timeline record, or None when disabled."""
        if not self._enabled:
            return None
        return self.timeline.begin(root)

    def arm(self, device) -> None:
        """Make the timeline's events on ``device`` (a boot; nothing off a
        card or when disabled)."""
        if self._enabled and getattr(device, "type", None) == "cuda":
            self.timeline.arm(device)

    def anchor(self, device) -> None:
        """Take an anchor of ``device``'s event clock just after a sync the
        program made (nothing off a card or when disabled)."""
        if self._enabled and getattr(device, "type", None) == "cuda":
            self.timeline.anchor(device)

    # -- query side ----------------------------------------------------

    def _entries(self) -> List[ProgramStats]:
        with self._lock:
            return [e for lst in self._programs.values() for e in lst]

    def totals(self) -> Dict[str, int]:
        calls = compiles = recompiles = 0
        for e in self._entries():
            calls += e.calls
            compiles += e.compiles
            recompiles += e.recompiles
        return {"programs": len(self._programs), "calls": calls,
                "compiles": compiles, "recompiles": recompiles}

    def programs(self) -> Dict[str, Dict]:
        """Per-name merged view (several builds of one name sum up), with
        every finished event pair resolved first."""
        self.timeline.resolve()
        with self._lock:
            items = {k: list(v) for k, v in self._programs.items()}
            for entries in items.values():
                for e in entries:
                    e.resolve()
        out: Dict[str, Dict] = {}
        for name, entries in sorted(items.items()):
            merged: Dict = {
                "builds": len(entries), "calls": 0, "compiles": 0, "recompiles": 0,
                "callWallMs": 0.0, "compileWallMs": 0.0, "lastCompileMs": 0.0,
                "maxCallMs": 0.0, "deviceCalls": 0, "deviceMs": 0.0,
                "maxDeviceMs": 0.0, "minDeviceMs": 0.0, "eventsPending": 0,
                "eventsDropped": 0,
            }
            for e in entries:
                d = e.as_dict()
                for key in ("calls", "compiles", "recompiles", "deviceCalls", "eventsPending",
                            "eventsDropped"):
                    merged[key] += d[key]
                for key in ("callWallMs", "compileWallMs"):
                    merged[key] = round(merged[key] + d[key], 3)
                merged["deviceMs"] += d["deviceMs"]
                for key in ("lastCompileMs", "maxCallMs", "maxDeviceMs"):
                    merged[key] = max(merged[key], d[key])
                if d["deviceCalls"] and (merged["minDeviceMs"] == 0.0
                                         or d["minDeviceMs"] < merged["minDeviceMs"]):
                    merged["minDeviceMs"] = d["minDeviceMs"]
            merged["meanDeviceMs"] = (merged["deviceMs"] / merged["deviceCalls"]
                                      if merged["deviceCalls"] else 0.0)
            merged["deviceMs"] = round(merged["deviceMs"], 6)
            out[name] = merged
        return out

    def status(self) -> Dict:
        """Full dict for the ``/statusz`` device section (the reference's
        keys; the server adds :func:`timeline_summary` under
        ``timeline``)."""
        from zipkin_tpu_torch import readpack  # imports torch, as this read does

        return {
            "enabled": self._enabled,
            "analysis": False,  # no compiler analysis on the card
            "totals": self.totals(),
            "programs": self.programs(),
            "hbm": hbm_stats(),
            "transfers": {"count": readpack.transfer_count(),
                          "bytes": readpack.transfer_bytes()},
        }


def hbm_stats() -> Dict:
    """Live device memory of the visible cards from the caching allocator
    (``allocated_bytes.all.current`` and ``.peak``) and the CUDA runtime
    (``mem_get_info``: the card's total as the limit); ``{}`` when no card
    is in use (the store runs on the CPU)."""
    import sys

    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return {}
    in_use = limit = peak = seen = 0
    for d in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(d)
        if not stats:
            continue
        seen += 1
        in_use += int(stats.get("allocated_bytes.all.current", 0))
        peak += int(stats.get("allocated_bytes.all.peak", 0))
        limit += int(torch.cuda.mem_get_info(d)[1])
    if not seen:
        return {}
    return {"devices": seen, "bytesInUse": in_use, "bytesLimit": limit,
            "peakBytesInUse": peak}


def _env_on(name: str, default: str = "1") -> bool:
    return os.environ.get(name, default).strip().lower() not in ("0", "false", "no")


OBSERVATORY = DeviceObservatory(enabled=_env_on("TPU_OBS_DEVICE") and _env_on("TPU_OBS"))

wrap = OBSERVATORY.wrap


def step_timeline(n: int = SUMMARY_STEPS) -> List[dict]:
    """The newest ``n`` ingest steps of the process, oldest first: each a
    dict of ``batch``, ``variant``, ``root``, ``profiled`` (a
    ``torch.profiler`` session was active), ``spans`` (:class:`Span`),
    ``enqueue_ns`` (the host's stamp before the copy's enqueue) and
    ``device`` (``[(name, start_ns, end_ns)]`` for ``h2d_copy`` and
    ``graph`` on ``perf_counter_ns``; empty off a card)."""
    return OBSERVATORY.timeline.records(n)


def timeline_summary(n: int = SUMMARY_STEPS) -> Dict:
    """The ``/statusz`` summary of the newest ``n`` steps."""
    return OBSERVATORY.timeline.summary(n)

"""Slow-dispatch self-spans: the tracer dogfooding itself.

When a pipeline stage blows its budget, the recorder's slow hook hands
the event to a :class:`SelfSpanEmitter`, which publishes it as an
internal span for service ``zipkin-tpu-pipeline`` through the ordinary
collector path — so a slow fresh read is literally queryable as a
trace in the server's own UI.

B3 linkage: the self-tracing middleware sets :data:`CURRENT_B3` to the
(trace id, span id) of the enclosing HTTP self-span. Context vars
propagate through ``asyncio.to_thread`` (it copies the context), so a
storage stage that stalls while serving a request emits a span parented
under that request's own trace. Stages with no enclosing request
(sampler ticks, snapshot loops, the MP dispatcher) become roots.

The hook runs on the recording thread and only appends to a bounded
deque (GIL-atomic) behind a per-stage rate limit; a daemon drain thread
builds the spans and feeds the collector. The drain thread marks itself
suppressed while accepting so its own over-budget stages cannot re-emit
— the feedback loop is cut at the hook.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from contextvars import ContextVar
from typing import Dict, Optional, Tuple

from zipkin_tpu_torch.model import Endpoint, Span

# (trace_id, span_id) of the enclosing HTTP self-span, if any.
CURRENT_B3: ContextVar[Optional[Tuple[str, str]]] = ContextVar(
    "zipkin_tpu_obs_b3", default=None
)

SERVICE_NAME = "zipkin-tpu-pipeline"


def _new_id() -> str:
    return "%016x" % int.from_bytes(os.urandom(8), "big")


class SelfSpanEmitter:
    """Drains over-budget stage events into collector-accepted spans."""

    def __init__(self, collector, budget_scale: float = 1.0,
                 min_interval_s: float = 1.0, queue_size: int = 256) -> None:
        self._collector = collector
        self.budget_scale = float(budget_scale)
        self.min_interval_s = float(min_interval_s)
        self._queue: deque = deque(maxlen=queue_size)
        # pre-built spans from other planes (critpath slow-chunk
        # timelines): already Span objects, just need the suppressed
        # collector hand-off the drain thread provides
        self._prebuilt: deque = deque(maxlen=queue_size)
        self._last_emit: Dict[str, float] = {}
        self._suppress = threading.local()
        self._endpoint = Endpoint.create(service_name=SERVICE_NAME,
                                         ip="127.0.0.1")
        self._recorder = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.emitted = 0
        # brownout gate: the server sets the overload controller's
        # shed_observability, True when B1+ sheds expensive observability.
        # Gated events are counted and DROPPED — the slow ring and
        # /statusz keep recording (they are cheap); only the span
        # emission (a collector write competing with real traffic for
        # the device) goes overboard.
        self.gate = None
        self.shed = 0

    # -- wiring --------------------------------------------------------

    def install(self, recorder) -> None:
        """Arm ``recorder`` with scaled budgets and this emitter's hook."""
        self._recorder = recorder
        recorder.set_budget_scale(self.budget_scale)
        recorder.set_slow_hook(self._on_slow)
        self._thread = threading.Thread(
            target=self._drain_loop, name="obs-selfspans", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        if self._recorder is not None:
            self._recorder.set_slow_hook(None)
            self._recorder.set_budget_scale(1.0)
            self._recorder = None
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    # -- recording-thread side (the recorder's slow hook) --------------

    def _on_slow(self, event: Dict) -> None:
        ctx = CURRENT_B3.get()
        if ctx is not None:
            # Enrich in place: the recorder's ring entry gains the B3
            # ids too, so /statusz shows which trace hit the stall.
            event["traceId"], event["parentId"] = ctx
        if getattr(self._suppress, "on", False):
            return
        gate = self.gate
        if gate is not None and gate():
            self.shed += 1
            return
        now = time.monotonic()
        stage = event["stage"]
        last = self._last_emit.get(stage, 0.0)
        if now - last < self.min_interval_s:
            return
        self._last_emit[stage] = now
        self._queue.append(dict(event))

    def emit_spans(self, spans) -> None:
        """Queue already-built self-spans (e.g. a critpath timeline).

        Bounded append only — safe from any thread; the drain thread
        publishes them under the same suppression guard as slow-stage
        events, so the hand-off cannot re-trigger itself. Subject to
        the same brownout gate as slow-stage events: under B1+ the
        slowest-chunk timelines are shed, not queued.
        """
        gate = self.gate
        if gate is not None and gate():
            self.shed += len(spans)
            return
        for s in spans:
            self._prebuilt.append(s)

    # -- drain-thread side ---------------------------------------------

    def _drain_loop(self) -> None:
        while not self._stop.wait(0.05):
            self.flush()
        self.flush()

    def flush(self) -> int:
        """Publish every queued event now; returns spans emitted."""
        spans = []
        while True:
            try:
                ev = self._queue.popleft()
            except IndexError:
                break
            spans.append(self._span_for(ev))
        while True:
            try:
                spans.append(self._prebuilt.popleft())
            except IndexError:
                break
        if not spans:
            return 0
        self._suppress.on = True
        try:
            self._collector.accept(spans)
        except Exception:
            return 0
        finally:
            self._suppress.on = False
        self.emitted += len(spans)
        return len(spans)

    def _span_for(self, ev: Dict) -> Span:
        dur_us = max(1, int(ev["durUs"]))
        end_us = int(ev["tsUs"])
        return Span.create(
            trace_id=ev.get("traceId") or _new_id(),
            id=_new_id(),
            parent_id=ev.get("parentId"),
            name=ev["stage"],
            timestamp=max(1, end_us - dur_us),
            duration=dur_us,
            local_endpoint=self._endpoint,
            tags={
                "obs.stage": ev["stage"],
                "obs.budget_us": str(ev["budgetUs"]),
                "obs.thread": str(ev.get("thread", "")),
            },
        )

"""Self-tracing: the server traces its own request handling into itself
(the port's counterpart of ``zipkin_tpu/server/self_tracing.py``, which is
aiohttp middleware; here it wraps the standard library handler's request).

``SELF_TRACING_ENABLED`` records one SERVER span per handled request —
method, path and status tags, an ``error`` tag on a 5xx — sampled at
``SELF_TRACING_SAMPLE_RATE`` and stored through the ordinary collector
path, so self-spans are sampled and counted like any other span.

B3 propagation: ``X-B3-TraceId`` / ``X-B3-SpanId`` join the caller's
trace; without them a fresh trace id is minted. ``X-B3-Sampled`` follows
the B3 spec: ``0`` / ``false`` suppresses the self-span whatever the local
rate, ``1`` / ``true`` / ``d`` forces it.

While a request that is not suppressed runs, ``obs.selfspans.CURRENT_B3``
carries (trace id, self-span id) on its handler thread, so a pipeline stage
that goes over budget under it emits its slow-stage span into this trace.
"""

from __future__ import annotations

import random
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional

from zipkin_tpu_torch.collector.core import Collector, CollectorSampler
from zipkin_tpu_torch.model.span import Endpoint, Kind, Span
from zipkin_tpu_torch.obs.selfspans import CURRENT_B3

SERVICE_NAME = "zipkin-server"


def _new_id() -> str:
    return f"{random.getrandbits(64) or 1:016x}"


def _b3_sampled(header: Optional[str]) -> Optional[bool]:
    """Decode an ``X-B3-Sampled`` header: None when absent or garbage."""
    if header is None:
        return None
    value = header.strip().lower()
    if value in ("0", "false"):
        return False
    if value in ("1", "true", "d"):  # "d" = debug, implies sampled
        return True
    return None


class SelfTracer:
    """Wraps each request's handling; stores the spans on one thread of its
    own, so storing a span (which may reach the card) never holds up the
    answer."""

    def __init__(self, collector: Collector, sample_rate: float = 1.0) -> None:
        self._collector = collector
        self._sampler = CollectorSampler(sample_rate)
        self._endpoint = Endpoint.create(SERVICE_NAME)
        self._pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="self-tracing")

    def trace(self, method: str, path: str, headers, handle: Callable[[], int]) -> None:
        """Run ``handle`` (which answers the request and returns the status
        it sent) under the request's self-span."""
        trace_id = headers.get("X-B3-TraceId")
        parent_id: Optional[str] = headers.get("X-B3-SpanId")
        if not trace_id:
            trace_id, parent_id = _new_id(), None
        forced = _b3_sampled(headers.get("X-B3-Sampled"))
        span_id = _new_id()
        token = CURRENT_B3.set((trace_id, span_id)) if forced is not False else None
        start = time.time_ns() // 1000
        status = 500
        try:
            status = handle()
        finally:
            if token is not None:
                CURRENT_B3.reset(token)
            duration = max(time.time_ns() // 1000 - start, 1)
            try:
                span = Span.create(
                    trace_id=trace_id,
                    id=span_id,
                    parent_id=parent_id,
                    kind=Kind.SERVER,
                    name=f"{method.lower()} {path}",
                    timestamp=start,
                    duration=duration,
                    local_endpoint=self._endpoint,
                    tags={
                        "http.method": method,
                        "http.path": path,
                        "http.status_code": str(status),
                        **({"error": str(status)} if status >= 500 else {}),
                    },
                )
                # the caller's no-sample decision is honoured (B3 spec)
                if forced is True or (forced is None and self._sampler.test(span)):
                    self._pool.submit(self._collector.accept, [span])
            except Exception:  # self-tracing must never break serving
                pass

    def stop(self) -> None:
        """Store the spans still queued, then end the thread."""
        self._pool.shutdown(wait=True)

"""Collector core: the decode -> sample -> store pipeline every transport
uses (the port's copy of ``zipkin_tpu/collector/core.py:36-328``).

Reference semantics: ``zipkin2/collector/Collector.java``,
``CollectorSampler.java``, ``CollectorMetrics.java`` and
``InMemoryCollectorMetrics.java``. The counter taxonomy (messages,
messages_dropped, bytes, spans, spans_dropped) is kept name for name so
dashboards translate.

Sampling is boundary sampling: the decision is a pure function of the
trace id's low 64 bits, so every collector makes the same call for every
span of a trace without coordination.

With a multi-process tier (``mp_ingester``, :mod:`zipkin_tpu_torch.tpu.mp_ingest`)
and the line-rate path on, JSON v2 and proto3 payloads are handed to the
tier's parse workers without blocking and acknowledged on hand-off (the
reference's 202-on-enqueue); a full tier raises
:class:`~zipkin_tpu_torch.tpu.mp_ingest.IngestBackpressure`, counted as a
dropped message. The ``alloc`` resource site sits at the boundary: an
injected allocation failure is answered as the same backpressure.

An object-path decode is the flight recorder's ``parse`` stage, and a
``shadow`` (:class:`~zipkin_tpu_torch.obs.shadow.HostShadow`) is offered
the object path's sampled spans. A payload handed to the tier without a
server boundary's wire anchor (``critpath.WIRE_T0_NS``) is anchored at the
collector's entry, so direct callers get critical-path timelines too. Left
out, against the reference: overload and tenant admission.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Optional, Sequence

from zipkin_tpu_torch import faults, obs
from zipkin_tpu_torch.obs import critpath
from zipkin_tpu_torch.model import codec
from zipkin_tpu_torch.model.span import Span
from zipkin_tpu_torch.storage.spi import FastIngestError, StorageComponent
from zipkin_tpu_torch.storage.throttle import RejectedExecutionError
from zipkin_tpu_torch.tpu.mp_ingest import IngestBackpressure

logger = logging.getLogger(__name__)

_MAX_I64 = (1 << 63) - 1
# the wire formats the native parser takes
_FAST = (codec.Encoding.JSON_V2, codec.Encoding.PROTO3)


class CollectorSampler:
    """Samples traces at a fixed rate keyed on the trace id's low 64 bits.

    ``is_sampled`` compares ``abs(signed_low64(traceId))`` against
    ``rate * 2^63``, the reference's arithmetic, so a mixed fleet samples
    identically. Debug spans always pass."""

    def __init__(self, rate: float = 1.0) -> None:
        if not 0.0 <= rate <= 1.0:
            raise ValueError(f"rate should be between 0 and 1: {rate}")
        self.rate = rate
        self._boundary = int(_MAX_I64 * rate)

    def is_sampled(self, trace_id_low64: int, debug: bool = False) -> bool:
        if debug:
            return True
        signed = trace_id_low64 - (1 << 64) if trace_id_low64 >= (1 << 63) else trace_id_low64
        # Java parity: Long.MIN_VALUE maps to Long.MAX_VALUE before the
        # compare (abs() alone would overflow), so that id drops at every
        # rate below 1 like any id of the largest magnitude
        t = _MAX_I64 if signed == -(1 << 63) else abs(signed)
        return t <= self._boundary

    def test(self, span: Span) -> bool:
        return self.is_sampled(span.trace_id_low64, bool(span.debug))


class CollectorMetrics:
    """Counter hooks; subclass, or use :class:`InMemoryCollectorMetrics`."""

    def increment_messages(self) -> None: ...

    def increment_messages_dropped(self) -> None: ...

    def increment_bytes(self, quantity: int) -> None: ...

    def increment_spans(self, quantity: int) -> None: ...

    def increment_spans_dropped(self, quantity: int) -> None: ...

    def for_transport(self, transport: str) -> "CollectorMetrics":
        return self


class InMemoryCollectorMetrics(CollectorMetrics):
    """Thread-safe counters, partitioned per transport (children share one
    table and one lock)."""

    def __init__(self, transport: Optional[str] = None,
                 _counters: Optional[Dict[str, int]] = None, _lock=None) -> None:
        self.transport = transport
        self._counters: Dict[str, int] = _counters if _counters is not None else {}
        self._lock = _lock or threading.Lock()

    def _inc(self, name: str, by: int = 1) -> None:
        key = f"{self.transport}.{name}" if self.transport else name
        with self._lock:
            self._counters[key] = self._counters.get(key, 0) + by

    def increment_messages(self) -> None:
        self._inc("messages")

    def increment_messages_dropped(self) -> None:
        self._inc("messages_dropped")

    def increment_bytes(self, quantity: int) -> None:
        self._inc("bytes", quantity)

    def increment_spans(self, quantity: int) -> None:
        self._inc("spans", quantity)

    def increment_spans_dropped(self, quantity: int) -> None:
        self._inc("spans_dropped", quantity)

    def for_transport(self, transport: str) -> "InMemoryCollectorMetrics":
        return InMemoryCollectorMetrics(transport, self._counters, self._lock)

    def get(self, name: str, transport: Optional[str] = None) -> int:
        key = f"{transport}.{name}" if transport else name
        with self._lock:
            return self._counters.get(key, 0)

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counters)


class Collector:
    """The shared ingest pipeline: bytes or spans in, storage writes out.

    Errors while storing are counted as dropped spans and logged, never
    raised to the transport, except a throttle shed, which the transport
    turns into backpressure (HTTP 503)."""

    def __init__(self, storage: StorageComponent, *, sampler: Optional[CollectorSampler] = None,
                 metrics: Optional[CollectorMetrics] = None, fast_ingest: bool = False,
                 mp_ingester=None, shadow=None) -> None:
        self.storage = storage
        self.sampler = sampler or CollectorSampler(1.0)
        self.metrics = metrics or CollectorMetrics()
        # opt-in line-rate path: JSON v2 and proto3 bytes go straight to the
        # device store's native parser, without Span objects
        self.fast_ingest = fast_ingest and hasattr(storage, "ingest_json_fast")
        # the multi-process tier (tpu/mp_ingest.py): payloads go to its
        # parse workers and are acknowledged on hand-off; the tier counts
        # their spans through its own metrics as they land
        self.mp_ingester = mp_ingester
        # the accuracy plane's tap: the object path offers its sampled
        # spans, so the shadow sees what the device sketches see
        self.shadow = shadow
        self._consumer = storage.span_consumer()

    def accept_spans_bytes(self, data: bytes, encoding: Optional[codec.Encoding] = None) -> int:
        """Decode one transport message and ingest it; returns the spans
        accepted (after sampling); 0 for a payload the multi-process tier
        took, which accepts it asynchronously. Raises ``ValueError`` on a
        malformed payload, after counting the dropped message,
        ``RejectedExecutionError`` when the throttle sheds it and
        ``IngestBackpressure`` when the multi-process tier is full (or the
        ``alloc`` site fires), both counted as dropped messages."""
        self.metrics.increment_messages()
        self.metrics.increment_bytes(len(data))
        try:
            # an allocation failure at the boundary is answered as
            # backpressure: the sender retries instead of the server failing
            faults.resource_point("alloc")
        except MemoryError as e:
            self.metrics.increment_messages_dropped()
            raise IngestBackpressure(f"allocation failure: {e}") from e
        fast = self.fast_ingest and self._for_fast(data, encoding)
        if fast and self.mp_ingester is not None:
            # the tier is the line-rate path's scale-out, so it never takes
            # a payload when that path is off. Non-blocking: a full tier
            # answers at once. A malformed payload is counted and dropped
            # by the dispatcher, as an at-least-once transport would
            tok = None
            if critpath.WIRE_T0_NS.get() == 0:
                # a caller without a server boundary still gets timelines,
                # measured from here; reset, so a long-lived thread stamps
                # afresh for each payload
                tok = critpath.WIRE_T0_NS.set(time.perf_counter_ns())
            try:
                self.mp_ingester.submit(data, block=False)
            except IngestBackpressure:
                self.metrics.increment_messages_dropped()
                raise
            finally:
                if tok is not None:
                    critpath.WIRE_T0_NS.reset(tok)
            return 0
        if fast:
            try:
                result = self.storage.ingest_json_fast(data, self.sampler)
                if result is not None:
                    accepted, sample_dropped = result
                    self.metrics.increment_spans(accepted + sample_dropped)
                    if sample_dropped:
                        self.metrics.increment_spans_dropped(sample_dropped)
                    return accepted
            except RejectedExecutionError:
                # a shed on the fast path shows on the object path's counters
                self.metrics.increment_messages_dropped()
                raise
            except FastIngestError as e:
                # part of the payload may be stored: count it dropped, as
                # accept() does, and never ingest it a second time
                self.metrics.increment_spans(e.spans)
                self.metrics.increment_spans_dropped(e.spans)
                logger.exception("cannot store %d spans", e.spans)
                return 0
            except ValueError:
                pass  # the parse refused it: the Python codec owns error reporting
        try:
            t0 = time.perf_counter()
            spans = codec.decode_spans(data, encoding)
            obs.record("parse", time.perf_counter() - t0)
        except Exception as e:
            self.metrics.increment_messages_dropped()
            raise ValueError(f"cannot decode spans: {e}") from e
        return self.accept(spans)

    @staticmethod
    def _for_fast(data: bytes, encoding: Optional[codec.Encoding]) -> bool:
        """Whether the native parser's formats include this payload's; an
        unrecognized one is left to the object path's error reporting."""
        if encoding is not None:
            return encoding in _FAST
        try:
            return codec.detect(data) in _FAST
        except ValueError:
            return False

    def accept(self, spans: Sequence[Span]) -> int:
        """Sample and store decoded spans; returns the count accepted."""
        if not spans:
            return 0
        self.metrics.increment_spans(len(spans))
        sampled: List[Span] = [s for s in spans if self.sampler.test(s)]
        dropped = len(spans) - len(sampled)
        if dropped:
            self.metrics.increment_spans_dropped(dropped)
        if not sampled:
            return 0
        if self.shadow is not None:
            self.shadow.offer_spans(sampled)
        try:
            self._consumer.accept(sampled).execute()
        except RejectedExecutionError:
            # backpressure reaches the transport so senders back off (the
            # reference maps RejectedExecutionException to 503)
            self.metrics.increment_spans_dropped(len(sampled))
            raise
        except Exception:
            self.metrics.increment_spans_dropped(len(sampled))
            logger.exception("cannot store %d spans", len(sampled))
            return 0
        return len(sampled)

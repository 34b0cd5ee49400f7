"""Bounded-concurrency storage wrapper — the backpressure mechanism (the
port's copy of ``zipkin_tpu/storage/throttle.py``).

Reference semantics: ``zipkin-server/.../internal/throttle/
ThrottledStorageComponent.java`` and ``ThrottledCall.java`` (SURVEY.md §2.4,
§5): wrap every storage call in a semaphore with a bounded wait queue; when
the queue is full the call is rejected immediately (shed load) rather than
piling up until the process dies. The collector counts the rejection as
dropped spans and the transport backs off.
"""

from __future__ import annotations

import threading
from typing import List, Sequence

from zipkin_tpu_torch.model.span import DependencyLink, Span
from zipkin_tpu_torch.storage.spi import (
    AutocompleteTags,
    QueryRequest,
    ServiceAndSpanNames,
    SpanConsumer,
    SpanStore,
    StorageComponent,
)
from zipkin_tpu_torch.utils.call import Call
from zipkin_tpu_torch.utils.component import CheckResult


class RejectedExecutionError(RuntimeError):
    """The throttle's wait queue is full; shed the work."""


class _Throttle:
    def __init__(self, max_concurrency: int, max_queue: int) -> None:
        self._semaphore = threading.BoundedSemaphore(max_concurrency)
        self._queue_slots = threading.BoundedSemaphore(max(max_queue, 1))
        # overload signal for the sampling tier: when armed (see
        # ThrottledStorage.set_pressure_delegate), every rejection also
        # tells the rate controller to tighten per-service keep rates —
        # degradation order is "sample harder" BEFORE "shed at the door"
        self.on_reject = None

    def run(self, fn):
        if not self._queue_slots.acquire(blocking=False):
            cb = self.on_reject
            if cb is not None:
                try:
                    cb()
                except Exception:  # a signal, never a second failure
                    pass
            raise RejectedExecutionError("storage throttle queue is full")
        try:
            with self._semaphore:
                return fn()
        finally:
            self._queue_slots.release()


class _ThrottledCall(Call):
    def __init__(self, delegate: Call, throttle: _Throttle) -> None:
        super().__init__()
        self._delegate = delegate
        self._throttle = throttle

    def _do_execute(self):
        return self._throttle.run(self._delegate.execute)

    def _clone_impl(self) -> "Call":
        return _ThrottledCall(self._delegate.clone(), self._throttle)


class ThrottledStorage(StorageComponent):
    """Delegates everything, wrapping calls in the shared throttle."""

    def __init__(
        self,
        delegate: StorageComponent,
        *,
        max_concurrency: int = 8,
        max_queue: int = 100,
    ) -> None:
        self.delegate = delegate
        self.strict_trace_id = delegate.strict_trace_id
        self.search_enabled = delegate.search_enabled
        self.autocomplete_keys = delegate.autocomplete_keys
        self._throttle = _Throttle(max_concurrency, max_queue)
        # auto-wire the overload signal when the wrapped storage carries a
        # rate controller (the device store with a sampling budget set)
        controller = getattr(delegate, "sampling_controller", None)
        if controller is not None:
            self.set_pressure_delegate(controller.note_pressure)

    def set_pressure_delegate(self, callback) -> None:
        """Arm ``callback`` to fire on every throttle rejection (the
        sampling tier's RateController.note_pressure). Pass ``None`` to
        disarm."""
        self._throttle.on_reject = callback

    def _wrap(self, call: Call) -> Call:
        return _ThrottledCall(call, self._throttle)

    def __getattr__(self, name: str):
        # Forward non-SPI extensions (e.g. the device store's
        # latency_quantiles / trace_cardinalities / ingest_counters) so
        # wrapping a storage in the throttle doesn't hide its read surface.
        if name == "delegate":  # not yet set during __init__
            raise AttributeError(name)
        attr = getattr(self.delegate, name)
        if name == "ingest_json_fast":
            # The collector probes hasattr(storage, "ingest_json_fast") and
            # then bypasses span_consumer(): the fast path must still pay
            # the limiter, or fast ingest under the throttle would quietly
            # lose its backpressure.
            throttle = self._throttle

            def _throttled_fast(*args, **kwargs):
                return throttle.run(lambda: attr(*args, **kwargs))

            return _throttled_fast
        return attr

    def span_consumer(self) -> SpanConsumer:
        inner = self.delegate.span_consumer()
        outer = self

        class _Consumer(SpanConsumer):
            def accept(self, spans: Sequence[Span]) -> Call[None]:
                return outer._wrap(inner.accept(spans))

        return _Consumer()

    def span_store(self) -> SpanStore:
        inner = self.delegate.span_store()
        outer = self

        class _Store(SpanStore):
            def get_trace(self, trace_id: str) -> Call[List[Span]]:
                return outer._wrap(inner.get_trace(trace_id))

            def get_traces(self, trace_ids) -> Call[List[List[Span]]]:
                return outer._wrap(inner.get_traces(trace_ids))

            def get_traces_query(self, request: QueryRequest) -> Call[List[List[Span]]]:
                return outer._wrap(inner.get_traces_query(request))

            def get_dependencies(
                self, end_ts: int, lookback: int, **kwargs
            ) -> Call[List[DependencyLink]]:
                # kwargs carries non-SPI extensions (a per-request
                # staleness bound)
                return outer._wrap(
                    inner.get_dependencies(end_ts, lookback, **kwargs)
                )

        return _Store()

    def traces(self):
        return self.span_store()

    def service_and_span_names(self) -> ServiceAndSpanNames:
        inner = self.delegate.service_and_span_names()
        outer = self

        class _Names(ServiceAndSpanNames):
            def get_service_names(self):
                return outer._wrap(inner.get_service_names())

            def get_remote_service_names(self, service_name: str):
                return outer._wrap(inner.get_remote_service_names(service_name))

            def get_span_names(self, service_name: str):
                return outer._wrap(inner.get_span_names(service_name))

        return _Names()

    def autocomplete_tags(self) -> AutocompleteTags:
        inner = self.delegate.autocomplete_tags()
        outer = self

        class _Tags(AutocompleteTags):
            def get_keys(self):
                return outer._wrap(inner.get_keys())

            def get_values(self, key: str):
                return outer._wrap(inner.get_values(key))

        return _Tags()

    def check(self) -> CheckResult:
        return self.delegate.check()

    def close(self) -> None:
        self.delegate.close()

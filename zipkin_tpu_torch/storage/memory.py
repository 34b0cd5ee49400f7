"""The exact in-memory storage oracle.

The port's own copy of ``zipkin_tpu/storage/memory.py``: imports point at
``zipkin_tpu_torch``; the semantics are the reference's.

Reference semantics: ``zipkin2/storage/InMemoryStorage.java`` (SURVEY.md
§2.1) — the parity oracle every other backend (including the TPU store) is
tested against. Bounded by ``max_span_count``: when exceeded, whole traces
are evicted oldest-first. Dependency links are computed online through
:class:`~zipkin_tpu_torch.internal.dependency_linker.DependencyLinker` (§3.5).

Ordering contract: ``get_traces_query`` returns traces ordered by their most
recent span activity, newest first, with ``limit`` applied after filtering.
Duplicate span reports are merged at read time (``Trace.merge`` semantics).
"""

from __future__ import annotations

import heapq
import threading
from typing import Dict, List, Sequence, Set, Tuple

from zipkin_tpu_torch.internal.dependency_linker import DependencyLinker
from zipkin_tpu_torch.internal.span_node import merge_trace
from zipkin_tpu_torch.model.span import DependencyLink, Span
from zipkin_tpu_torch.storage.spi import (
    AutocompleteTags,
    QueryRequest,
    ServiceAndSpanNames,
    SpanConsumer,
    SpanStore,
    StorageComponent,
    trace_id_key,
)
from zipkin_tpu_torch.utils.call import Call
from zipkin_tpu_torch.utils.component import CheckResult


class InMemoryStorage(
    StorageComponent, SpanConsumer, SpanStore, ServiceAndSpanNames, AutocompleteTags
):
    def __init__(
        self,
        *,
        max_span_count: int = 500_000,
        strict_trace_id: bool = True,
        search_enabled: bool = True,
        autocomplete_keys: Sequence[str] = (),
    ) -> None:
        self.max_span_count = max_span_count
        self.strict_trace_id = strict_trace_id
        self.search_enabled = search_enabled
        self.autocomplete_keys = tuple(autocomplete_keys)
        self._lock = threading.Lock()
        self._spans_by_trace: Dict[str, List[Span]] = {}
        self._age_heap: List[Tuple[int, str]] = []
        self._min_ts: Dict[str, int] = {}
        self._span_count = 0
        self._closed = False

    # -- factories ---------------------------------------------------------

    def span_consumer(self) -> SpanConsumer:
        return self

    def span_store(self) -> SpanStore:
        return self

    def service_and_span_names(self) -> ServiceAndSpanNames:
        return self

    def autocomplete_tags(self) -> AutocompleteTags:
        return self

    def check(self) -> CheckResult:
        if self._closed:
            return CheckResult.failed(RuntimeError("closed"))
        return CheckResult.OK  # type: ignore[attr-defined]

    def close(self) -> None:
        self._closed = True

    def clear(self) -> None:
        with self._lock:
            self._spans_by_trace.clear()
            self._age_heap.clear()
            self._min_ts.clear()
            self._span_count = 0

    # -- write path --------------------------------------------------------

    def accept(self, spans: Sequence[Span]) -> Call[None]:
        def run() -> None:
            with self._lock:
                for span in spans:
                    key = trace_id_key(span.trace_id, self.strict_trace_id)
                    ts = span.timestamp_as_long()
                    bucket = self._spans_by_trace.get(key)
                    if bucket is None:
                        bucket = self._spans_by_trace[key] = []
                    # Eviction key is the trace's MIN span timestamp,
                    # updated continuously: the reference indexes every
                    # accepted span as a (timestamp, traceId) pair, so a
                    # late span with an earlier timestamp makes its trace
                    # MORE evictable. Stale heap entries are skipped
                    # lazily on pop.
                    cur = self._min_ts.get(key)
                    if cur is None or ts < cur:
                        self._min_ts[key] = ts
                        heapq.heappush(self._age_heap, (ts, key))
                    bucket.append(span)
                    self._span_count += 1
                self._evict_locked()

        return Call.of(run)

    # zt-lint: disable=ZT04 — the _locked suffix is the contract: the
    # sole caller (accept's run closure) already holds self._lock
    def _evict_locked(self) -> None:
        """Drop whole traces, oldest first, until under the bound.

        Amortized O(evicted log T): entries for already-evicted traces or
        superseded (stale) timestamps are skipped lazily.
        """
        while self._span_count > self.max_span_count and self._age_heap:
            ts, key = heapq.heappop(self._age_heap)
            if self._min_ts.get(key) != ts:
                continue  # stale entry: trace gone or re-keyed older
            spans = self._spans_by_trace.pop(key, None)
            del self._min_ts[key]
            if spans is not None:
                self._span_count -= len(spans)

    # -- read path ---------------------------------------------------------

    def get_trace(self, trace_id: str) -> Call[List[Span]]:
        def run() -> List[Span]:
            with self._lock:
                key = trace_id_key(trace_id, self.strict_trace_id)
                result = list(self._spans_by_trace.get(key, ()))
            return merge_trace(result)

        return Call.of(run)

    def get_traces(self, trace_ids: Sequence[str]) -> Call[List[List[Span]]]:
        def run() -> List[List[Span]]:
            out: List[List[Span]] = []
            with self._lock:
                seen: Set[str] = set()
                for trace_id in trace_ids:
                    key = trace_id_key(trace_id, self.strict_trace_id)
                    if key in seen:
                        continue
                    seen.add(key)
                    spans = self._spans_by_trace.get(key)
                    if spans:
                        out.append(merge_trace(spans))
            return out

        return Call.of(run)

    def get_traces_query(self, request: QueryRequest) -> Call[List[List[Span]]]:
        def run() -> List[List[Span]]:
            if not self.search_enabled:
                return []
            with self._lock:
                traces = [list(v) for v in self._spans_by_trace.values()]
            traces.sort(key=_trace_ts, reverse=True)
            out: List[List[Span]] = []
            for spans in traces:
                merged = merge_trace(spans)
                if request.test(merged):
                    out.append(merged)
                    if len(out) >= request.limit:
                        break
            return out

        return Call.of(run)

    def get_dependencies(self, end_ts: int, lookback: int) -> Call[List[DependencyLink]]:
        def run() -> List[DependencyLink]:
            window = QueryRequest(end_ts=end_ts, lookback=lookback, limit=2**31 - 1)
            linker = DependencyLinker()
            with self._lock:
                traces = [list(v) for v in self._spans_by_trace.values()]
            for spans in traces:
                merged = merge_trace(spans)
                if _in_window(merged, window):
                    linker.put_trace(merged)
            return linker.link()

        return Call.of(run)

    # -- names -------------------------------------------------------------

    def get_service_names(self) -> Call[List[str]]:
        def run() -> List[str]:
            if not self.search_enabled:
                return []
            names: Set[str] = set()
            with self._lock:
                for spans in self._spans_by_trace.values():
                    for s in spans:
                        if s.local_service_name:
                            names.add(s.local_service_name)
            return sorted(names)

        return Call.of(run)

    def get_remote_service_names(self, service_name: str) -> Call[List[str]]:
        def run() -> List[str]:
            if not self.search_enabled or not service_name:
                return []
            want = service_name.lower()
            names: Set[str] = set()
            with self._lock:
                for spans in self._spans_by_trace.values():
                    for s in spans:
                        if s.local_service_name == want and s.remote_service_name:
                            names.add(s.remote_service_name)
            return sorted(names)

        return Call.of(run)

    def get_span_names(self, service_name: str) -> Call[List[str]]:
        def run() -> List[str]:
            if not self.search_enabled or not service_name:
                return []
            want = service_name.lower()
            names: Set[str] = set()
            with self._lock:
                for spans in self._spans_by_trace.values():
                    for s in spans:
                        if s.local_service_name == want and s.name:
                            names.add(s.name)
            return sorted(names)

        return Call.of(run)

    # -- autocomplete ------------------------------------------------------

    def get_keys(self) -> Call[List[str]]:
        return Call.constant(list(self.autocomplete_keys))

    def get_values(self, key: str) -> Call[List[str]]:
        def run() -> List[str]:
            if key not in self.autocomplete_keys:
                return []
            values: Set[str] = set()
            with self._lock:
                for spans in self._spans_by_trace.values():
                    for s in spans:
                        v = s.tags.get(key)
                        if v:
                            values.add(v)
            return sorted(values)

        return Call.of(run)

    # -- introspection -----------------------------------------------------

    @property
    def span_count(self) -> int:
        return self._span_count

    def get_all_traces(self) -> List[List[Span]]:
        with self._lock:
            return [merge_trace(v) for v in self._spans_by_trace.values()]


def _trace_ts(spans: Sequence[Span]) -> int:
    """A trace's recency: its max span timestamp (0 when none)."""
    return max((s.timestamp_as_long() for s in spans), default=0)


def _in_window(spans: Sequence[Span], request: QueryRequest) -> bool:
    ts = 0
    for span in spans:
        if span.timestamp is not None:
            ts = span.timestamp if ts == 0 else min(ts, span.timestamp)
    return ts != 0 and request.min_ts <= ts <= request.max_ts

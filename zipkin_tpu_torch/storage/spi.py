"""The storage SPI: the seam between collectors/server and any backend.

The port's own copy of ``zipkin_tpu/storage/spi.py``: imports point at
``zipkin_tpu_torch``; the semantics are the reference's.

Reference semantics: ``zipkin2/storage/StorageComponent.java``,
``SpanConsumer.java``, ``SpanStore.java``, ``Traces.java``,
``ServiceAndSpanNames.java``, ``AutocompleteTags.java``,
``QueryRequest.java`` and the result-shaping helpers ``StrictTraceId`` /
``GroupByTraceId`` (SURVEY.md §2.3). Every read/write returns a lazy
:class:`~zipkin_tpu_torch.utils.call.Call` so backends may defer I/O, the throttle
can wrap them, and callers can retry via ``clone()``.

Key semantic: ``strict_trace_id=False`` makes 128-bit and 64-bit renditions
of the same trace id match on the low 64 bits — needed during instrumentation
migrations. Backends index by low-64 and post-filter when strict.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence

from zipkin_tpu_torch.internal.hex import lower_64, normalize_trace_id
from zipkin_tpu_torch.model.span import DependencyLink, Span
from zipkin_tpu_torch.utils.call import Call
from zipkin_tpu_torch.utils.component import Component


@dataclasses.dataclass(frozen=True)
class QueryRequest:
    """Trace search criteria, with the oracle predicate :meth:`test`.

    Times are epoch **milliseconds** (``end_ts``/``lookback``), durations
    **microseconds** — the same split the reference uses.
    """

    end_ts: int
    lookback: int
    limit: int = 10
    service_name: Optional[str] = None
    remote_service_name: Optional[str] = None
    span_name: Optional[str] = None
    annotation_query: Mapping[str, str] = dataclasses.field(default_factory=dict)
    min_duration: Optional[int] = None
    max_duration: Optional[int] = None

    def __post_init__(self) -> None:
        if self.end_ts <= 0:
            raise ValueError("endTs must be positive")
        if self.lookback <= 0:
            raise ValueError("lookback must be positive")
        if self.limit <= 0:
            raise ValueError("limit must be positive")
        if self.max_duration is not None:
            if self.min_duration is None:
                raise ValueError("minDuration is required when specifying maxDuration")
            if self.max_duration < self.min_duration:
                raise ValueError("maxDuration must be >= minDuration")
        if self.min_duration is not None and self.min_duration <= 0:
            raise ValueError("minDuration must be positive")
        # normalize names like the reference builder does
        for field in ("service_name", "remote_service_name", "span_name"):
            value = getattr(self, field)
            if value is not None:
                lowered = value.lower()
                if lowered in ("", "all"):
                    lowered = None
                object.__setattr__(self, field, lowered)

    @property
    def min_ts(self) -> int:  # epoch µs
        return (self.end_ts - self.lookback) * 1000

    @property
    def max_ts(self) -> int:  # epoch µs
        return self.end_ts * 1000

    def test(self, spans: Sequence[Span]) -> bool:
        """The oracle predicate: would this trace match the query?

        Mirrors ``QueryRequest#test``: the trace's first timestamp must land
        in the window; ``service_name`` constrains which spans may satisfy
        the other criteria; annotation/tag entries must all be found (on
        spans of the constrained service); duration bounds must hold on one
        such span.
        """
        ts = 0
        for span in spans:
            if span.timestamp is not None:
                ts = span.timestamp if ts == 0 else min(ts, span.timestamp)
        if ts == 0 or not (self.min_ts <= ts <= self.max_ts):
            return False

        service_unmatched = self.service_name
        remote_unmatched = self.remote_service_name
        span_name_unmatched = self.span_name
        ann_remaining: Dict[str, str] = dict(self.annotation_query)
        duration_ok = self.min_duration is None

        for span in spans:
            local = span.local_service_name
            if self.service_name is None or self.service_name == local:
                for a in span.annotations:
                    if a.value in ann_remaining and ann_remaining[a.value] == "":
                        del ann_remaining[a.value]
                for k, v in span.tags.items():
                    want = ann_remaining.get(k)
                    if want is not None and (want == "" or want == v):
                        del ann_remaining[k]
                if remote_unmatched is not None and remote_unmatched == span.remote_service_name:
                    remote_unmatched = None
                if span_name_unmatched is not None and span_name_unmatched == span.name:
                    span_name_unmatched = None
                if not duration_ok and span.duration is not None:
                    if self.max_duration is not None:
                        duration_ok = (
                            self.min_duration <= span.duration <= self.max_duration
                        )
                    else:
                        duration_ok = span.duration >= self.min_duration
            if service_unmatched is not None and service_unmatched == local:
                service_unmatched = None
        return (
            service_unmatched is None
            and remote_unmatched is None
            and span_name_unmatched is None
            and not ann_remaining
            and duration_ok
        )


class SpanConsumer:
    """The write path: ``accept`` returns a Call that persists the spans."""

    def accept(self, spans: Sequence[Span]) -> Call[None]:
        raise NotImplementedError


class Traces:
    def get_trace(self, trace_id: str) -> Call[List[Span]]:
        raise NotImplementedError

    def get_traces(self, trace_ids: Sequence[str]) -> Call[List[List[Span]]]:
        raise NotImplementedError


class SpanStore(Traces):
    """The read path."""

    def get_traces_query(self, request: QueryRequest) -> Call[List[List[Span]]]:
        raise NotImplementedError

    def get_dependencies(self, end_ts: int, lookback: int) -> Call[List[DependencyLink]]:
        raise NotImplementedError


class ServiceAndSpanNames:
    def get_service_names(self) -> Call[List[str]]:
        raise NotImplementedError

    def get_remote_service_names(self, service_name: str) -> Call[List[str]]:
        raise NotImplementedError

    def get_span_names(self, service_name: str) -> Call[List[str]]:
        raise NotImplementedError


class AutocompleteTags:
    def get_keys(self) -> Call[List[str]]:
        raise NotImplementedError

    def get_values(self, key: str) -> Call[List[str]]:
        raise NotImplementedError


class StorageComponent(Component):
    """Factory for the split read/write interfaces over one backend."""

    strict_trace_id: bool = True
    search_enabled: bool = True
    autocomplete_keys: Sequence[str] = ()

    def span_consumer(self) -> SpanConsumer:
        raise NotImplementedError

    def span_store(self) -> SpanStore:
        raise NotImplementedError

    def traces(self) -> Traces:
        return self.span_store()

    def service_and_span_names(self) -> ServiceAndSpanNames:
        raise NotImplementedError

    def autocomplete_tags(self) -> AutocompleteTags:
        raise NotImplementedError


# -- result shaping shared by backends ------------------------------------


class FastIngestError(RuntimeError):
    """A line-rate ingest failed after its parse, so part of the payload may
    already be stored: the caller counts its ``spans`` (boundary-sampled
    ones included) as dropped and must not ingest it again another way.
    The port's own: the reference lets such an error fall back to the
    object path, which ingests the stored part a second time."""

    def __init__(self, spans: int, message: str) -> None:
        super().__init__(message)
        self.spans = spans


def trace_id_key(trace_id: str, strict: bool) -> str:
    """The grouping key for a trace id under (non-)strict matching."""
    normalized = normalize_trace_id(trace_id)
    return normalized if strict else format(lower_64(normalized), "016x")


def group_by_trace_id(spans: Sequence[Span], strict: bool) -> List[List[Span]]:
    """Bucket spans into traces, optionally collapsing on low-64 bits.

    Reference: ``zipkin2/storage/GroupByTraceId.java``.
    """
    grouped: Dict[str, List[Span]] = {}
    for span in spans:
        grouped.setdefault(trace_id_key(span.trace_id, strict), []).append(span)
    return list(grouped.values())


def strict_filter(traces: List[List[Span]], trace_id: str) -> List[List[Span]]:
    """Post-filter groups to exact trace-id matches (strict mode helper).

    Reference: ``zipkin2/storage/StrictTraceId.java``.
    """
    want = normalize_trace_id(trace_id)
    return [t for t in traces if t and t[0].trace_id == want]

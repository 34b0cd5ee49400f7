"""The Zipkin v2 data model: Span, Endpoint, Annotation, DependencyLink.

The port's own copy of ``zipkin_tpu/model/span.py``: imports point at
``zipkin_tpu_torch``; the semantics are the reference's.

Reference semantics: ``zipkin2/Span.java``, ``zipkin2/Endpoint.java``,
``zipkin2/Annotation.java``, ``zipkin2/DependencyLink.java`` (SURVEY.md §2.1).

Normalization contract (applied at construction, so equality and storage keys
are canonical everywhere downstream):

- trace ids: 16 or 32 lower-hex chars, left zero-padded; span ids 16 chars;
  an all-zero parentId means "no parent" (None);
- service names and span names are lowercased; empty strings become None;
- timestamps are epoch **microseconds**, durations microseconds (0 -> None);
- annotations are sorted by (timestamp, value) and de-duplicated;
- Endpoint ports of 0 mean None; IPv6-mapped IPv4 addresses are stored as
  their IPv4 form, matching ``Endpoint.Builder#parseIp``.

These are plain frozen dataclasses — the row-oriented form used by codecs,
the oracle store, and tests. The TPU ingest path uses the columnar
struct-of-arrays form in :mod:`zipkin_tpu_torch.tpu.columnar` instead.
"""

from __future__ import annotations

import dataclasses
import enum
import ipaddress
from typing import Dict, Mapping, Optional, Sequence, Tuple

from zipkin_tpu_torch.internal.hex import (
    lower_64,
    normalize_parent_id,
    normalize_span_id,
    normalize_trace_id,
)


class Kind(enum.Enum):
    """The role a span plays in an RPC or messaging exchange."""

    CLIENT = "CLIENT"
    SERVER = "SERVER"
    PRODUCER = "PRODUCER"
    CONSUMER = "CONSUMER"

    @staticmethod
    def parse(value: Optional[str]) -> Optional["Kind"]:
        if value is None or value == "":
            return None
        try:
            return Kind[value.upper()]
        except KeyError:
            raise ValueError(f"unknown kind: {value!r}") from None


def _lower_or_none(value: Optional[str]) -> Optional[str]:
    if value is None or value == "":
        return None
    return value.lower()


@dataclasses.dataclass(frozen=True, order=True)
class Annotation:
    """A timestamped event of interest within a span (epoch-µs, value)."""

    timestamp: int
    value: str

    def __post_init__(self) -> None:
        if self.timestamp <= 0:
            raise ValueError("annotation timestamp must be positive epoch µs")
        if not self.value:
            raise ValueError("annotation value is required")


@dataclasses.dataclass(frozen=True)
class Endpoint:
    """The network context of a node in the service graph.

    ``service_name`` is the primary join key of the whole system (lowercase).
    """

    service_name: Optional[str] = None
    ipv4: Optional[str] = None
    ipv6: Optional[str] = None
    port: Optional[int] = None

    @staticmethod
    def create(
        service_name: Optional[str] = None,
        ip: Optional[str] = None,
        port: Optional[int] = None,
        *,
        ipv4: Optional[str] = None,
        ipv6: Optional[str] = None,
    ) -> Optional["Endpoint"]:
        """Build a normalized endpoint; returns None if every field is empty.

        ``ip`` may be either address family and is routed to the right slot
        (mirrors ``Endpoint.Builder#parseIp``). Unparseable IPs are dropped,
        not raised — matching the reference's lenient ingest posture.
        """
        name = _lower_or_none(service_name)
        v4: Optional[str] = None
        v6: Optional[str] = None
        for candidate in (ip, ipv4, ipv6):
            if candidate is None or candidate == "":
                continue
            try:
                parsed = ipaddress.ip_address(candidate)
            except ValueError:
                continue
            if isinstance(parsed, ipaddress.IPv6Address):
                mapped = parsed.ipv4_mapped
                if mapped is not None:
                    v4 = v4 or str(mapped)
                else:
                    v6 = v6 or str(parsed)
            else:
                v4 = v4 or str(parsed)
        if port is not None:
            if not 0 <= port <= 0xFFFF:
                raise ValueError(f"port out of range: {port}")
            if port == 0:
                port = None
        if name is None and v4 is None and v6 is None and port is None:
            return None
        return Endpoint(service_name=name, ipv4=v4, ipv6=v6, port=port)


@dataclasses.dataclass(frozen=True)
class Span:
    """One unit of work in a trace, normalized per the module docstring.

    Construct via :meth:`Span.create` (which normalizes) rather than the raw
    dataclass constructor, unless the fields are already canonical.
    """

    trace_id: str
    id: str
    parent_id: Optional[str] = None
    kind: Optional[Kind] = None
    name: Optional[str] = None
    timestamp: Optional[int] = None  # epoch µs
    duration: Optional[int] = None  # µs
    local_endpoint: Optional[Endpoint] = None
    remote_endpoint: Optional[Endpoint] = None
    annotations: Tuple[Annotation, ...] = ()
    tags: Mapping[str, str] = dataclasses.field(default_factory=dict)
    debug: Optional[bool] = None
    shared: Optional[bool] = None

    @staticmethod
    def create(
        trace_id: str,
        id: str,
        *,
        parent_id: Optional[str] = None,
        kind: Optional[Kind | str] = None,
        name: Optional[str] = None,
        timestamp: Optional[int] = None,
        duration: Optional[int] = None,
        local_endpoint: Optional[Endpoint] = None,
        remote_endpoint: Optional[Endpoint] = None,
        annotations: Sequence[Annotation | Tuple[int, str]] = (),
        tags: Optional[Mapping[str, str]] = None,
        debug: Optional[bool] = None,
        shared: Optional[bool] = None,
    ) -> "Span":
        norm_annotations = tuple(
            sorted(
                {
                    a if isinstance(a, Annotation) else Annotation(a[0], a[1])
                    for a in annotations
                }
            )
        )
        if isinstance(kind, str):
            kind = Kind.parse(kind)
        if timestamp is not None and timestamp <= 0:
            timestamp = None
        if duration is not None and duration <= 0:
            duration = None
        return Span(
            trace_id=normalize_trace_id(trace_id),
            id=normalize_span_id(id),
            parent_id=normalize_parent_id(parent_id),
            kind=kind,
            name=_lower_or_none(name),
            timestamp=timestamp,
            duration=duration,
            local_endpoint=local_endpoint,
            remote_endpoint=remote_endpoint,
            annotations=norm_annotations,
            tags=dict(tags) if tags else {},
            debug=debug if debug else None,
            shared=shared if shared else None,
        )

    # -- derived accessors ------------------------------------------------

    @property
    def local_service_name(self) -> Optional[str]:
        ep = self.local_endpoint
        return ep.service_name if ep is not None else None

    @property
    def remote_service_name(self) -> Optional[str]:
        ep = self.remote_endpoint
        return ep.service_name if ep is not None else None

    @property
    def trace_id_low64(self) -> int:
        return lower_64(self.trace_id)

    @property
    def is_error(self) -> bool:
        """Zipkin's error convention: presence of an ``error`` tag."""
        return "error" in self.tags

    def timestamp_as_long(self) -> int:
        return self.timestamp or 0

    def duration_as_long(self) -> int:
        return self.duration or 0

    # -- hashing for columnar/device keys ---------------------------------

    def __hash__(self) -> int:
        return hash((self.trace_id, self.id, self.shared, self.timestamp))

    def key(self) -> Tuple[str, str, Optional[bool], Optional[str]]:
        """Identity used for de-dup/merge: a client span and the shared
        server half of the same RPC have equal ids but distinct keys.

        Reference: the merge keying inside ``zipkin2/internal/Trace.java``.
        """
        return (self.trace_id, self.id, self.shared, self.local_service_name)


def merge_spans(left: Span, right: Span) -> Span:
    """Merge two reports of the same span (same :meth:`Span.key`).

    Field-wise union preferring the earlier-known value, mirroring
    ``Span.Builder#merge`` as used by ``Trace.merge``: annotations and tags
    union; timestamp takes the smaller nonzero; duration the larger; flags OR.
    """
    if left.key() != right.key():
        raise ValueError("cannot merge spans with different identities")
    tags: Dict[str, str] = dict(left.tags)
    for k, v in right.tags.items():
        tags.setdefault(k, v)
    ts_candidates = [t for t in (left.timestamp, right.timestamp) if t]
    return Span(
        trace_id=left.trace_id,
        id=left.id,
        parent_id=left.parent_id or right.parent_id,
        kind=left.kind or right.kind,
        name=left.name or right.name,
        timestamp=min(ts_candidates) if ts_candidates else None,
        duration=max(left.duration or 0, right.duration or 0) or None,
        local_endpoint=left.local_endpoint or right.local_endpoint,
        remote_endpoint=left.remote_endpoint or right.remote_endpoint,
        annotations=tuple(sorted(set(left.annotations) | set(right.annotations))),
        tags=tags,
        debug=left.debug or right.debug,
        shared=left.shared or right.shared,
    )


@dataclasses.dataclass(frozen=True)
class DependencyLink:
    """An aggregated parent->child service edge with call/error counts."""

    parent: str
    child: str
    call_count: int = 0
    error_count: int = 0

    @staticmethod
    def create(parent: str, child: str, call_count: int, error_count: int = 0) -> "DependencyLink":
        return DependencyLink(parent.lower(), child.lower(), call_count, error_count)


def merge_links(links: Sequence[DependencyLink]) -> Tuple[DependencyLink, ...]:
    """Sum call/error counts across links sharing (parent, child).

    The read-side merge for daily-rollup dependency queries.
    """
    acc: Dict[Tuple[str, str], Tuple[int, int]] = {}
    order = []
    for link in links:
        k = (link.parent, link.child)
        if k not in acc:
            acc[k] = (0, 0)
            order.append(k)
        calls, errors = acc[k]
        acc[k] = (calls + link.call_count, errors + link.error_count)
    return tuple(
        DependencyLink(parent=k[0], child=k[1], call_count=acc[k][0], error_count=acc[k][1])
        for k in order
    )

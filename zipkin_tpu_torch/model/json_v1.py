"""Zipkin v1 (legacy) JSON model and v1 -> v2 semantic conversion.

The port's own copy of ``zipkin_tpu/model/json_v1.py``: imports point at
``zipkin_tpu_torch``; the semantics are the reference's.

Reference semantics: ``zipkin2/v1/V1Span.java``, ``V1SpanConverter.java``,
``V2SpanConverter.java`` and the JSON_V1 arm of ``SpanBytesDecoder``
(SURVEY.md §2.1). v1 is the Scribe-era shape: core annotations ``cs/cr``
(client send/receive), ``sr/ss`` (server receive/send), ``ms/mr`` (message
send/receive) encode what v2 models as ``kind`` + timestamp/duration, and
binary annotations encode tags plus the address annotations ``sa/ca/ma``
that became ``remoteEndpoint``.

Conversion rules implemented (each is exercised in tests):

1. ``cs`` present: a CLIENT span exists; timestamp = cs, duration = cr - cs
   when ``cr`` is present, else the v1 timestamp/duration.
2. ``sr``/``ss`` present *without* ``cs``/``cr``: a SERVER span;
   **shared = parentId is set** — i.e. a non-root v1 server span is assumed
   to be the server half of an RPC whose id the client also reported.
3. ``cs`` *and* ``sr`` in one v1 span: the span is split into a CLIENT span
   (cs endpoint) and a *shared* SERVER span (sr endpoint, timestamp = sr,
   duration = ss - sr).
4. ``ms`` -> PRODUCER, ``mr`` -> CONSUMER (timestamp = the annotation).
5. Binary annotations of string type become tags; ``sa``/``ca``/``ma``
   (address annotations) become the remoteEndpoint of the opposite side:
   ``sa`` is the remote of the client span, ``ca`` the remote of the server
   span, ``ma`` of either messaging kind.
6. The ``lc`` ("local component") binary annotation contributes its endpoint
   as localEndpoint and survives as tag ``lc``.
7. Non-core annotations pass through with their timestamps.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional, Sequence, Tuple

from zipkin_tpu_torch.model.json_v2 import endpoint_to_dict
from zipkin_tpu_torch.model.span import Annotation, Endpoint, Kind, Span

CORE_ANNOTATIONS = frozenset(["cs", "cr", "ss", "sr", "ms", "mr", "ws", "wr"])
ADDRESS_KEYS = frozenset(["sa", "ca", "ma"])


@dataclasses.dataclass(frozen=True)
class V1Annotation:
    timestamp: int
    value: str
    endpoint: Optional[Endpoint] = None


@dataclasses.dataclass(frozen=True)
class V1BinaryAnnotation:
    key: str
    value: Any  # str for tags; True for address annotations
    endpoint: Optional[Endpoint] = None

    @property
    def is_address(self) -> bool:
        return self.key in ADDRESS_KEYS and self.value is True


@dataclasses.dataclass(frozen=True)
class V1Span:
    trace_id: str
    id: str
    parent_id: Optional[str] = None
    name: Optional[str] = None
    timestamp: Optional[int] = None
    duration: Optional[int] = None
    annotations: Tuple[V1Annotation, ...] = ()
    binary_annotations: Tuple[V1BinaryAnnotation, ...] = ()
    debug: Optional[bool] = None


def _find(annotations: Sequence[V1Annotation], value: str) -> Optional[V1Annotation]:
    for a in annotations:
        if a.value == value:
            return a
    return None


def convert_v1_span(v1: V1Span) -> List[Span]:
    """Convert one v1 span into one or two v2 spans per the module rules."""
    anns = v1.annotations
    cs, cr = _find(anns, "cs"), _find(anns, "cr")
    sr, ss = _find(anns, "sr"), _find(anns, "ss")
    ms, mr = _find(anns, "ms"), _find(anns, "mr")

    tags: Dict[str, str] = {}
    local_from_lc: Optional[Endpoint] = None
    sa = ca = ma = None
    for b in v1.binary_annotations:
        if b.is_address:
            if b.key == "sa":
                sa = b.endpoint
            elif b.key == "ca":
                ca = b.endpoint
            else:
                ma = b.endpoint
        elif isinstance(b.value, str):
            tags[b.key] = b.value
            if b.endpoint is not None and local_from_lc is None:
                local_from_lc = b.endpoint

    extra = tuple(
        Annotation(a.timestamp, a.value) for a in anns if a.value not in CORE_ANNOTATIONS
    )

    def endpoint_of(
        *candidates: Optional[V1Annotation], scan_all: bool = True
    ) -> Optional[Endpoint]:
        for c in candidates:
            if c is not None and c.endpoint is not None:
                return c.endpoint
        if scan_all:
            for a in anns:
                if a.endpoint is not None:
                    return a.endpoint
        return local_from_lc

    out: List[Span] = []

    def build(
        kind: Optional[Kind],
        begin: Optional[V1Annotation],
        end: Optional[V1Annotation],
        local: Optional[Endpoint],
        remote: Optional[Endpoint],
        *,
        shared: Optional[bool] = None,
        use_v1_timing: bool = True,
    ) -> None:
        timestamp = begin.timestamp if begin is not None else None
        duration = None
        if begin is not None and end is not None and end.timestamp > begin.timestamp:
            duration = end.timestamp - begin.timestamp
        if use_v1_timing:
            timestamp = timestamp or v1.timestamp
            duration = duration or v1.duration
        out.append(
            Span.create(
                trace_id=v1.trace_id,
                id=v1.id,
                parent_id=v1.parent_id,
                kind=kind,
                name=v1.name,
                timestamp=timestamp,
                duration=duration,
                local_endpoint=local,
                remote_endpoint=remote,
                annotations=extra if not out else (),
                tags=tags if not out else {},
                debug=v1.debug,
                shared=shared,
            )
        )

    has_client = cs is not None or cr is not None
    has_server = sr is not None or ss is not None

    if has_client and has_server:
        # One v1 span carrying both halves of the RPC: split (rule 3). Each
        # half may only adopt its own side's endpoints — scanning all
        # annotations would leak the server's endpoint onto the client half.
        build(Kind.CLIENT, cs, cr or sr, endpoint_of(cs, cr, scan_all=False), sa)
        build(
            Kind.SERVER,
            sr,
            ss,
            endpoint_of(sr, ss, scan_all=False),
            ca,
            shared=True,
            use_v1_timing=False,
        )
    elif has_client:
        build(Kind.CLIENT, cs, cr, endpoint_of(cs, cr), sa)
    elif has_server:
        build(
            Kind.SERVER,
            sr,
            ss,
            endpoint_of(sr, ss),
            ca,
            shared=True if v1.parent_id is not None else None,  # rule 2
        )
    elif ms is not None:
        build(Kind.PRODUCER, ms, None, endpoint_of(ms), ma)
    elif mr is not None:
        build(Kind.CONSUMER, mr, None, endpoint_of(mr), ma)
    else:
        # Local / unannotated span: endpoint from any annotation or "lc".
        build(None, None, None, endpoint_of(), sa)
    return out


def convert_v1_spans(v1_spans: Sequence[V1Span]) -> List[Span]:
    out: List[Span] = []
    for v1 in v1_spans:
        out.extend(convert_v1_span(v1))
    return out


# -- v1 JSON wire decode/encode -------------------------------------------


def _v1_endpoint_from_dict(obj: Optional[Dict[str, Any]]) -> Optional[Endpoint]:
    if not obj:
        return None
    port = obj.get("port")
    return Endpoint.create(
        service_name=obj.get("serviceName"),
        ipv4=obj.get("ipv4"),
        ipv6=obj.get("ipv6"),
        port=int(port) if port is not None else None,
    )


def v1_span_from_dict(obj: Dict[str, Any]) -> V1Span:
    annotations = tuple(
        V1Annotation(
            timestamp=int(a["timestamp"]),
            value=str(a["value"]),
            endpoint=_v1_endpoint_from_dict(a.get("endpoint")),
        )
        for a in obj.get("annotations", ())
    )
    binary = []
    for b in obj.get("binaryAnnotations", ()):
        value = b.get("value")
        btype = b.get("type")
        if btype == "BOOL" or value is True:
            value = bool(value)
        elif not isinstance(value, str):
            value = json.dumps(value) if value is not None else ""
        binary.append(
            V1BinaryAnnotation(
                key=str(b["key"]),
                value=value,
                endpoint=_v1_endpoint_from_dict(b.get("endpoint")),
            )
        )
    return V1Span(
        trace_id=obj["traceId"],
        id=obj["id"],
        parent_id=obj.get("parentId"),
        name=obj.get("name"),
        timestamp=int(obj["timestamp"]) if obj.get("timestamp") else None,
        duration=int(obj["duration"]) if obj.get("duration") else None,
        annotations=annotations,
        binary_annotations=tuple(binary),
        debug=bool(obj.get("debug")) or None,
    )


def decode_v1_span_list(data: bytes) -> List[Span]:
    """Decode a v1 JSON array straight to v2 spans (the ingest path)."""
    parsed = json.loads(data)
    if not isinstance(parsed, list):
        raise ValueError("expected a JSON array of v1 spans")
    return convert_v1_spans([v1_span_from_dict(o) for o in parsed])


def encode_v1_span_list(spans: Sequence[Span]) -> bytes:
    """Encode v2 spans in the v1 JSON shape (legacy read compatibility).

    Reference: ``V2SpanConverter`` + JSON_V1 encoder. Kind/shared map back to
    core annotations; tags become string binary annotations; remoteEndpoint
    becomes the matching address annotation.
    """
    out = []
    for s in spans:
        obj: Dict[str, Any] = {"traceId": s.trace_id, "id": s.id}
        if s.parent_id:
            obj["parentId"] = s.parent_id
        obj["name"] = s.name or ""
        if s.timestamp and not s.shared:
            obj["timestamp"] = s.timestamp
        if s.duration and not s.shared:
            obj["duration"] = s.duration
        ep = endpoint_to_dict(s.local_endpoint) if s.local_endpoint else None
        anns: List[Dict[str, Any]] = []
        begin_end = {
            Kind.CLIENT: ("cs", "cr"),
            Kind.SERVER: ("sr", "ss"),
            Kind.PRODUCER: ("ms", None),
            Kind.CONSUMER: ("mr", None),
        }.get(s.kind) if s.kind else None
        if begin_end and s.timestamp:
            begin, end = begin_end
            anns.append({"timestamp": s.timestamp, "value": begin, "endpoint": ep})
            if end and s.duration:
                anns.append(
                    {"timestamp": s.timestamp + s.duration, "value": end, "endpoint": ep}
                )
        for a in s.annotations:
            anns.append({"timestamp": a.timestamp, "value": a.value, "endpoint": ep})
        if anns:
            obj["annotations"] = anns
        bins: List[Dict[str, Any]] = []
        for k, v in s.tags.items():
            bins.append({"key": k, "value": v, "endpoint": ep})
        if ep is not None and not anns and not s.tags:
            # A bare local span would otherwise lose its endpoint: emit the
            # "lc" (local component) convention the decoder understands.
            bins.append({"key": "lc", "value": "", "endpoint": ep})
        if s.remote_endpoint is not None and s.kind is not None:
            addr = {
                Kind.CLIENT: "sa",
                Kind.SERVER: "ca",
                Kind.PRODUCER: "ma",
                Kind.CONSUMER: "ma",
            }[s.kind]
            bins.append(
                {
                    "key": addr,
                    "value": True,
                    "type": "BOOL",
                    "endpoint": endpoint_to_dict(s.remote_endpoint),
                }
            )
        if bins:
            obj["binaryAnnotations"] = bins
        if s.debug:
            obj["debug"] = True
        out.append(obj)
    return json.dumps(out, separators=(",", ":")).encode()

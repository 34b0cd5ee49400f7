"""Zipkin v2 JSON codec.

The port's own copy of ``zipkin_tpu/model/json_v2.py``: imports point at
``zipkin_tpu_torch``; the semantics are the reference's.

Reference semantics: ``zipkin2/codec/SpanBytesEncoder.java`` /
``SpanBytesDecoder.java`` (JSON_V2) and ``zipkin2/internal/V2SpanWriter.java``
(SURVEY.md §2.1). The wire shape is the public v2 span JSON; fields that are
null/empty are omitted on encode, unknown fields are ignored on decode, and
decoding runs the same normalization as :meth:`Span.create` so a decoded span
is always canonical.

The reference hand-rolls a streaming writer for speed; here the oracle path
uses the stdlib json module, and the throughput path decodes straight into
columnar arrays (:mod:`zipkin_tpu_torch.tpu.columnar`) instead of objects — the
TPU-native answer to ``WriteBuffer``.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Sequence

from zipkin_tpu_torch.model.span import Annotation, DependencyLink, Endpoint, Kind, Span


def endpoint_to_dict(ep: Endpoint) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    if ep.service_name is not None:
        out["serviceName"] = ep.service_name
    if ep.ipv4 is not None:
        out["ipv4"] = ep.ipv4
    if ep.ipv6 is not None:
        out["ipv6"] = ep.ipv6
    if ep.port is not None:
        out["port"] = ep.port
    return out


def span_to_dict(span: Span) -> Dict[str, Any]:
    out: Dict[str, Any] = {"traceId": span.trace_id}
    if span.parent_id is not None:
        out["parentId"] = span.parent_id
    out["id"] = span.id
    if span.kind is not None:
        out["kind"] = span.kind.value
    if span.name is not None:
        out["name"] = span.name
    if span.timestamp is not None:
        out["timestamp"] = span.timestamp
    if span.duration is not None:
        out["duration"] = span.duration
    if span.local_endpoint is not None:
        out["localEndpoint"] = endpoint_to_dict(span.local_endpoint)
    if span.remote_endpoint is not None:
        out["remoteEndpoint"] = endpoint_to_dict(span.remote_endpoint)
    if span.annotations:
        out["annotations"] = [
            {"timestamp": a.timestamp, "value": a.value} for a in span.annotations
        ]
    if span.tags:
        out["tags"] = dict(span.tags)
    if span.debug:
        out["debug"] = True
    if span.shared:
        out["shared"] = True
    return out


def _endpoint_from_dict(obj: Optional[Dict[str, Any]]) -> Optional[Endpoint]:
    if not obj:
        return None
    port = obj.get("port")
    if port is not None:
        port = int(port)
    return Endpoint.create(
        service_name=obj.get("serviceName"),
        ipv4=obj.get("ipv4"),
        ipv6=obj.get("ipv6"),
        port=port,
    )


def span_from_dict(obj: Dict[str, Any]) -> Span:
    if "traceId" not in obj or "id" not in obj:
        raise ValueError(f"span missing traceId/id: {obj!r}")
    annotations = [
        Annotation(int(a["timestamp"]), str(a["value"]))
        for a in obj.get("annotations", ())
    ]
    tags = obj.get("tags") or {}
    return Span.create(
        trace_id=obj["traceId"],
        id=obj["id"],
        parent_id=obj.get("parentId"),
        kind=Kind.parse(obj.get("kind")),
        name=obj.get("name"),
        timestamp=int(obj["timestamp"]) if obj.get("timestamp") else None,
        duration=int(obj["duration"]) if obj.get("duration") else None,
        local_endpoint=_endpoint_from_dict(obj.get("localEndpoint")),
        remote_endpoint=_endpoint_from_dict(obj.get("remoteEndpoint")),
        annotations=annotations,
        tags={str(k): str(v) for k, v in tags.items()},
        debug=bool(obj.get("debug")) or None,
        shared=bool(obj.get("shared")) or None,
    )


# -- bytes-level API (the codec surface storage/server use) ----------------


def encode_span(span: Span) -> bytes:
    return json.dumps(span_to_dict(span), separators=(",", ":")).encode()


def encode_span_list(spans: Sequence[Span]) -> bytes:
    return json.dumps(
        [span_to_dict(s) for s in spans], separators=(",", ":")
    ).encode()


def encode_traces(traces: Sequence[Sequence[Span]]) -> bytes:
    return json.dumps(
        [[span_to_dict(s) for s in t] for t in traces], separators=(",", ":")
    ).encode()


def decode_span_list(data: bytes) -> List[Span]:
    parsed = json.loads(data)
    if not isinstance(parsed, list):
        raise ValueError("expected a JSON array of spans")
    return [span_from_dict(o) for o in parsed]


def decode_one_span(data: bytes) -> Span:
    return span_from_dict(json.loads(data))


# -- dependency links ------------------------------------------------------


def link_to_dict(link: DependencyLink) -> Dict[str, Any]:
    out: Dict[str, Any] = {
        "parent": link.parent,
        "child": link.child,
        "callCount": link.call_count,
    }
    if link.error_count:
        out["errorCount"] = link.error_count
    return out


def encode_link_list(links: Sequence[DependencyLink]) -> bytes:
    return json.dumps([link_to_dict(x) for x in links], separators=(",", ":")).encode()


def decode_link_list(data: bytes) -> List[DependencyLink]:
    return [
        DependencyLink(
            parent=o["parent"],
            child=o["child"],
            call_count=int(o.get("callCount", 0)),
            error_count=int(o.get("errorCount", 0)),
        )
        for o in json.loads(data)
    ]

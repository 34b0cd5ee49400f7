"""Hand-rolled protobuf codec for ``zipkin.proto`` (no protoc runtime).

The port's own copy of ``zipkin_tpu/model/proto3.py``: imports point at
``zipkin_tpu_torch``; the semantics are the reference's.

Reference semantics: ``zipkin2/internal/Proto3Codec.java``,
``Proto3Fields.java``, ``Proto3ZipkinFields.java`` (SURVEY.md §2.1). Encodes
and decodes the proto3 ``ListOfSpans`` message used by ``POST /api/v2/spans``
with content-type ``application/x-protobuf`` and by the gRPC
``zipkin.proto3.SpanService/Report`` endpoint.

Message schema (zipkin.proto):

- ``Span``: trace_id=1 bytes(8|16), parent_id=2 bytes(8), id=3 bytes(8),
  kind=4 enum, name=5 string, timestamp=6 fixed64, duration=7 uint64,
  local_endpoint=8, remote_endpoint=9, annotations=10 repeated,
  tags=11 map<string,string>, debug=12 bool, shared=13 bool
- ``Endpoint``: service_name=1 string, ipv4=2 bytes(4), ipv6=3 bytes(16),
  port=4 int32
- ``Annotation``: timestamp=1 fixed64, value=2 string
- ``ListOfSpans``: spans=1 repeated Span
"""

from __future__ import annotations

import ipaddress
import struct
from typing import List, Optional, Sequence, Tuple

from zipkin_tpu_torch.model.span import Annotation, Endpoint, Kind, Span

_WIRE_VARINT = 0
_WIRE_FIXED64 = 1
_WIRE_LEN = 2
_WIRE_FIXED32 = 5

_KIND_TO_ENUM = {Kind.CLIENT: 1, Kind.SERVER: 2, Kind.PRODUCER: 3, Kind.CONSUMER: 4}
_ENUM_TO_KIND = {v: k for k, v in _KIND_TO_ENUM.items()}


# -- primitive writers -----------------------------------------------------


def _write_varint(buf: bytearray, value: int) -> None:
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            buf.append(bits | 0x80)
        else:
            buf.append(bits)
            return


def _key(field: int, wire: int) -> int:
    return (field << 3) | wire


def _write_len_field(buf: bytearray, field: int, payload: bytes) -> None:
    _write_varint(buf, _key(field, _WIRE_LEN))
    _write_varint(buf, len(payload))
    buf.extend(payload)


def _write_string(buf: bytearray, field: int, value: str) -> None:
    _write_len_field(buf, field, value.encode())


def _write_bool(buf: bytearray, field: int, value: bool) -> None:
    _write_varint(buf, _key(field, _WIRE_VARINT))
    buf.append(1 if value else 0)


def _write_fixed64(buf: bytearray, field: int, value: int) -> None:
    _write_varint(buf, _key(field, _WIRE_FIXED64))
    buf.extend(struct.pack("<Q", value))


# -- encode ----------------------------------------------------------------


def _encode_endpoint(ep: Endpoint) -> bytes:
    buf = bytearray()
    if ep.service_name:
        _write_string(buf, 1, ep.service_name)
    if ep.ipv4:
        _write_len_field(buf, 2, ipaddress.IPv4Address(ep.ipv4).packed)
    if ep.ipv6:
        _write_len_field(buf, 3, ipaddress.IPv6Address(ep.ipv6).packed)
    if ep.port:
        _write_varint(buf, _key(4, _WIRE_VARINT))
        _write_varint(buf, ep.port)
    return bytes(buf)


def encode_span(span: Span) -> bytes:
    buf = bytearray()
    _write_len_field(buf, 1, bytes.fromhex(span.trace_id))
    if span.parent_id:
        _write_len_field(buf, 2, bytes.fromhex(span.parent_id))
    _write_len_field(buf, 3, bytes.fromhex(span.id))
    if span.kind is not None:
        _write_varint(buf, _key(4, _WIRE_VARINT))
        _write_varint(buf, _KIND_TO_ENUM[span.kind])
    if span.name:
        _write_string(buf, 5, span.name)
    if span.timestamp:
        _write_fixed64(buf, 6, span.timestamp)
    if span.duration:
        _write_varint(buf, _key(7, _WIRE_VARINT))
        _write_varint(buf, span.duration)
    if span.local_endpoint is not None:
        _write_len_field(buf, 8, _encode_endpoint(span.local_endpoint))
    if span.remote_endpoint is not None:
        _write_len_field(buf, 9, _encode_endpoint(span.remote_endpoint))
    for a in span.annotations:
        ann = bytearray()
        _write_fixed64(ann, 1, a.timestamp)
        _write_string(ann, 2, a.value)
        _write_len_field(buf, 10, bytes(ann))
    for k, v in span.tags.items():
        entry = bytearray()
        _write_string(entry, 1, k)
        _write_string(entry, 2, v)
        _write_len_field(buf, 11, bytes(entry))
    if span.debug:
        _write_bool(buf, 12, True)
    if span.shared:
        _write_bool(buf, 13, True)
    return bytes(buf)


def encode_span_list(spans: Sequence[Span]) -> bytes:
    """Encode ``ListOfSpans`` (each span is field 1, length-delimited)."""
    buf = bytearray()
    for span in spans:
        _write_len_field(buf, 1, encode_span(span))
    return bytes(buf)


# -- decode ----------------------------------------------------------------


class _Reader:
    __slots__ = ("data", "pos", "end")

    def __init__(self, data: bytes, pos: int = 0, end: Optional[int] = None) -> None:
        self.data = data
        self.pos = pos
        self.end = len(data) if end is None else end

    def done(self) -> bool:
        return self.pos >= self.end

    def varint(self) -> int:
        result = 0
        shift = 0
        while True:
            if self.pos >= self.end:
                raise ValueError("truncated varint")
            b = self.data[self.pos]
            self.pos += 1
            result |= (b & 0x7F) << shift
            if not b & 0x80:
                return result
            shift += 7
            if shift > 63:
                raise ValueError("varint too long")

    def fixed64(self) -> int:
        if self.pos + 8 > self.end:
            raise ValueError("truncated fixed64")
        (value,) = struct.unpack_from("<Q", self.data, self.pos)
        self.pos += 8
        return value

    def bytes_field(self) -> bytes:
        n = self.varint()
        if self.pos + n > self.end:
            raise ValueError("truncated length-delimited field")
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def skip(self, wire: int) -> None:
        if wire == _WIRE_VARINT:
            self.varint()
        elif wire == _WIRE_FIXED64:
            self.pos += 8
        elif wire == _WIRE_LEN:
            self.bytes_field()
        elif wire == _WIRE_FIXED32:
            self.pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")


def _decode_endpoint(data: bytes) -> Optional[Endpoint]:
    r = _Reader(data)
    service = ipv4 = ipv6 = None
    port = None
    while not r.done():
        tag = r.varint()
        field, wire = tag >> 3, tag & 7
        if field == 1 and wire == _WIRE_LEN:
            service = r.bytes_field().decode()
        elif field == 2 and wire == _WIRE_LEN:
            raw = r.bytes_field()
            ipv4 = str(ipaddress.IPv4Address(raw)) if len(raw) == 4 else None
        elif field == 3 and wire == _WIRE_LEN:
            raw = r.bytes_field()
            ipv6 = str(ipaddress.IPv6Address(raw)) if len(raw) == 16 else None
        elif field == 4 and wire == _WIRE_VARINT:
            port = r.varint()
        else:
            r.skip(wire)
    return Endpoint.create(service_name=service, ipv4=ipv4, ipv6=ipv6, port=port)


def _decode_annotation(data: bytes) -> Optional[Annotation]:
    r = _Reader(data)
    timestamp = 0
    value = ""
    while not r.done():
        tag = r.varint()
        field, wire = tag >> 3, tag & 7
        if field == 1 and wire == _WIRE_FIXED64:
            timestamp = r.fixed64()
        elif field == 2 and wire == _WIRE_LEN:
            value = r.bytes_field().decode()
        else:
            r.skip(wire)
    if timestamp <= 0 or not value:
        return None
    return Annotation(timestamp, value)


def decode_span(data: bytes) -> Span:
    r = _Reader(data)
    trace_id = span_id = ""
    parent_id = name = None
    kind = None
    timestamp = duration = None
    local = remote = None
    annotations: List[Annotation] = []
    tags = {}
    debug = shared = None
    while not r.done():
        tag = r.varint()
        field, wire = tag >> 3, tag & 7
        if field == 1 and wire == _WIRE_LEN:
            trace_id = r.bytes_field().hex()
        elif field == 2 and wire == _WIRE_LEN:
            parent_id = r.bytes_field().hex()
        elif field == 3 and wire == _WIRE_LEN:
            span_id = r.bytes_field().hex()
        elif field == 4 and wire == _WIRE_VARINT:
            kind = _ENUM_TO_KIND.get(r.varint())
        elif field == 5 and wire == _WIRE_LEN:
            name = r.bytes_field().decode()
        elif field == 6 and wire == _WIRE_FIXED64:
            timestamp = r.fixed64()
        elif field == 7 and wire == _WIRE_VARINT:
            duration = r.varint()
        elif field == 8 and wire == _WIRE_LEN:
            local = _decode_endpoint(r.bytes_field())
        elif field == 9 and wire == _WIRE_LEN:
            remote = _decode_endpoint(r.bytes_field())
        elif field == 10 and wire == _WIRE_LEN:
            ann = _decode_annotation(r.bytes_field())
            if ann is not None:
                annotations.append(ann)
        elif field == 11 and wire == _WIRE_LEN:
            er = _Reader(r.bytes_field())
            key = value = ""
            while not er.done():
                etag = er.varint()
                efield, ewire = etag >> 3, etag & 7
                if efield == 1 and ewire == _WIRE_LEN:
                    key = er.bytes_field().decode()
                elif efield == 2 and ewire == _WIRE_LEN:
                    value = er.bytes_field().decode()
                else:
                    er.skip(ewire)
            if key:
                tags[key] = value
        elif field == 12 and wire == _WIRE_VARINT:
            debug = bool(r.varint())
        elif field == 13 and wire == _WIRE_VARINT:
            shared = bool(r.varint())
        else:
            r.skip(wire)
    return Span.create(
        trace_id=trace_id,
        id=span_id,
        parent_id=parent_id,
        kind=kind,
        name=name,
        timestamp=timestamp,
        duration=duration,
        local_endpoint=local,
        remote_endpoint=remote,
        annotations=annotations,
        tags=tags,
        debug=debug,
        shared=shared,
    )


def decode_span_list(data: bytes) -> List[Span]:
    r = _Reader(data)
    spans: List[Span] = []
    while not r.done():
        tag = r.varint()
        field, wire = tag >> 3, tag & 7
        if field == 1 and wire == _WIRE_LEN:
            spans.append(decode_span(r.bytes_field()))
        else:
            r.skip(wire)
    return spans

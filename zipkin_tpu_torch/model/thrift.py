"""Legacy thrift (TBinaryProtocol) codec for v1 spans — the Scribe path.

The port's own copy of ``zipkin_tpu/model/thrift.py``: imports point at
``zipkin_tpu_torch``; the semantics are the reference's.

Reference semantics: ``zipkin2/internal/ThriftCodec.java`` (SURVEY.md §2.1).
Decodes a thrift list of v1 Span structs (the payload Scribe delivered
base64-encoded) into v2 spans via :mod:`zipkin_tpu_torch.model.json_v1`'s
converter. Struct schema (zipkinCore.thrift):

- Span: 1:i64 trace_id, 3:string name, 4:i64 id, 5:i64 parent_id,
  6:list<Annotation> annotations, 8:list<BinaryAnnotation> binary_annotations,
  9:bool debug, 10:i64 timestamp, 11:i64 duration, 12:i64 trace_id_high
- Annotation: 1:i64 timestamp, 2:string value, 3:Endpoint host
- BinaryAnnotation: 1:string key, 2:binary value, 3:i32 annotation_type,
  4:Endpoint host  (types: 0=BOOL, 6=STRING; others stringified)
- Endpoint: 1:i32 ipv4, 2:i16 port, 3:string service_name, 4:binary ipv6
"""

from __future__ import annotations

import ipaddress
import struct
from typing import List, Optional

from zipkin_tpu_torch.internal.hex import to_lower_hex
from zipkin_tpu_torch.model.json_v1 import (
    V1Annotation,
    V1BinaryAnnotation,
    V1Span,
    convert_v1_spans,
)
from zipkin_tpu_torch.model.span import Endpoint, Span

_T_STOP = 0
_T_BOOL = 2
_T_BYTE = 3
_T_DOUBLE = 4
_T_I16 = 6
_T_I32 = 8
_T_I64 = 10
_T_STRING = 11
_T_STRUCT = 12
_T_MAP = 13
_T_SET = 14
_T_LIST = 15


class _Reader:
    __slots__ = ("data", "pos")

    def __init__(self, data: bytes, pos: int = 0) -> None:
        self.data = data
        self.pos = pos

    def u8(self) -> int:
        v = self.data[self.pos]
        self.pos += 1
        return v

    def i16(self) -> int:
        (v,) = struct.unpack_from(">h", self.data, self.pos)
        self.pos += 2
        return v

    def i32(self) -> int:
        (v,) = struct.unpack_from(">i", self.data, self.pos)
        self.pos += 4
        return v

    def i64(self) -> int:
        (v,) = struct.unpack_from(">q", self.data, self.pos)
        self.pos += 8
        return v

    def binary(self) -> bytes:
        n = self.i32()
        if n < 0 or self.pos + n > len(self.data):
            raise ValueError("truncated thrift binary")
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def _count(self) -> int:
        """Container element count, validated against the readable buffer.

        Attacker-controlled i32 counts (up to 2^31) must be bounded by the
        bytes remaining — every element occupies >= 1 byte — or a ~20-byte
        payload declaring ``list<bool>`` count=0x7FFFFFFF burns minutes of
        CPU per request. Mirrors ThriftCodec's guard of lengths against the
        readable buffer (SURVEY.md §2.1).
        """
        n = self.i32()
        if n < 0 or n > len(self.data) - self.pos:
            raise ValueError("thrift container count exceeds buffer")
        return n

    def skip(self, ttype: int) -> None:
        if ttype in (_T_BOOL, _T_BYTE):
            self.pos += 1
        elif ttype == _T_I16:
            self.pos += 2
        elif ttype == _T_I32:
            self.pos += 4
        elif ttype in (_T_I64, _T_DOUBLE):
            self.pos += 8
        elif ttype == _T_STRING:
            self.binary()
        elif ttype == _T_STRUCT:
            while True:
                ft = self.u8()
                if ft == _T_STOP:
                    return
                self.i16()
                self.skip(ft)
        elif ttype in (_T_LIST, _T_SET):
            et = self.u8()
            for _ in range(self._count()):
                self.skip(et)
        elif ttype == _T_MAP:
            kt, vt = self.u8(), self.u8()
            for _ in range(self._count()):
                self.skip(kt)
                self.skip(vt)
        else:
            raise ValueError(f"unknown thrift type {ttype}")
        if self.pos > len(self.data):
            raise ValueError("truncated thrift payload")


def _read_endpoint(r: _Reader) -> Optional[Endpoint]:
    ipv4 = None
    port = None
    service = None
    ipv6 = None
    while True:
        ftype = r.u8()
        if ftype == _T_STOP:
            break
        fid = r.i16()
        if fid == 1 and ftype == _T_I32:
            raw = r.i32() & 0xFFFFFFFF
            ipv4 = str(ipaddress.IPv4Address(raw)) if raw else None
        elif fid == 2 and ftype == _T_I16:
            port = r.i16() & 0xFFFF
        elif fid == 3 and ftype == _T_STRING:
            service = r.binary().decode(errors="replace")
        elif fid == 4 and ftype == _T_STRING:
            raw = r.binary()
            ipv6 = str(ipaddress.IPv6Address(raw)) if len(raw) == 16 else None
        else:
            r.skip(ftype)
    return Endpoint.create(service_name=service, ipv4=ipv4, ipv6=ipv6, port=port)


def _read_annotation(r: _Reader) -> Optional[V1Annotation]:
    ts = 0
    value = ""
    host = None
    while True:
        ftype = r.u8()
        if ftype == _T_STOP:
            break
        fid = r.i16()
        if fid == 1 and ftype == _T_I64:
            ts = r.i64()
        elif fid == 2 and ftype == _T_STRING:
            value = r.binary().decode(errors="replace")
        elif fid == 3 and ftype == _T_STRUCT:
            host = _read_endpoint(r)
        else:
            r.skip(ftype)
    if ts <= 0 or not value:
        return None
    return V1Annotation(ts, value, host)


_TYPE_BOOL = 0
_TYPE_STRING = 6


def _read_binary_annotation(r: _Reader) -> Optional[V1BinaryAnnotation]:
    key = None
    raw: bytes = b""
    ann_type = _TYPE_STRING
    host = None
    while True:
        ftype = r.u8()
        if ftype == _T_STOP:
            break
        fid = r.i16()
        if fid == 1 and ftype == _T_STRING:
            key = r.binary().decode(errors="replace")
        elif fid == 2 and ftype == _T_STRING:
            raw = r.binary()
        elif fid == 3 and ftype == _T_I32:
            ann_type = r.i32()
        elif fid == 4 and ftype == _T_STRUCT:
            host = _read_endpoint(r)
        else:
            r.skip(ftype)
    if key is None:
        return None
    if ann_type == _TYPE_BOOL:
        return V1BinaryAnnotation(key, raw == b"\x01" or raw == b"\x00\x01" or bool(raw and raw[-1]), host)
    return V1BinaryAnnotation(key, raw.decode(errors="replace"), host)


def _read_v1_span(r: _Reader) -> V1Span:
    trace_id = 0
    trace_id_high = 0
    span_id = 0
    parent_id = 0
    name = None
    annotations: List[V1Annotation] = []
    binary: List[V1BinaryAnnotation] = []
    debug = None
    timestamp = None
    duration = None
    while True:
        ftype = r.u8()
        if ftype == _T_STOP:
            break
        fid = r.i16()
        if fid == 1 and ftype == _T_I64:
            trace_id = r.i64()
        elif fid == 3 and ftype == _T_STRING:
            name = r.binary().decode(errors="replace")
        elif fid == 4 and ftype == _T_I64:
            span_id = r.i64()
        elif fid == 5 and ftype == _T_I64:
            parent_id = r.i64()
        elif fid == 6 and ftype == _T_LIST:
            r.u8()  # element type (struct)
            for _ in range(r._count()):
                ann = _read_annotation(r)
                if ann is not None:
                    annotations.append(ann)
        elif fid == 8 and ftype == _T_LIST:
            r.u8()
            for _ in range(r._count()):
                b = _read_binary_annotation(r)
                if b is not None:
                    binary.append(b)
        elif fid == 9 and ftype == _T_BOOL:
            debug = bool(r.u8())
        elif fid == 10 and ftype == _T_I64:
            timestamp = r.i64()
        elif fid == 11 and ftype == _T_I64:
            duration = r.i64()
        elif fid == 12 and ftype == _T_I64:
            trace_id_high = r.i64()
        else:
            r.skip(ftype)
    if trace_id_high:
        tid = to_lower_hex(trace_id_high) + to_lower_hex(trace_id)
    else:
        tid = to_lower_hex(trace_id)
    return V1Span(
        trace_id=tid,
        id=to_lower_hex(span_id),
        parent_id=to_lower_hex(parent_id) if parent_id else None,
        name=name,
        timestamp=timestamp,
        duration=duration,
        annotations=tuple(annotations),
        binary_annotations=tuple(binary),
        debug=debug,
    )


def decode_span_list(data: bytes) -> List[Span]:
    """Decode a thrift list<Span> (first byte 0x0c = T_STRUCT element type)."""
    r = _Reader(data)
    etype = r.u8()
    if etype != _T_STRUCT:
        raise ValueError("expected thrift list of structs")
    count = r._count()
    v1_spans = [_read_v1_span(r) for _ in range(count)]
    return convert_v1_spans(v1_spans)


# -- writer (SpanBytesEncoder.THRIFT parity) -------------------------------


class _Writer:
    """Minimal TBinaryProtocol writer."""

    def __init__(self) -> None:
        self.parts: List[bytes] = []

    def u8(self, v: int) -> None:
        self.parts.append(struct.pack(">B", v))

    def i16(self, v: int) -> None:
        self.parts.append(struct.pack(">h", v))

    def i32(self, v: int) -> None:
        self.parts.append(struct.pack(">i", v))

    def i64(self, v: int) -> None:
        self.parts.append(struct.pack(">q", v & 0xFFFFFFFFFFFFFFFF if v >= 0 else v))

    def binary(self, v: bytes) -> None:
        self.i32(len(v))
        self.parts.append(v)

    def field(self, ftype: int, fid: int) -> None:
        self.u8(ftype)
        self.i16(fid)

    def stop(self) -> None:
        self.u8(_T_STOP)

    def bytes(self) -> bytes:
        return b"".join(self.parts)


def _u64(hex_id: Optional[str]) -> int:
    return int(hex_id, 16) if hex_id else 0


def _signed64(v: int) -> int:
    return v - (1 << 64) if v >= (1 << 63) else v


def _write_endpoint(w: _Writer, ep: Optional[Endpoint]) -> None:
    if ep is None:
        ep = Endpoint()
    if ep.ipv4:
        w.field(_T_I32, 1)
        w.i32(int(ipaddress.IPv4Address(ep.ipv4)) - (1 << 32) if int(ipaddress.IPv4Address(ep.ipv4)) >= (1 << 31) else int(ipaddress.IPv4Address(ep.ipv4)))
    if ep.port:
        w.field(_T_I16, 2)
        w.i16(ep.port - (1 << 16) if ep.port >= (1 << 15) else ep.port)
    w.field(_T_STRING, 3)
    w.binary((ep.service_name or "").encode())
    if ep.ipv6:
        w.field(_T_STRING, 4)
        w.binary(ipaddress.IPv6Address(ep.ipv6).packed)
    w.stop()


_BEGIN_END = {
    "CLIENT": ("cs", "cr"),
    "SERVER": ("sr", "ss"),
    "PRODUCER": ("ms", None),
    "CONSUMER": ("mr", None),
}
_ADDR = {"CLIENT": "sa", "SERVER": "ca", "PRODUCER": "ma", "CONSUMER": "ma"}


def encode_span(span: Span) -> bytes:
    """One v2 span as a thrift v1 Span struct (the scribe message body).

    Same v2->v1 mapping as the JSON v1 encoder: kind becomes cs/cr/sr/ss
    core annotations, tags become string binary annotations,
    remoteEndpoint the matching address annotation.
    """
    w = _Writer()
    w.field(_T_I64, 1)
    w.i64(_signed64(_u64(span.trace_id[-16:])))
    w.field(_T_STRING, 3)
    w.binary((span.name or "").encode())
    w.field(_T_I64, 4)
    w.i64(_signed64(_u64(span.id)))
    if span.parent_id:
        w.field(_T_I64, 5)
        w.i64(_signed64(_u64(span.parent_id)))

    anns = []
    kind = span.kind.value if span.kind else None
    begin_end = _BEGIN_END.get(kind) if kind else None
    if begin_end and span.timestamp:
        begin, end = begin_end
        anns.append((span.timestamp, begin))
        if end and span.duration:
            anns.append((span.timestamp + span.duration, end))
    for a in span.annotations:
        anns.append((a.timestamp, a.value))
    w.field(_T_LIST, 6)
    w.u8(_T_STRUCT)
    w.i32(len(anns))
    for ts, value in anns:
        w.field(_T_I64, 1)
        w.i64(ts)
        w.field(_T_STRING, 2)
        w.binary(value.encode())
        w.field(_T_STRUCT, 3)
        _write_endpoint(w, span.local_endpoint)
        w.stop()

    bins = [(k, v.encode(), 6, span.local_endpoint) for k, v in span.tags.items()]
    if span.remote_endpoint is not None and kind:
        bins.append((_ADDR[kind], b"\x01", 0, span.remote_endpoint))
    w.field(_T_LIST, 8)
    w.u8(_T_STRUCT)
    w.i32(len(bins))
    for key, value, btype, ep in bins:
        w.field(_T_STRING, 1)
        w.binary(key.encode())
        w.field(_T_STRING, 2)
        w.binary(value)
        w.field(_T_I32, 3)
        w.i32(btype)
        w.field(_T_STRUCT, 4)
        _write_endpoint(w, ep)
        w.stop()

    if span.debug:
        w.field(_T_BOOL, 9)
        w.u8(1)
    if span.timestamp and not span.shared:
        w.field(_T_I64, 10)
        w.i64(span.timestamp)
    if span.duration and not span.shared:
        w.field(_T_I64, 11)
        w.i64(span.duration)
    if len(span.trace_id) == 32:
        w.field(_T_I64, 12)
        w.i64(_signed64(_u64(span.trace_id[:16])))
    w.stop()
    return w.bytes()


def encode_span_list(spans: List[Span]) -> bytes:
    """thrift list<Span> (first byte 0x0c), the ingest wire shape."""
    w = _Writer()
    w.u8(_T_STRUCT)
    w.i32(len(spans))
    out = [w.bytes()]
    out.extend(encode_span(s) for s in spans)
    return b"".join(out)

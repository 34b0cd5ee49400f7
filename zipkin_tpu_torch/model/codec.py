"""Codec dispatch: wire-format auto-detection and the encoder/decoder enums.

The port's own copy of ``zipkin_tpu/model/codec.py``: imports point at
``zipkin_tpu_torch``; the semantics are the reference's.

Reference semantics: ``zipkin2/codec/SpanBytesDecoder.java`` /
``SpanBytesEncoder.java`` and the first-byte sniffing in
``ZipkinHttpCollector`` (SURVEY.md §3.2): ``[`` begins JSON (v1 or v2
distinguished by content), ``0x0a`` a proto3 ``ListOfSpans`` (field 1,
length-delimited), ``0x0c`` a thrift struct-list.
"""

from __future__ import annotations

import enum
import json
from typing import Callable, List, Sequence

from zipkin_tpu_torch.model import json_v1, json_v2, proto3, thrift
from zipkin_tpu_torch.model.span import Span


class Encoding(enum.Enum):
    JSON_V2 = "json_v2"
    JSON_V1 = "json_v1"
    PROTO3 = "proto3"
    THRIFT = "thrift"

    @property
    def media_type(self) -> str:
        return {
            Encoding.JSON_V2: "application/json",
            Encoding.JSON_V1: "application/json",
            Encoding.PROTO3: "application/x-protobuf",
            Encoding.THRIFT: "application/x-thrift",
        }[self]


_DECODERS: dict = {
    Encoding.JSON_V2: json_v2.decode_span_list,
    Encoding.JSON_V1: json_v1.decode_v1_span_list,
    Encoding.PROTO3: proto3.decode_span_list,
    Encoding.THRIFT: thrift.decode_span_list,
}

_ENCODERS: dict = {
    Encoding.JSON_V2: json_v2.encode_span_list,
    Encoding.JSON_V1: json_v1.encode_v1_span_list,
    Encoding.PROTO3: proto3.encode_span_list,
    Encoding.THRIFT: thrift.encode_span_list,
}


def _looks_like_v1_json(data: bytes) -> bool:
    """v1 JSON is distinguished by binaryAnnotations or endpoint'd annotations."""
    if b'"binaryAnnotations"' in data:
        return True
    # annotations with an "endpoint" member only exist in v1
    if b'"annotations"' in data and b'"endpoint"' in data:
        return True
    return False


def _looks_like_json(data: bytes) -> bool:
    """Whitespace-tolerant JSON shape check: opens with [/{ and closes with
    ]/} after stripping whitespace. A payload that is ALSO a structurally
    valid proto3 frame is resolved by detect() in proto3's favor."""
    head = data[:256].lstrip(b" \t\r\n")
    tail = data[-64:].rstrip(b" \t\r\n")
    return head[:1] in (b"[", b"{") and tail[-1:] in (b"]", b"}")


def _plausible_proto3_frame(data: bytes) -> bool:
    """True if ``data`` is structurally a proto3 ``ListOfSpans``: repeated
    0x0A-tagged length-delimited elements consuming the payload exactly."""
    pos, n = 0, len(data)
    while pos < n:
        if data[pos] != 0x0A:
            return False
        pos += 1
        # varint length
        length, shift = 0, 0
        while True:
            if pos >= n or shift > 28:
                return False
            b = data[pos]
            pos += 1
            length |= (b & 0x7F) << shift
            if not b & 0x80:
                break
            shift += 7
        pos += length
    return pos == n


def detect(data: bytes) -> Encoding:
    """Sniff the encoding of an ingest payload from its first byte(s)."""
    if not data:
        raise ValueError("empty payload")
    first = data[0]
    # 0x0A is ambiguous: proto3's field-1 header AND '\n'. A proto3 payload
    # can even end in 0x7D (string tag ending in '}'), so the JSON shape
    # check alone cannot resolve it; a structural frame walk can — a valid
    # ListOfSpans is a sequence of 0x0A-tagged length-delimited elements
    # consuming the payload exactly, which whitespace-padded JSON is not.
    if first == 0x0A:
        if _plausible_proto3_frame(data):
            return Encoding.PROTO3
        if _looks_like_json(data):
            return Encoding.JSON_V1 if _looks_like_v1_json(data) else Encoding.JSON_V2
        return Encoding.PROTO3
    if first in (0x5B, 0x7B) or (
        first in (0x20, 0x09, 0x0D) and _looks_like_json(data)
    ):
        return Encoding.JSON_V1 if _looks_like_v1_json(data) else Encoding.JSON_V2
    if first == 0x0C:
        return Encoding.THRIFT
    raise ValueError(f"unrecognized span payload (first byte 0x{first:02x})")


def decode_spans(data: bytes, encoding: Encoding | None = None) -> List[Span]:
    """Decode an ingest payload to v2 spans, sniffing the format if needed."""
    enc = encoding or detect(data)
    decoder: Callable[[bytes], List[Span]] = _DECODERS[enc]
    return decoder(data)


def encode_spans(spans: Sequence[Span], encoding: Encoding = Encoding.JSON_V2) -> bytes:
    encoder = _ENCODERS.get(encoding)
    if encoder is None:
        raise ValueError(f"encoding {encoding} does not support span encode")
    return encoder(spans)


def pretty_json(data: bytes) -> str:  # pragma: no cover - debug aid
    return json.dumps(json.loads(data), indent=2)

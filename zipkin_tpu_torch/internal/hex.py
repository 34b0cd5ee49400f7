"""Hex trace/span-id codecs and time bucketing.

The port's own copy of ``zipkin_tpu/internal/hex.py``: imports point at
``zipkin_tpu_torch``; the semantics are the reference's.

Reference semantics: ``zipkin2/internal/HexCodec.java`` and
``zipkin2/internal/DateUtil.java`` (SURVEY.md §2.1).

Zipkin ids are lower-hex strings: span ids are 64-bit (16 chars), trace ids
are 64- or 128-bit (16 or 32 chars). Normalization left-pads with zeros to
the nearest of those widths and lowercases. ``lower_64`` extracts the low 64
bits — the basis both of non-strict trace-id matching and of boundary
sampling (``CollectorSampler``).
"""

from __future__ import annotations

from typing import List, Optional

_HEX = set("0123456789abcdef")

DAY_MS = 86_400_000


def normalize_trace_id(trace_id: str) -> str:
    """Validate + canonicalize a trace id to 16 or 32 lower-hex chars.

    Mirrors ``Span.normalizeTraceId``: 1..32 hex chars accepted; ids longer
    than 16 chars pad to 32, otherwise to 16. Raises ``ValueError`` on
    non-hex input, empty input, or all zeros.
    """
    if trace_id is None:
        raise ValueError("traceId is required")
    lowered = trace_id.lower()
    n = len(lowered)
    if n == 0 or n > 32:
        raise ValueError(f"traceId should be 1..32 hex characters: {trace_id!r}")
    if not set(lowered) <= _HEX:
        raise ValueError(f"traceId is not lower-hex: {trace_id!r}")
    width = 32 if n > 16 else 16
    padded = lowered.zfill(width)
    if padded.strip("0") == "":
        raise ValueError("traceId is all zeros")
    return padded


def normalize_span_id(span_id: str, *, name: str = "id") -> str:
    """Validate + canonicalize a 64-bit span id to 16 lower-hex chars."""
    if span_id is None:
        raise ValueError(f"{name} is required")
    lowered = span_id.lower()
    n = len(lowered)
    if n == 0 or n > 16:
        raise ValueError(f"{name} should be 1..16 hex characters: {span_id!r}")
    if not set(lowered) <= _HEX:
        raise ValueError(f"{name} is not lower-hex: {span_id!r}")
    padded = lowered.zfill(16)
    if padded == "0" * 16:
        raise ValueError(f"{name} is all zeros")
    return padded


def normalize_parent_id(parent_id: Optional[str]) -> Optional[str]:
    """Like :func:`normalize_span_id` but an all-zero / empty parent is None."""
    if parent_id is None or parent_id == "":
        return None
    lowered = parent_id.lower()
    if len(lowered) > 16 or not set(lowered) <= _HEX:
        raise ValueError(f"parentId should be 1..16 hex characters: {parent_id!r}")
    padded = lowered.zfill(16)
    if padded == "0" * 16:
        return None
    return padded


def lower_64(trace_id: str) -> int:
    """The low 64 bits of a normalized trace id, as an unsigned int."""
    return int(trace_id[-16:], 16)


def to_lower_hex(value: int, *, width: int = 16) -> str:
    """Unsigned int -> zero-padded lower-hex."""
    return format(value & ((1 << (4 * width)) - 1), f"0{width}x")


def midnight_utc(epoch_ms: int) -> int:
    """Floor an epoch-millis timestamp to its UTC day boundary.

    Reference: ``DateUtil.midnightUTC`` — the bucket key for daily dependency
    rollups and time-ring retention shards.
    """
    return epoch_ms - (epoch_ms % DAY_MS)


def epoch_minutes(epoch_ms: int) -> int:
    """Epoch minutes — the device tier's time unit (ring ``ts_min``,
    rollup/slice bucket inputs); clamped at 0. The single ms-to-minute
    conversion point for query windows (TpuStorage)."""
    return max(int(epoch_ms) // 60_000, 0)


def epoch_day_buckets(end_ts_ms: int, lookback_ms: int) -> List[int]:
    """All UTC-day bucket start times covering ``(end_ts - lookback, end_ts]``.

    Reference: ``DateUtil.epochDays`` — used by daily-rollup dependency reads.
    """
    if end_ts_ms <= 0:
        raise ValueError("endTs must be positive")
    if lookback_ms <= 0:
        raise ValueError("lookback must be positive")
    start = midnight_utc(max(end_ts_ms - lookback_ms, 0))
    end = midnight_utc(end_ts_ms)
    return list(range(start, end + 1, DAY_MS))

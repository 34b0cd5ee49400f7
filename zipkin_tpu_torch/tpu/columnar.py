"""Host-side columnar batch and packed wire image (the port's copy of the
parts of ``zipkin_tpu/tpu/columnar.py`` its path needs).

numpy only. :class:`SpanColumns` is one fixed-shape batch; the whole
batch travels to the device as one ``[11, n]`` u32 image
(:func:`fuse_columns`), unpacked there by
:func:`zipkin_tpu_torch.parallel.aggregator.unfuse_columns`.
``pack_spans`` (Span objects -> columns) needs the span model and comes
with the port's store.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

_U32 = np.uint32

# Packed wire image: 11 u32 rows = 44 B/span.
#   rows 0-8: trace_h, tl0, tl1, s0, s1, p0, p1, dur, ts_min (plain u32)
#   row 9:    svc << 16 | rsvc          (service ids, u16 each)
#   row 10:   key << 8 | kind << 4 | has_dur << 3 | err << 2
#             | shared << 1 | valid     (key u24 + 8 flag bits)
WIRE_ROWS = 11
_PLAIN = ("trace_h", "tl0", "tl1", "s0", "s1", "p0", "p1", "dur", "ts_min")
# hard ceilings implied by the packing
MAX_WIRE_SERVICES = 1 << 16
MAX_WIRE_KEYS = 1 << 24


def _mix32(x: np.ndarray) -> np.ndarray:
    """numpy murmur3 fmix32 (same bits as zipkin_tpu_torch.ops.hashing.fmix32)."""
    x = x.astype(np.uint32)
    x ^= x >> _U32(16)
    x = (x.astype(np.uint64) * np.uint64(0x85EBCA6B)).astype(np.uint32)
    x ^= x >> _U32(13)
    x = (x.astype(np.uint64) * np.uint64(0xC2B2AE35)).astype(np.uint32)
    x ^= x >> _U32(16)
    return x


def _hash2_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return _mix32(
        a.astype(np.uint32)
        ^ _mix32((b.astype(np.uint64) + np.uint64(0x9E3779B9)).astype(np.uint32))
    )


class SpanColumns(NamedTuple):
    """One fixed-shape batch; every field is an array of length n (numpy
    on the host, torch tensors once unpacked on the device)."""

    trace_h: np.ndarray  # u32 avalanche hash of the full trace id
    tl0: np.ndarray  # u32 trace id low-64 lanes
    tl1: np.ndarray
    s0: np.ndarray  # u32 span id lanes
    s1: np.ndarray
    p0: np.ndarray  # u32 parent id lanes (0,0 = absent)
    p1: np.ndarray
    shared: np.ndarray  # bool
    kind: np.ndarray  # i32 kind id (0 none, 1 client, 2 server, 3 producer, 4 consumer)
    svc: np.ndarray  # i32 local service id
    rsvc: np.ndarray  # i32 remote service id
    key: np.ndarray  # i32 (service, spanName) sketch row
    err: np.ndarray  # bool
    dur: np.ndarray  # u32 duration µs (clamped), 0 if absent
    has_dur: np.ndarray  # bool
    ts_min: np.ndarray  # u32 epoch minutes
    valid: np.ndarray  # bool

    @property
    def size(self) -> int:
        return int(self.valid.shape[0])


def fuse_columns(cols: SpanColumns) -> np.ndarray:
    """One contiguous packed u32 image of a batch: ``[..., 11, n]``."""
    d = cols._asdict()
    lead = cols.valid.shape[:-1]
    n = cols.valid.shape[-1]
    out = np.empty(lead + (WIRE_ROWS, n), np.uint32)
    for i, name in enumerate(_PLAIN):
        out[..., i, :] = d[name]
    out[..., 9, :] = (d["svc"].astype(np.uint32) << _U32(16)) | d["rsvc"].astype(np.uint32)
    out[..., 10, :] = (
        (d["key"].astype(np.uint32) << _U32(8))
        | (d["kind"].astype(np.uint32) << _U32(4))
        | (d["has_dur"].astype(np.uint32) << _U32(3))
        | (d["err"].astype(np.uint32) << _U32(2))
        | (d["shared"].astype(np.uint32) << _U32(1))
        | d["valid"].astype(np.uint32)
    )
    return out


def empty_columns(n: int) -> SpanColumns:
    z32 = np.zeros(n, _U32)
    return SpanColumns(
        trace_h=z32.copy(), tl0=z32.copy(), tl1=z32.copy(),
        s0=z32.copy(), s1=z32.copy(), p0=z32.copy(), p1=z32.copy(),
        shared=np.zeros(n, bool), kind=np.zeros(n, np.int32),
        svc=np.zeros(n, np.int32), rsvc=np.zeros(n, np.int32),
        key=np.zeros(n, np.int32), err=np.zeros(n, bool),
        dur=z32.copy(), has_dur=np.zeros(n, bool),
        ts_min=z32.copy(), valid=np.zeros(n, bool),
    )


def remap_fused(fused: np.ndarray, svc_map: np.ndarray, key_map: np.ndarray) -> None:
    """Remap a packed image's service/key id lanes in place through
    ``svc_map``/``key_map`` (u32 lookup tables indexed by old id)."""
    sr = fused[..., 9, :]
    fused[..., 9, :] = (svc_map[sr >> _U32(16)] << _U32(16)) | svc_map[sr & _U32(0xFFFF)]
    kf = fused[..., 10, :]
    fused[..., 10, :] = (key_map[kf >> _U32(8)] << _U32(8)) | (kf & _U32(0xFF))


def concat_remap(parts, out: np.ndarray) -> int:
    """Gather ``(fused, svc_map, key_map)`` chunk images lane-contiguously
    into the zeroed bucket image ``out`` (trailing pad lanes stay zero,
    valid=0), remapping ids on the copied lanes. Returns lanes used."""
    off = 0
    for fused, svc_map, key_map in parts:
        per = fused.shape[-1]
        dst = out[..., off:off + per]
        dst[:] = fused
        remap_fused(dst, svc_map, key_map)
        off += per
    return off

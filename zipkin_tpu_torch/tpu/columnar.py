"""Host-side columnar packing and the packed wire image (the port's copy of
the parts of ``zipkin_tpu/tpu/columnar.py`` its path needs).

numpy only. :func:`pack_spans` turns the port's :class:`Span` objects,
and :func:`pack_parsed` the native parser's columns, into one fixed-shape
:class:`SpanColumns` batch, interning service and span
names into a bounded :class:`Vocab` (id 0 is "unknown/absent"; overflow
past capacity lands in id 0, or in the service's catch-all key row, and is
counted). The whole batch travels to the device as one ``[11, n]`` u32
image (:func:`fuse_columns`), unpacked there by
:func:`zipkin_tpu_torch.parallel.aggregator.unfuse_columns`. Trace and span
ids travel as u32 lane pairs; ``trace_h`` is a 32-bit avalanche hash of
the full 128-bit trace id (HLL cardinality, the cheap first join lane).
"""

from __future__ import annotations

import threading
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from zipkin_tpu_torch.internal.hex import normalize_trace_id
from zipkin_tpu_torch.model.span import Kind, Span

KIND_TO_ID = {
    None: 0,
    Kind.CLIENT: 1,
    Kind.SERVER: 2,
    Kind.PRODUCER: 3,
    Kind.CONSUMER: 4,
}
ID_TO_KIND = {v: k for k, v in KIND_TO_ID.items()}

_U32 = np.uint32
_MASK32 = 0xFFFFFFFF

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


class Interner:
    """Bounded, thread-safe string -> dense id map. Id 0 is reserved."""

    def __init__(self, capacity: int) -> None:
        self.capacity = capacity
        self._ids: Dict[str, int] = {}
        self._names: List[str] = [""]  # id 0
        self._overflow = 0
        self._lock = threading.Lock()

    def intern(self, name: Optional[str]) -> int:
        if not name:
            return 0
        with self._lock:
            got = self._ids.get(name)
            if got is not None:
                return got
            if len(self._names) >= self.capacity:
                self._overflow += 1
                return 0
            nid = len(self._names)
            self._ids[name] = nid
            self._names.append(name)
            return nid

    def lookup(self, nid: int) -> str:
        return self._names[nid] if 0 <= nid < len(self._names) else ""

    def get(self, name: str) -> Optional[int]:
        return self._ids.get(name)

    @property
    def names(self) -> List[str]:
        return self._names[1:]

    @property
    def overflow(self) -> int:
        return self._overflow

    def __len__(self) -> int:
        return len(self._names)


class Vocab:
    """The interners one store shares across batches: service names, span
    names, and ``keys``, the (service, spanName) pairs that are the sketch
    row space of the latency digests and histograms."""

    def __init__(self, max_services: int = 1024, max_keys: int = 8192) -> None:
        self.services = Interner(max_services)
        self.span_names = Interner(max_keys)
        self._keys: Dict[Tuple[int, int], int] = {}
        self._key_list: List[Tuple[int, int]] = [(0, 0)]
        self.max_keys = max_keys
        self._overflow = 0
        self._lock = threading.Lock()

    def key_id(self, service_id: int, span_name_id: int) -> int:
        pair = (service_id, span_name_id)
        with self._lock:
            got = self._keys.get(pair)
            if got is not None:
                return got
            if span_name_id != 0 and service_id != 0:
                # reserve the service's catch-all (svc, 0) before its first
                # named pair: past capacity, span-name churn then lands in
                # its service's row instead of the global unknown row 0.
                # Service 0 is the unknown itself and gets no catch-all.
                ca = (service_id, 0)
                if ca not in self._keys and len(self._key_list) < self.max_keys:
                    cid = len(self._key_list)
                    self._keys[ca] = cid
                    self._key_list.append(ca)
            if len(self._key_list) >= self.max_keys:
                self._overflow += 1
                if span_name_id != 0 and service_id != 0:
                    return self._keys.get((service_id, 0), 0)
                return 0
            kid = len(self._key_list)
            self._keys[pair] = kid
            self._key_list.append(pair)
            return kid

    def append_pair(self, service_id: int, span_name_id: int) -> int:
        """Position-faithful append for replay (WAL, snapshots; port of
        ``zipkin_tpu/tpu/columnar.py:153-170``): the pair takes the next id
        with no catch-all reserved before it, so a recorded id assignment
        comes back as it was. Live ingest uses :meth:`key_id`."""
        pair = (service_id, span_name_id)
        with self._lock:
            got = self._keys.get(pair)
            if got is not None:
                return got
            if len(self._key_list) >= self.max_keys:
                self._overflow += 1
                return 0
            kid = len(self._key_list)
            self._keys[pair] = kid
            self._key_list.append(pair)
            return kid

    def key_pair(self, key_id: int) -> Tuple[int, int]:
        return self._key_list[key_id] if 0 <= key_id < len(self._key_list) else (0, 0)

    @property
    def num_keys(self) -> int:
        return len(self._key_list)


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
    kind: np.ndarray  # i32 KIND_TO_ID
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


def _pad(n: int, multiple: int) -> int:
    if n == 0:
        return multiple
    return ((n + multiple - 1) // multiple) * multiple


def pack_spans(spans: Sequence[Span], vocab: Vocab, pad_to_multiple: int = 1024) -> SpanColumns:
    """Pack spans into one columnar batch padded (valid=0) to a multiple of
    ``pad_to_multiple`` lanes, interning their names into ``vocab``."""
    n = len(spans)
    cap = _pad(n, pad_to_multiple)
    cols = empty_columns(cap)

    hi = np.zeros(n, np.uint64)
    lo = np.zeros(n, np.uint64)
    for i, span in enumerate(spans):
        full = int(normalize_trace_id(span.trace_id), 16)
        lo[i] = full & 0xFFFFFFFFFFFFFFFF
        hi[i] = full >> 64
        sid = int(span.id, 16)
        cols.s0[i] = sid & _MASK32
        cols.s1[i] = (sid >> 32) & _MASK32
        if span.parent_id:
            pid = int(span.parent_id, 16)
            cols.p0[i] = pid & _MASK32
            cols.p1[i] = (pid >> 32) & _MASK32
        cols.shared[i] = bool(span.shared)
        cols.kind[i] = KIND_TO_ID[span.kind]
        svc = vocab.services.intern(span.local_service_name)
        cols.svc[i] = svc
        cols.rsvc[i] = vocab.services.intern(span.remote_service_name)
        name_id = vocab.span_names.intern(span.name)
        cols.key[i] = vocab.key_id(svc, name_id)
        cols.err[i] = span.is_error
        if span.duration is not None:
            cols.dur[i] = min(int(span.duration), _MASK32)
            cols.has_dur[i] = True
        if span.timestamp is not None:
            cols.ts_min[i] = min(int(span.timestamp) // 60_000_000, _MASK32)
        cols.valid[i] = True

    cols.tl0[:n] = (lo & _MASK32).astype(_U32)
    cols.tl1[:n] = (lo >> np.uint64(32)).astype(_U32)
    hi32 = _hash2_np((hi & _MASK32).astype(_U32), (hi >> np.uint64(32)).astype(_U32))
    cols.trace_h[:n] = _hash2_np(_hash2_np(cols.tl0[:n], cols.tl1[:n]), hi32)
    return cols


def pack_parsed(parsed, vocab: Vocab, pad_to_multiple: int = 1024) -> SpanColumns:
    """Columns from a native parse (:func:`zipkin_tpu_torch.native.parse_spans`,
    port of ``zipkin_tpu/tpu/columnar.py:280`` ``pack_parsed``): the fast
    ingest path, no Span objects, strings interned straight from the wire
    buffer's slices.

    A parse made against a ``NativeVocab`` carries its ids already; else
    each slice is interned here, cached per call by its raw bytes (names
    repeat heavily within a batch)."""
    n = parsed.n
    cap = _pad(n, pad_to_multiple)
    svc = np.zeros(cap, np.int32)
    rsvc = np.zeros(cap, np.int32)
    key = np.zeros(cap, np.int32)

    if getattr(parsed, "svc_id", None) is not None:
        # interning already happened inside the native parse
        svc[:n] = parsed.svc_id[:n]
        rsvc[:n] = parsed.rsvc_id[:n]
        key[:n] = parsed.key_id[:n]
        return _assemble(parsed, n, cap, svc, rsvc, key)

    mv = memoryview(parsed.data)
    intern_svc = vocab.services.intern
    intern_name = vocab.span_names.intern
    scache: Dict[bytes, int] = {}
    ncache: Dict[bytes, int] = {}
    kcache: Dict[Tuple[int, int], int] = {}
    soff, slen = parsed.svc_off, parsed.svc_len
    roff, rlen = parsed.rsvc_off, parsed.rsvc_len
    noff, nlen = parsed.name_off, parsed.name_len

    def sid_of(off: int, ln: int) -> int:
        if ln == 0:
            return 0
        raw = bytes(mv[off : off + ln])
        got = scache.get(raw)
        if got is None:
            got = scache[raw] = intern_svc(raw.decode("utf-8", "replace").lower())
        return got

    for i in range(n):
        s = sid_of(soff[i], slen[i])
        svc[i] = s
        rsvc[i] = sid_of(roff[i], rlen[i])
        nid = 0
        if nlen[i]:
            raw = bytes(mv[noff[i] : noff[i] + nlen[i]])
            nid = ncache.get(raw)
            if nid is None:
                nid = ncache[raw] = intern_name(raw.decode("utf-8", "replace").lower())
        kid = kcache.get((s, nid))
        if kid is None:
            kid = kcache[(s, nid)] = vocab.key_id(s, nid)
        key[i] = kid
    return _assemble(parsed, n, cap, svc, rsvc, key)


def sample_slices(parsed, every: int) -> List[bytes]:
    """The raw byte extents of the trace-affine 1 in ``every`` sample of a
    native parse (0: none): the spans whose xor-folded trace id hashes to 0
    mod ``every``, so a trace is sampled whole whatever parsed it (the
    line-rate path's host archive sample, and the parse workers' half of
    it)."""
    n = parsed.n
    if every <= 0 or n == 0:
        return []
    tid = parsed.tl0[:n] ^ parsed.tl1[:n] ^ parsed.th0[:n] ^ parsed.th1[:n]
    pick = np.nonzero(_mix32(tid) % np.uint32(every) == 0)[0]
    data, off, ln = parsed.data, parsed.span_off, parsed.span_len
    return [bytes(data[off[i] : off[i] + ln[i]]) for i in pick]


def _assemble(parsed, n: int, cap: int, svc, rsvc, key) -> SpanColumns:
    """The padded batch of a parse's first ``n`` lanes and its id lanes
    (port of ``zipkin_tpu/tpu/columnar.py:351``)."""

    def padded(a: np.ndarray, dtype) -> np.ndarray:
        out = np.zeros(cap, dtype)
        out[:n] = a[:n]
        return out

    hi32 = _hash2_np(parsed.th0[:n], parsed.th1[:n])
    trace_h = np.zeros(cap, _U32)
    trace_h[:n] = _hash2_np(_hash2_np(parsed.tl0[:n], parsed.tl1[:n]), hi32)
    valid = np.zeros(cap, bool)
    valid[:n] = True
    return SpanColumns(
        trace_h=trace_h,
        tl0=padded(parsed.tl0, _U32), tl1=padded(parsed.tl1, _U32),
        s0=padded(parsed.s0, _U32), s1=padded(parsed.s1, _U32),
        p0=padded(parsed.p0, _U32), p1=padded(parsed.p1, _U32),
        shared=padded(parsed.shared, bool),
        kind=padded(parsed.kind, np.int32),
        svc=svc, rsvc=rsvc, key=key,
        err=padded(parsed.err, bool),
        dur=padded(parsed.dur_us, _U32),
        has_dur=padded(parsed.has_dur, bool),
        ts_min=padded((parsed.ts_us // 60_000_000).astype(_U32), _U32),
        valid=valid,
    )


def _route_order(shard_of: np.ndarray, n_shards: int, pad_to_multiple: int):
    """(order, counts, starts, per): lanes stably sorted by shard id, so
    shard ``s`` owns ``order[starts[s] : starts[s] + counts[s]]`` in
    insertion order; ``per`` is the largest count rounded up to
    ``pad_to_multiple`` (port of ``zipkin_tpu/tpu/columnar.py:429``)."""
    key_dtype = np.uint8 if n_shards < 255 else np.uint16
    order = np.argsort(shard_of.astype(key_dtype), kind="stable")
    counts = np.bincount(shard_of, minlength=n_shards + 1)[:n_shards]
    per = max(int(counts.max()), 1)
    per = ((per + pad_to_multiple - 1) // pad_to_multiple) * pad_to_multiple
    starts = np.zeros(n_shards, np.int64)
    np.cumsum(counts[:-1], out=starts[1:])
    return order, counts, starts, per


def _shard_of(cols: SpanColumns, n_shards: int) -> np.ndarray:
    """Trace-affine shard id per lane; invalid lanes go to the sink
    ``n_shards`` (all spans of a trace land on one shard)."""
    return np.where(cols.valid, cols.trace_h % np.uint32(n_shards), n_shards).astype(np.int32)


def route_fused(cols: SpanColumns, n_shards: int, pad_to_multiple: int = 256) -> np.ndarray:
    """Fuse and route in one pass: the ``[shards, 11, per]`` u32 wire image
    (port of ``zipkin_tpu/tpu/columnar.py:462``). With one shard it is the
    fused image with a leading axis; with more, each shard's lanes are one
    contiguous gather and ``per`` is rounded up to ``pad_to_multiple``."""
    fz = fuse_columns(cols)
    if n_shards == 1:
        return fz[None]
    order, counts, starts, per = _route_order(_shard_of(cols, n_shards), n_shards, pad_to_multiple)
    out = np.zeros((n_shards, fz.shape[0], per), np.uint32)
    for s in range(n_shards):
        c = int(counts[s])
        if c:
            np.take(fz, order[starts[s] : starts[s] + c], axis=1, out=out[s, :, :c])
    return out


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

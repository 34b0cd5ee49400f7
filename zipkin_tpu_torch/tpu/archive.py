"""Disk-backed raw-span archive: the trace store behind the sketches (the
port's copy of ``zipkin_tpu/tpu/archive.py``; numpy and the standard
library, no torch).

Every ingested span stays queryable for the retention window, as in the
reference's row stores, and not only the line-rate path's 1/N sample:

- **Write path** (once per ingest batch, sequential IO): the raw payload
  (JSON v2 or proto3) is appended to the current segment file inside a
  self-describing frame, with per-span byte extents (the native parser
  records them) and the columnar search fields (trace-id lanes,
  service/name/key ids, timestamp, duration, error). No re-encoding, no
  per-span work.
- **Segments** roll at a size bound and are sealed with sidecars: span rows
  sorted by the span's low-64 trace id (``.cols.npy``), that sorted id
  column (``.ids.npy``), both read back ``mmap_mode='r'``, and a zone map
  (``.meta.npz``) that lets a search skip a segment that cannot match.
- **Reads**: ``fetch_trace_raw`` binary-searches each segment's sorted ids
  (newest first) and preads exactly the matching spans' extents; strict
  trace ids also compare the stored high lanes. ``candidate_trace_ids``
  scans segment columns newest first with vectorized masks; the store
  decodes the candidates and applies the exact query predicate.
- **Retention** is a disk-byte budget (``max_bytes``): the oldest segments
  are deleted whole.
- **Recovery**: frames carry a magic and a crc; an unsealed tail segment is
  rebuilt by scanning its frames at boot, and a torn final frame is
  truncated (the WAL's torn-tail rule).

The file format is the reference's byte for byte (the ``ZARC`` frame, 11
u32 columns a span, the sidecars), so either package reads the other's
directory. Columns per span (u32): tl0 tl1 th0 th1 | off len | svc<<16|rsvc
| name | key | ts_min | dur<<1|err: 44 B a span beside the raw bytes.
"""

from __future__ import annotations

import errno
import logging
import os
import struct
import threading
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from zipkin_tpu_torch import faults

logger = logging.getLogger(__name__)

_MAGIC = 0x5A415243  # "ZARC"
_FRAME = struct.Struct("<IIII")  # magic, n_spans, payload_len, payload_crc
COLS = 11  # u32 lanes per span (see module docstring)


def verify_frames(path: str) -> dict:
    """At-rest integrity scan of one segment's data file (the
    scrubber's archive leg): walk every frame re-checking magic,
    structure, and payload crc — the sealed sidecar indexes carry the
    byte extents but no digest, so this is the only thing that can see
    rot in the raw span bytes. Returns ``{"ok", "frames", "spans",
    "bytes", "bad_offset"}``; ``spans`` counts spans in GOOD frames."""
    out = dict(ok=True, frames=0, spans=0, bytes=0, bad_offset=None)
    with open(path, "rb") as fh:
        while True:
            off = fh.tell()
            hdr = fh.read(_FRAME.size)
            if not hdr:
                break
            bad = len(hdr) < _FRAME.size
            if not bad:
                magic, n, plen, crc = _FRAME.unpack(hdr)
                bad = magic != _MAGIC
            if not bad:
                need = n * COLS * 4 + plen
                body = fh.read(need)
                bad = len(body) < need or zlib.crc32(body[n * COLS * 4:]) != crc
            if bad:
                out["ok"] = False
                out["bad_offset"] = off
                break
            out["frames"] += 1
            out["spans"] += n
            out["bytes"] = fh.tell()
    return out


def _id64(tl0: np.ndarray, tl1: np.ndarray) -> np.ndarray:
    """The span's low-64 trace id as one u64 sort/search key (EXACT, not
    a hash — lenient trace-id matching is exact low-64 equality)."""
    return (tl1.astype(np.uint64) << np.uint64(32)) | tl0.astype(np.uint64)


def parsed_record(parsed) -> Optional[tuple]:
    """Build one ``append_batch`` argument tuple from a native-parser
    chunk (``ParsedColumns``): compacted payload + per-span columns.
    Numpy-only, so parse workers can build records on their side;
    service/name/key lanes carry whatever id space the parser interned
    into. Returns None for an empty chunk.

    The payload is the chunk's contiguous byte range unless sampling
    punched >5% holes in it — then it compacts to exactly the kept
    slices, so dropped spans' raw bytes are never persisted as
    unindexed garbage."""
    n = parsed.n
    if n == 0:
        return None
    off = parsed.span_off[:n].astype(np.uint64)
    ln = parsed.span_len[:n].astype(np.uint64)
    lo = int(off[0])
    hi = int((off + ln).max())
    span_bytes = int(ln.sum())
    if span_bytes < (hi - lo) * 95 // 100:
        data = parsed.data
        parts = [
            bytes(data[int(o) : int(o) + int(l)])
            for o, l in zip(off.tolist(), ln.tolist())
        ]
        payload = b"".join(parts)
        new_off = np.concatenate([[0], np.cumsum(ln[:-1])]).astype(np.uint32)
    else:
        payload = bytes(parsed.data[lo:hi])
        new_off = (off - lo).astype(np.uint32)
    return (
        payload,
        new_off,
        parsed.span_len[:n].copy(),
        parsed.tl0[:n].copy(),
        parsed.tl1[:n].copy(),
        parsed.th0[:n].copy(),
        parsed.th1[:n].copy(),
        parsed.svc_id[:n].copy(),
        parsed.rsvc_id[:n].copy(),
        parsed.name_id[:n].copy(),
        parsed.key_id[:n].copy(),
        (parsed.ts_us[:n] // 60_000_000).astype(np.uint32),
        np.where(parsed.has_dur[:n], parsed.dur_us[:n], 0).astype(np.uint64),
        parsed.err[:n].copy(),
    )


def _fsync_dir(directory: str) -> None:
    """Make a rename in ``directory`` durable (same chokepoint idiom as
    snapshot.py / timetier.py — the dir entry itself needs the fsync)."""
    dfd = os.open(directory or ".", os.O_RDONLY)
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)


def _presence_bits(vals: np.ndarray) -> np.ndarray:
    """8KB bitmap of which u16 ids occur (ids >= 2^16 are the caller's
    overflow flag — the archive packs svc/rsvc into 16 bits, names can
    exceed it)."""
    bits = np.zeros(1 << 13, np.uint8)  # 65536 bits
    v = np.unique(vals[vals < (1 << 16)]).astype(np.int64)
    np.bitwise_or.at(bits, v >> 3, (1 << (v & 7)).astype(np.uint8))
    return bits


def _has_bit(bits: np.ndarray, i: int) -> bool:
    return bool(bits[i >> 3] & (1 << (i & 7)))


def build_segment_meta(cols: np.ndarray) -> dict:
    """Zone map + presence bitmaps for one sealed segment's index
    columns: lets a search skip whole segments that cannot match
    (the analog of pruning whole daily indexes). All
    filters are CONSERVATIVE: absence proves no match, presence proves
    nothing (the row mask still runs)."""
    c = np.asarray(cols)
    if c.shape[0] == 0:
        return dict(
            ts_min=np.uint32(0), ts_max=np.uint32(0),
            svc_bits=np.zeros(1 << 13, np.uint8),
            rsvc_bits=np.zeros(1 << 13, np.uint8),
            name_bits=np.zeros(1 << 13, np.uint8),
            name_overflow=np.uint8(0),
            dur_min=np.uint32(0), dur_max=np.uint32(0),
        )
    svc = c[:, 6] >> 16
    rsvc = c[:, 6] & 0xFFFF
    name = c[:, 7]
    ts = c[:, 9]
    dur = c[:, 10] >> 1
    present = dur[dur > 0]
    return dict(
        ts_min=ts.min(), ts_max=ts.max(),
        svc_bits=_presence_bits(svc),
        rsvc_bits=_presence_bits(rsvc),
        name_bits=_presence_bits(name),
        name_overflow=np.uint8(1 if (name >= (1 << 16)).any() else 0),
        dur_min=present.min() if present.size else np.uint32(0),
        dur_max=present.max() if present.size else np.uint32(0),
    )


def _meta_can_skip(
    meta: Optional[dict],
    *,
    ts_lo_min: int,
    ts_hi_min: int,
    svc_id: Optional[int],
    rsvc_id: Optional[int],
    name_id: Optional[int],
    min_dur: Optional[int],
    max_dur: Optional[int],
) -> bool:
    """True when the zone map PROVES no row of the segment can match."""
    if meta is None:
        return False
    if ts_hi_min < int(meta["ts_min"]) or ts_lo_min > int(meta["ts_max"]):
        return True
    if svc_id is not None and not _has_bit(meta["svc_bits"], svc_id):
        return True
    if rsvc_id is not None and not _has_bit(meta["rsvc_bits"], rsvc_id):
        return True
    if name_id is not None and not int(meta["name_overflow"]):
        if name_id < (1 << 16) and not _has_bit(meta["name_bits"], name_id):
            return True
    clamp = (1 << 31) - 1
    if min_dur is not None and max(min(min_dur, clamp), 1) > int(
        meta["dur_max"]
    ):
        return True
    if max_dur is not None and (
        int(meta["dur_min"]) == 0 or min(max_dur, clamp) < int(meta["dur_min"])
    ):
        return True
    return False


class _Segment:
    """One sealed segment: data file + mmap'd sorted index sidecars +
    a small zone-map/presence sidecar consulted before any row scan."""

    def __init__(self, path: str) -> None:
        self.path = path
        self.ids = np.load(path + ".ids.npy", mmap_mode="r")  # [n] u64 sorted
        self.cols = np.load(path + ".cols.npy", mmap_mode="r")  # [n, COLS] u32
        self.meta: Optional[dict] = None
        try:
            with np.load(path + ".meta.npz") as z:
                self.meta = {k: z[k] for k in z.files}
        except OSError:
            # a segment sealed without a zone map: build it once from the
            # cols (one full read) and persist it for the next boot
            try:
                self.meta = build_segment_meta(self.cols)
                tmp = path + ".meta.npz.tmp"
                with open(tmp, "wb") as f:
                    np.savez_compressed(f, **self.meta)
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, path + ".meta.npz")
                _fsync_dir(os.path.dirname(path))
            except OSError:  # read-only dir etc.: scan without skipping
                pass
        # a retained fd: reads survive retention's unlink (queries that
        # snapshotted views() before the delete still resolve)
        self._fd = os.open(path, os.O_RDONLY)

    def pread(self, off: int, ln: int) -> bytes:
        return os.pread(self._fd, ln, off)

    @property
    def n(self) -> int:
        return int(self.ids.shape[0])

    def bytes_used(self) -> int:
        total = 0
        for p in (
            self.path, self.path + ".ids.npy", self.path + ".cols.npy",
            self.path + ".meta.npz",
        ):
            try:
                total += os.path.getsize(p)
            except OSError:
                pass
        return total

    def close(self) -> None:
        # numpy mmaps close with GC; drop references eagerly
        self.ids = None
        self.cols = None
        if getattr(self, "_fd", None) is not None:
            try:
                os.close(self._fd)
            except OSError:
                pass
            self._fd = None

    def __del__(self):  # pragma: no cover - GC finalizer
        try:
            self.close()
        except Exception:
            pass


class SpanArchive:
    """Bounded disk archive of raw span JSON with a trace-id index."""

    def __init__(
        self,
        directory: str,
        *,
        max_bytes: int = 2 << 30,
        segment_bytes: int = 64 << 20,
    ) -> None:
        if segment_bytes > (3 << 30):
            # span offsets are segment-absolute u32; a segment may
            # overshoot its bound by one batch (~64MB), so cap well
            # below 4GiB instead of silently wrapping extents
            raise ValueError(
                f"segment_bytes ({segment_bytes}) must be <= 3GiB "
                "(u32 segment-absolute offsets)"
            )
        self.directory = directory
        self.max_bytes = max_bytes
        self.segment_bytes = segment_bytes
        os.makedirs(directory, exist_ok=True)
        self._lock = threading.Lock()
        self._sealed: List[_Segment] = []  # oldest -> newest
        # path -> _Segment for every sealed segment: a views() snapshot
        # taken while a segment was LIVE holds its path string; if the
        # segment seals (and maybe gets retention-unlinked) while the
        # query still holds that snapshot, the path resolves here to the
        # sealed segment's retained fd instead of FileNotFoundError ->
        # silent []. Retention moves its entry to a small
        # FIFO (`_retired`) so reads survive a bounded churn window
        # without pinning every evicted segment's fd forever.
        self._path_to_seg: Dict[str, _Segment] = {}
        self._retired: List[str] = []  # paths, oldest first, cap 8
        self._live_fh = None
        self._live_path: Optional[str] = None
        self._live_bytes = 0
        self._live_rows: List[np.ndarray] = []  # [n, COLS] u32 chunks
        self._seg_idx = 0
        self._closed = False
        self.spans_written = 0
        self.spans_dropped_retention = 0
        # segments excluded from a search by their zone-map sidecar
        # (host-side observability; exercised by tests)
        self.segments_skipped = 0
        # bit-rot accounting: sealed segments the scrubber
        # pulled from service (.quarantine rename) and the spans that
        # went with them — searches skip them instead of failing
        self.segments_quarantined = 0
        self.spans_quarantined = 0
        # disk-exhaustion accounting: the archive is a
        # bounded lossy cache, so ENOSPC means drop-and-flag, not crash;
        # at_risk clears on the next successful append (space freed)
        self.enospc_count = 0
        self.spans_dropped_enospc = 0
        self.at_risk = False
        self._recover()

    # -- write side ------------------------------------------------------

    def append_batch(
        self,
        payload: bytes,
        span_off: np.ndarray,
        span_len: np.ndarray,
        tl0: np.ndarray,
        tl1: np.ndarray,
        th0: np.ndarray,
        th1: np.ndarray,
        svc: np.ndarray,
        rsvc: np.ndarray,
        name: np.ndarray,
        key: np.ndarray,
        ts_min: np.ndarray,
        dur: np.ndarray,
        err: np.ndarray,
    ) -> None:
        """Append one parsed batch: the raw payload plus per-span index
        columns. All arrays length n; offsets index into ``payload``."""
        n = int(span_off.shape[0])
        if n == 0:
            return
        rows = np.empty((n, COLS), np.uint32)
        rows[:, 0] = tl0
        rows[:, 1] = tl1
        rows[:, 2] = th0
        rows[:, 3] = th1
        rows[:, 4] = span_off
        rows[:, 5] = span_len
        rows[:, 6] = (svc.astype(np.uint32) << np.uint32(16)) | (
            rsvc.astype(np.uint32) & np.uint32(0xFFFF)
        )
        rows[:, 7] = name.astype(np.uint32)
        rows[:, 8] = key.astype(np.uint32)
        rows[:, 9] = ts_min.astype(np.uint32)
        rows[:, 10] = (
            np.minimum(dur.astype(np.uint64), (1 << 31) - 1).astype(np.uint32)
            << np.uint32(1)
        ) | err.astype(np.uint32)
        frame = _FRAME.pack(_MAGIC, n, len(payload), zlib.crc32(payload))
        with self._lock:
            if self._closed:
                raise RuntimeError("archive is closed")
            try:
                faults.resource_point("archive")
                fh = self._live_file()
                base = self._live_bytes + _FRAME.size + rows.nbytes
                # offsets become absolute within the segment's data file
                rows[:, 4] += np.uint32(base)
                fh.write(frame)
                fh.write(rows.tobytes())
                if faults.is_armed("archive.mid_segment"):
                    fh.flush()  # kernel-visible partial frame for the
                    # in-process crash action (matches post-flush SIGKILL)
                faults.crashpoint("archive.mid_segment")
                fh.write(payload)
                fh.flush()
            except OSError as e:
                if e.errno != errno.ENOSPC:
                    raise
                self._note_enospc_locked(n)
                return
            self.at_risk = False
            # bit-rot injection site: the frame's payload is
            # durable — damage it at rest (scrub/recovery must catch it)
            faults.corrupt_point(
                "archive.frame", self._live_path, base, len(payload)
            )
            self._live_bytes = base + len(payload)
            self._live_rows.append(rows)
            self.spans_written += n
            if self._live_bytes >= self.segment_bytes:
                self._seal_live()
                self._enforce_retention()

    # called only from append_batch's critical section: self._lock is held
    def _note_enospc_locked(self, n: int) -> None:
        """Disk full mid-frame: drop the batch and ABANDON the live
        segment — its file may carry a torn frame tail whose bytes the
        row index never saw, and the seal sidecars need disk we don't
        have. Already-indexed live rows go down with it (counted); boot
        recovery truncates the orphan's torn tail if it survives."""
        self.enospc_count += 1
        self.spans_dropped_enospc += n + sum(
            int(r.shape[0]) for r in self._live_rows
        )
        if not self.at_risk:
            logger.error(
                "archive append hit ENOSPC: raw-span archive degraded "
                "(batches dropped until disk frees)"
            )
        self.at_risk = True
        if self._live_fh is not None:
            try:
                self._live_fh.close()
            except OSError:
                pass
            self._live_fh = None
        self._live_path = None
        self._live_bytes = 0
        self._live_rows = []

    # called only from append_batch's critical section: self._lock is held
    def _live_file(self):
        if self._live_fh is None:
            self._live_path = os.path.join(
                self.directory, f"arc-{self._seg_idx:08d}.dat"
            )
            self._seg_idx += 1
            self._live_fh = open(self._live_path, "ab")
            self._live_bytes = os.path.getsize(self._live_path)
        return self._live_fh

    # every caller (append_batch, flush, close) holds self._lock
    def _seal_live(self) -> None:
        """Sort the live rows by low-64 trace id and write the sidecars;
        reopen the segment read-only as mmap."""
        if self._live_fh is None:
            return
        self._live_fh.close()
        self._live_fh = None
        rows = (
            np.concatenate(self._live_rows)
            if self._live_rows
            else np.empty((0, COLS), np.uint32)
        )
        self._live_rows = []
        ids = _id64(rows[:, 0], rows[:, 1])
        order = np.argsort(ids, kind="stable")
        np.save(self._live_path + ".ids.npy", ids[order])
        np.save(self._live_path + ".cols.npy", rows[order])
        with open(self._live_path + ".meta.npz", "wb") as f:
            # compressed: the presence bitmaps are mostly zeros, so the
            # sidecar stays ~KB instead of 25KB (it counts against the
            # retention byte budget like every other sidecar)
            np.savez_compressed(f, **build_segment_meta(rows))
        seg = _Segment(self._live_path)
        self._sealed.append(seg)
        self._path_to_seg[self._live_path] = seg
        self._live_path = None
        self._live_bytes = 0

    def _enforce_retention(self) -> None:
        total = sum(s.bytes_used() for s in self._sealed) + self._live_bytes
        while len(self._sealed) > 1 and total > self.max_bytes:
            old = self._sealed.pop(0)
            total -= old.bytes_used()
            self.spans_dropped_retention += old.n
            # do NOT close: a query holding a views() snapshot may still
            # read through the segment's mmaps/fd — POSIX keeps unlinked
            # files readable until the last reference drops (GC closes)
            for suffix in ("", ".ids.npy", ".cols.npy", ".meta.npz"):
                try:
                    os.remove(old.path + suffix)
                except OSError:
                    pass
            # keep the path resolvable (retained fd) for a bounded churn
            # window; past the cap the oldest retired entry only DROPS
            # its map reference — a views() snapshot taken before the
            # drop may still hold the segment object, so the fd must
            # close by GC when the LAST reference dies, never eagerly
            # (closing here would EBADF a long query mid-read). The cap
            # bounds the map-pinned overhang to ~2 unlinked segments;
            # snapshot-pinned segments free when their query ends.
            self._retired.append(old.path)
            while len(self._retired) > 2:
                self._path_to_seg.pop(self._retired.pop(0), None)

    def flush(self) -> None:
        """Seal the live segment so its spans are index-served (tests,
        shutdown). Cheap no-op when nothing is live."""
        with self._lock:
            if self._live_rows or self._live_fh is not None:
                self._seal_live()
                self._enforce_retention()

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            if self._live_rows or self._live_fh is not None:
                self._seal_live()
            self._closed = True
            for s in self._sealed:
                s.close()
            # retired segments hold unlinked fds/mmaps past retention —
            # drop the map so GC releases any not pinned by a live query
            self._path_to_seg.clear()
            self._retired.clear()

    # -- recovery --------------------------------------------------------

    # constructor-time scan: no other thread holds the archive yet
    # zt-lint: disable=ZT04 — constructor-time scan; no other thread can
    # hold a reference to the archive yet
    def _recover(self) -> None:
        names = sorted(
            f for f in os.listdir(self.directory)
            if f.startswith("arc-") and f.endswith(".dat")
        )
        for f in names:
            path = os.path.join(self.directory, f)
            self._seg_idx = max(
                self._seg_idx, int(f[len("arc-"):-len(".dat")]) + 1
            )
            if os.path.exists(path + ".ids.npy"):
                try:
                    seg = _Segment(path)
                    self._sealed.append(seg)
                    self._path_to_seg[path] = seg
                    continue
                except Exception:
                    logger.warning("archive: bad sidecars for %s", path)
            # unsealed tail: rebuild rows by scanning frames; truncate a
            # torn final frame (the WAL's torn-tail rule)
            rows, good = self._scan_frames(path)
            if rows:
                self._live_path = path
                self._live_fh = open(path, "ab")
                if good < os.path.getsize(path):
                    self._live_fh.truncate(good)
                    # the cut stays cut across a crash before the next seal
                    os.fsync(self._live_fh.fileno())
                self._live_bytes = good
                self._live_rows = rows
                self.spans_written += int(sum(r.shape[0] for r in rows))
            else:
                try:
                    os.remove(path)
                except OSError:
                    pass

    def _scan_frames(self, path: str) -> Tuple[List[np.ndarray], int]:
        rows: List[np.ndarray] = []
        good = 0
        size = os.path.getsize(path)
        with open(path, "rb") as fh:
            while True:
                hdr = fh.read(_FRAME.size)
                if len(hdr) < _FRAME.size:
                    break
                magic, n, plen, crc = _FRAME.unpack(hdr)
                if magic != _MAGIC:
                    break
                need = n * COLS * 4 + plen
                body = fh.read(need)
                if len(body) < need:
                    break
                if zlib.crc32(body[n * COLS * 4:]) != crc:
                    break
                rows.append(
                    np.frombuffer(
                        body, np.uint32, count=n * COLS
                    ).reshape(n, COLS).copy()
                )
                good += _FRAME.size + need
        if good < size:
            logger.warning(
                "archive: truncated torn tail of %s at %d (was %d)",
                path, good, size,
            )
        return rows, good

    # -- read side -------------------------------------------------------

    def views(self):
        """(ids, cols, data_path) per segment, NEWEST first, including a
        sorted view of the live segment. Query paths that touch several
        traces snapshot this ONCE — the live view sorts its rows on
        construction, so per-trace re-snapshots would re-sort per call
        (measured 1881 argsorts for one search before this was shared)."""
        with self._lock:
            out = []
            if self._live_rows and self._live_path:
                rows = np.concatenate(self._live_rows)
                ids = _id64(rows[:, 0], rows[:, 1])
                order = np.argsort(ids, kind="stable")
                out.append((ids[order], rows[order], self._live_path, None))
            for seg in reversed(self._sealed):
                # the SEGMENT object (not its path): its retained fd
                # keeps reads working after retention unlinks the file
                out.append((seg.ids, seg.cols, seg, seg.meta))
            return out

    def _read_spans(self, src, rows: np.ndarray) -> List[bytes]:
        """``src`` is a _Segment (sealed: retained fd) or a path string
        (live segment: never deleted while live)."""
        if isinstance(src, _Segment):
            return [
                src.pread(int(off), int(ln)) for off, ln in rows[:, 4:6]
            ]
        # live-segment path string: the segment may have SEALED (and even
        # been retention-unlinked) since the snapshot was taken — resolve
        # through the sealed segment's retained fd when it has
        with self._lock:
            seg = self._path_to_seg.get(src)
        if seg is not None:
            return [
                seg.pread(int(off), int(ln)) for off, ln in rows[:, 4:6]
            ]
        out = []
        try:
            with open(src, "rb") as fh:
                for off, ln in rows[:, 4:6]:
                    fh.seek(int(off))
                    out.append(fh.read(int(ln)))
        except FileNotFoundError:  # pragma: no cover - bounded-churn miss
            return []
        return out

    def fetch_trace_raw(
        self, tl0: int, tl1: int, th0: int, th1: int, strict: bool,
        views=None,
    ) -> List[bytes]:
        """Raw JSON slices of every archived span whose trace id matches
        (exact low-64; high-64 also compared when ``strict``)."""
        want = np.uint64((tl1 << 32) | tl0)
        slices: List[bytes] = []
        for ids, cols, path, _meta in (
            views if views is not None else self.views()
        ):
            lo = int(np.searchsorted(ids, want, side="left"))
            hi = int(np.searchsorted(ids, want, side="right"))
            if hi <= lo:
                continue
            rows = np.asarray(cols[lo:hi])
            if strict:
                rows = rows[(rows[:, 2] == th0) & (rows[:, 3] == th1)]
            if rows.shape[0]:
                slices.extend(self._read_spans(path, rows))
        return slices

    def candidate_trace_ids(
        self,
        *,
        ts_lo_min: int,
        ts_hi_min: int,
        svc_id: Optional[int] = None,
        rsvc_id: Optional[int] = None,
        name_id: Optional[int] = None,
        min_dur: Optional[int] = None,
        max_dur: Optional[int] = None,
        limit: int = 1000,
        views=None,
    ) -> List[Tuple[int, int]]:
        """Distinct (id64_low, ts) candidates matching the INDEXED
        predicates, newest-first, scanning newest segments first and
        stopping once ``limit`` distinct traces matched (so a narrow
        recent query never reads cold segments). Non-indexed clauses
        (annotationQuery) are the caller's exact post-filter."""
        seen: Dict[int, int] = {}
        for ids, cols, _, meta in (
            views if views is not None else self.views()
        ):
            if _meta_can_skip(
                meta, ts_lo_min=ts_lo_min, ts_hi_min=ts_hi_min,
                svc_id=svc_id, rsvc_id=rsvc_id, name_id=name_id,
                min_dur=min_dur, max_dur=max_dur,
            ):
                # zone map proves no row can match: the segment's cols
                # pages are never touched (ES daily-index pruning analog)
                self.segments_skipped += 1
                continue
            cols = np.asarray(cols)
            mask = (cols[:, 9] >= ts_lo_min) & (cols[:, 9] <= ts_hi_min)
            if svc_id is not None:
                mask &= (cols[:, 6] >> 16) == svc_id
            if rsvc_id is not None:
                mask &= (cols[:, 6] & 0xFFFF) == rsvc_id
            if name_id is not None:
                mask &= cols[:, 7] == name_id
            dur = cols[:, 10] >> 1
            clamp = (1 << 31) - 1  # stored durations clamp here
            if min_dur is not None:
                mask &= dur >= max(min(min_dur, clamp), 1)  # dur 0 = absent
            if max_dur is not None:
                mask &= (dur <= min(max_dur, clamp)) & (dur > 0)
            hit = np.nonzero(mask)[0]
            if hit.size == 0:
                continue
            hit_ids = _id64(cols[hit, 0], cols[hit, 1])
            hit_ts = cols[hit, 9]
            for i64, ts in zip(hit_ids.tolist(), hit_ts.tolist()):
                prev = seen.get(i64)
                if prev is None or ts > prev:
                    seen[i64] = ts
            if len(seen) >= limit:
                break
        # newest first, TRUNCATED to the limit: a single big segment can
        # contribute far more matches than the cap before the loop
        # breaks, and callers pay a trace fetch per returned candidate
        return sorted(seen.items(), key=lambda kv: -kv[1])[:limit]

    def sealed_segment_paths(self) -> List[str]:
        """Data-file paths of every sealed segment — the scrub set (the
        live segment is re-verified by boot recovery, not at rest)."""
        with self._lock:
            return [seg.path for seg in self._sealed]

    def quarantine_segment(self, path: str) -> int:
        """Pull one sealed segment from service: rename its data file +
        sidecars aside (``.quarantine`` — never unlink, it is postmortem
        evidence) and drop it from the read set, so searches SKIP the
        bad frames with accounting instead of failing the query. Returns
        the span count removed. In-flight queries holding a views()
        snapshot keep reading through the segment's retained fd — a
        corrupt payload decodes to a skipped span, never an error."""
        with self._lock:
            for i, seg in enumerate(self._sealed):
                if seg.path == path:
                    self._sealed.pop(i)
                    break
            else:
                return 0
            self._path_to_seg.pop(path, None)
            n = seg.n
            self.segments_quarantined += 1
            self.spans_quarantined += n
            for suffix in ("", ".ids.npy", ".cols.npy", ".meta.npz"):
                try:
                    # no fsync: the bytes moved aside are already corrupt, and a
                    # rename lost to a crash just quarantines again next boot
                    # zt-lint: disable=ZT12 — quarantine moves already-corrupt bytes ASIDE; the poison file's durability is not a recovery invariant (a lost rename just re-quarantines next boot)
                    os.replace(
                        seg.path + suffix, seg.path + suffix + ".quarantine"
                    )
                except OSError:
                    pass
        logger.warning(
            "archive segment %s quarantined (%d spans out of service)",
            path, n,
        )
        return n

    def counters(self) -> dict:
        with self._lock:
            return {
                "archiveSpansWritten": self.spans_written,
                "archiveSpansDroppedRetention": self.spans_dropped_retention,
                "archiveSearchSegmentsSkipped": self.segments_skipped,
                "archiveSegmentsQuarantined": self.segments_quarantined,
                "archiveSpansQuarantined": self.spans_quarantined,
                "archiveEnospc": self.enospc_count,
                "archiveSpansDroppedEnospc": self.spans_dropped_enospc,
                "archiveAtRisk": int(self.at_risk),
                "archiveSegments": len(self._sealed)
                + (1 if self._live_rows else 0),
                "archiveBytes": sum(s.bytes_used() for s in self._sealed)
                + self._live_bytes,
            }

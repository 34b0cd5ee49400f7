"""Host write-ahead log of packed wire batches (port of
``zipkin_tpu/tpu/wal.py:49-579``).

The device aggregates live in volatile memory on the card; a snapshot
(:mod:`zipkin_tpu_torch.tpu.snapshot`) captures them now and then, and this
log holds every batch in between:

- every batch that reaches ``TorchAggregator.ingest_fused`` is appended as
  one record: the packed ``[1, 11, per]`` u32 wire image (already
  contiguous, written as it is) plus the vocab entries interned since the
  previous record, so replay rebuilds the same id space;
- records carry a monotone sequence number; a snapshot stores the last
  sequence folded into its state, and restore replays only the records
  past it;
- a crc32 over the payload finds the torn tail record of a crash mid-write:
  replay stops at the last complete record of that segment;
- segments rotate by size and are deleted once a retained snapshot covers
  them.

The on-disk format is the reference's (the same magic, ``<IQII I`` header,
meta keys and payload), so a log written by either package replays in the
other. The archive sample is not logged: it is a bounded, lossy cache by
design. Each append is the flight recorder's ``wal_append`` stage (the
fsync included) and each fsync its ``wal_fsync``; the reference's
critical-path segments of an append come with the critical-path tracer.
"""

from __future__ import annotations

import contextlib
import errno
import json
import logging
import os
import struct
import time
import zlib
from typing import Iterator, Optional, Tuple

import numpy as np

from zipkin_tpu_torch import faults, obs

logger = logging.getLogger(__name__)

_MAGIC = 0x5A57414C  # "ZWAL"
_HEADER = struct.Struct("<IQII I")  # magic, seq, meta_len, payload_len, crc


def _walk_headers(path: str) -> Iterator[int]:
    """The seq of every structurally valid record header of one segment, in
    order, up to the first bad magic or short header (payloads unread)."""
    with open(path, "rb") as fh:
        while True:
            head = fh.read(_HEADER.size)
            if len(head) < _HEADER.size:
                return
            magic, seq, meta_len, payload_len, _ = _HEADER.unpack(head)
            if magic != _MAGIC:
                return
            yield seq
            fh.seek(meta_len + payload_len, os.SEEK_CUR)


class WriteAheadLog:
    def __init__(self, directory: str, max_segment_bytes: int = 256 * 1024 * 1024,
                 fsync: bool = False) -> None:
        self.directory = directory
        self.max_segment_bytes = max_segment_bytes
        self.fsync = fsync
        os.makedirs(directory, exist_ok=True)
        self._fh = None
        self._path: Optional[str] = None
        self._fh_bytes = 0
        self._seg_idx = 0
        self._closed = False
        self._batch_depth = 0  # > 0 inside batched(): flush and fsync wait
        # disk-full degraded mode: an ENOSPC append does not fail the
        # ingest; the record is missed and the log stays at risk (acked
        # spans since would not survive a crash) until a snapshot covers
        # the whole state again (clear_at_risk)
        self.at_risk = False
        self.enospc_count = 0
        self.missed_records = 0
        # numbering resumes after the existing records, found by a walk of
        # the headers: a payload that rotted must not hide the high-water
        # mark, or a new writer would reuse seqs a snapshot already covers
        self._seq = self._scan_high_seq()
        segs = self._segments()
        if segs:
            self._seg_idx = segs[-1][0] + 1

    # -- write side ------------------------------------------------------

    def append(self, fused: np.ndarray, meta: dict) -> int:
        """Append one batch; returns its sequence number. ``meta`` must be
        JSON-serializable; the image's shape is recorded with it."""
        if self._closed:
            # a hook a racing ingest thread took before close() detached it
            # must not reopen a segment after the final snapshot
            raise RuntimeError("WAL is closed")
        self._seq += 1
        # the image is written through the buffer protocol, no copy (cast()
        # refuses a zero in the shape, so empty marker images take b"")
        arr = np.ascontiguousarray(fused, np.uint32)
        payload = arr.data.cast("B") if arr.size else memoryview(b"")
        meta = dict(meta, shape=list(fused.shape))
        meta_b = json.dumps(meta, separators=(",", ":")).encode()
        head = _HEADER.pack(_MAGIC, self._seq, len(meta_b), len(payload), zlib.crc32(payload))
        rec_len = len(head) + len(meta_b) + len(payload)
        deferred = self._batch_depth > 0
        t0 = time.perf_counter()
        try:
            faults.resource_point("wal.append")
            fh = self._file_for(rec_len)
            # two writes, so the mid-append crashpoint sits at the worst
            # tear: header and meta on disk, payload missing
            fh.write(head + meta_b)
            if faults.is_armed("wal.append.mid"):
                fh.flush()  # the torn record must reach the kernel, as after a SIGKILL
            faults.crashpoint("wal.append.mid")
            fh.write(payload)
            if not deferred:
                fh.flush()
            faults.crashpoint("wal.append.pre_fsync")
            if self.fsync and not deferred:
                t1 = time.perf_counter()
                os.fsync(fh.fileno())
                obs.record("wal_fsync", time.perf_counter() - t1)
        except OSError as e:
            if e.errno != errno.ENOSPC:
                raise
            self._note_enospc()
            return self._seq
        # bit-rot site: damage the durable payload at rest
        if deferred and faults.is_corrupt_armed("wal.record"):
            fh.flush()
        faults.corrupt_point("wal.record", self._path,
                             self._fh_bytes + _HEADER.size + len(meta_b), len(payload))
        self._fh_bytes += rec_len
        obs.record("wal_append", time.perf_counter() - t0)
        return self._seq

    @contextlib.contextmanager
    def batched(self):
        """Appends inside this context defer their flush and fsync; leaving
        it commits the run with one flush (and one fsync when enabled). The
        records are the same as serial appends."""
        if self._closed:
            raise RuntimeError("WAL is closed")
        self._batch_depth += 1
        try:
            yield self
        finally:
            self._batch_depth -= 1
            if self._batch_depth == 0:
                self._commit_batch()

    def _commit_batch(self) -> None:
        fh = self._fh
        if fh is None:
            return
        try:
            fh.flush()
            if self.fsync:
                t1 = time.perf_counter()
                os.fsync(fh.fileno())
                obs.record("wal_fsync", time.perf_counter() - t1)
        except OSError as e:
            if e.errno != errno.ENOSPC:
                raise
            self._note_enospc()

    def _note_enospc(self) -> None:
        """Disk full mid-append: the record is lost (it has a seq but no
        durable bytes) and the segment may end torn. Later appends go to a
        fresh segment, because replay skips a torn segment's tail. The log
        keeps accepting appends and stays at risk until a snapshot."""
        self.enospc_count += 1
        self.missed_records += 1
        if not self.at_risk:
            logger.error("WAL append hit ENOSPC at seq %d: durability AT RISK (acked spans "
                         "not crash-safe until the next snapshot commit)", self._seq)
        self.at_risk = True
        if self._fh is not None:
            try:
                self._fh.close()
            except OSError:
                pass
            self._fh = None

    def clear_at_risk(self) -> None:
        """After a committed snapshot: the whole state is durable again."""
        if self.at_risk:
            logger.info("WAL at-risk cleared: a snapshot covers the missed window "
                        "(%d records lost to ENOSPC)", self.missed_records)
        self.at_risk = False

    def _file_for(self, rec_len: int):
        if self._fh is not None and self._fh_bytes + rec_len > self.max_segment_bytes:
            self._fh.close()
            self._fh = None
        if self._fh is None:
            path = os.path.join(self.directory, f"wal-{self._seg_idx:08d}.log")
            self._seg_idx += 1
            self._fh = open(path, "ab")
            self._path = path
            self._fh_bytes = os.path.getsize(path)
        return self._fh

    def _scan_high_seq(self) -> int:
        """The highest seq over every valid record header of every segment.
        A rotted header still ends its segment's walk; attach() floors the
        counter at the snapshot's seq for that case."""
        top = 0
        for _, path in self._segments():
            try:
                top = max([top, *_walk_headers(path)])
            except OSError:
                continue
        return top

    # -- read side -------------------------------------------------------

    def _segments(self):
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("wal-") and name.endswith(".log"):
                try:
                    out.append((int(name[4:-4]), os.path.join(self.directory, name)))
                except ValueError:
                    continue
        out.sort()
        return out

    def records(self, from_seq: int = 0) -> Iterator[Tuple[int, dict, np.ndarray]]:
        """Yield (seq, meta, fused) for every complete record with ``seq >
        from_seq``. A torn or corrupt record skips the rest of its segment
        only: later segments, written after a crash, hold batches that were
        acked on top of the replay state at the tear."""
        for _, path in self._segments():
            with open(path, "rb") as fh:
                while True:
                    rec_off = fh.tell()
                    head = fh.read(_HEADER.size)
                    if not head:
                        break
                    if len(head) < _HEADER.size:
                        logger.warning("WAL %s: torn header at offset %d; skipping segment tail",
                                       path, rec_off)
                        break
                    magic, seq, meta_len, payload_len, crc = _HEADER.unpack(head)
                    if magic != _MAGIC:
                        logger.warning("WAL %s: bad magic at offset %d; skipping segment tail",
                                       path, rec_off)
                        break
                    if seq <= from_seq:
                        # covered by the snapshot: seek past the body (past
                        # EOF on a covered torn tail, and the next read ends)
                        fh.seek(meta_len + payload_len, os.SEEK_CUR)
                        continue
                    meta_b = fh.read(meta_len)
                    payload = fh.read(payload_len)
                    if len(meta_b) < meta_len or len(payload) < payload_len:
                        logger.warning("WAL %s: torn record seq %d at offset %d; skipping "
                                       "segment tail", path, seq, rec_off)
                        break
                    if zlib.crc32(payload) != crc:
                        logger.warning("WAL %s: bad crc on record seq %d at offset %d; "
                                       "skipping segment tail", path, seq, rec_off)
                        break
                    meta = json.loads(meta_b)
                    yield seq, meta, np.frombuffer(payload, np.uint32).reshape(meta["shape"])

    # -- maintenance -----------------------------------------------------

    def truncate_covered(self, covered_seq: int) -> None:
        """Delete segments whose every record is <= ``covered_seq``. The
        newest segment stays even when covered: it is the live segment, and
        after a reopen without writes the only carrier of the seq
        high-water mark."""
        segs = self._segments()
        for _, path in segs[:-1]:
            try:
                max_seq = max(_walk_headers(path), default=0)
            except OSError:
                continue
            if max_seq and max_seq <= covered_seq:
                os.unlink(path)
                logger.info("WAL segment %s truncated (<= %d)", path, covered_seq)

    def sealed_segment_paths(self):
        """Segment paths but the newest (the live writer's target)."""
        return [path for _, path in self._segments()[:-1]]

    def close(self) -> None:
        self._closed = True
        if self._fh is not None:
            self._fh.close()
            self._fh = None


def verify_segment(path: str) -> dict:
    """At-rest check of one segment: every record's structure, payload crc
    and meta JSON. Returns ``{"ok", "records", "max_seq", "bytes",
    "bad_seq", "bad_offset"}``; on damage ``bad_seq``/``bad_offset`` name
    the first bad record and ``max_seq`` covers the records before it."""
    out = dict(ok=True, records=0, max_seq=0, bytes=0, bad_seq=None, bad_offset=None)
    with open(path, "rb") as fh:
        while True:
            rec_off = fh.tell()
            head = fh.read(_HEADER.size)
            if not head:
                break
            bad = len(head) < _HEADER.size
            seq = None
            if not bad:
                magic, seq, meta_len, payload_len, crc = _HEADER.unpack(head)
                bad = magic != _MAGIC
            if not bad:
                meta_b = fh.read(meta_len)
                payload = fh.read(payload_len)
                bad = (len(meta_b) < meta_len or len(payload) < payload_len
                       or zlib.crc32(payload) != crc)
                if not bad:
                    try:
                        json.loads(meta_b)
                    except ValueError:
                        bad = True
            if bad:
                out.update(ok=False, bad_seq=seq, bad_offset=rec_off)
                break
            out["records"] += 1
            out["max_seq"] = max(out["max_seq"], seq)
            out["bytes"] = fh.tell()
    return out


def attach(store, wal: WriteAheadLog) -> WriteAheadLog:
    """Wire a WAL into a TorchStorage: every batch the aggregator folds is
    logged with the vocab delta since the previous record, and the
    aggregator records the applied sequence for snapshots. Call after any
    replay, so the delta cursors start at the current vocab.

    The hook has the aggregator's signature: ``hook(fused, n_spans, n_dur,
    n_err, ts_range, extra=None) -> seq``."""
    vocab = store.vocab
    # never hand a new append a seq the restored snapshot covers (a rotted
    # header can hide the true high-water mark from the boot scan)
    wal._seq = max(wal._seq, int(store.agg.wal_seq))
    # the delta cursors start past what the snapshot or replay holds
    sent = {"svc": len(vocab.services._names), "name": len(vocab.span_names._names),
            "pair": len(vocab._key_list)}

    def hook(fused, n_spans, n_dur, n_err, ts_range, extra=None) -> int:
        with store._intern_lock:
            svc_new = vocab.services._names[sent["svc"]:]
            name_new = vocab.span_names._names[sent["name"]:]
            pairs_new = vocab._key_list[sent["pair"]:]
            sent["svc"] += len(svc_new)
            sent["name"] += len(name_new)
            sent["pair"] += len(pairs_new)
        meta = dict(
            n_spans=n_spans, n_dur=n_dur, n_err=n_err,
            ts_range=list(ts_range) if ts_range else None,
            svc=svc_new, names=name_new, pairs=[list(p) for p in pairs_new],
        )
        if extra:
            # the sampling tier's seen/kept tallies of a compacted batch, an
            # "sctl" table delta, or a ttflush/ttroll marker
            meta.update(extra)
        return wal.append(fused, meta)

    store.agg.wal_hook = hook
    store.wal = wal
    return wal


def replay(store, wal: WriteAheadLog, from_seq: int = 0) -> int:
    """Re-apply every record past ``from_seq`` (the snapshot's cutoff) to
    the store: the vocab delta first (the id space in its original intern
    order), then the record's controller publish or marker, then the batch.
    The hook is suspended meanwhile. Returns the records applied."""
    agg = store.agg
    vocab = store.vocab
    hook, agg.wal_hook = agg.wal_hook, None
    applied = 0
    try:
        for seq, meta, fused in wal.records(from_seq):
            with store._intern_lock:
                for s in meta.get("svc", []):
                    vocab.services.intern(s)
                for s in meta.get("names", []):
                    vocab.span_names.intern(s)
                for a, b in meta.get("pairs", []):
                    # the recorded pair ids as they were, catch-alls included
                    vocab.append_pair(a, b)
            sctl = meta.get("sctl")
            if sctl:
                # a controller publish, between the same two batches as live
                store.apply_sctl(sctl)
            if meta.get("ttflush"):
                # digest folding depends on where flushes fall: replay the
                # explicit flush at its stream position (the hook is None,
                # so it logs no marker of its own)
                agg.flush_now()
            if meta.get("ttroll"):
                agg.rollup_now()  # the sealer's pre-seal rollup, likewise
            if fused.shape[-1]:
                agg.ingest_fused(
                    np.array(fused),  # the frombuffer view is read-only
                    n_spans=meta["n_spans"], n_dur=meta["n_dur"], n_err=meta["n_err"],
                    ts_range=tuple(ts) if (ts := meta.get("ts_range")) else None,
                )
            if "seen" in meta:
                # a sampled batch's record holds its kept lanes: restore the
                # host counters from the pre-compaction tallies
                hc = agg.host_counters
                hc["sampledKept"] += meta.get("kept", 0)
                hc["sampledDropped"] += meta["seen"] - meta.get("kept", 0)
                hc["spans"] += meta["seen"] - meta["n_spans"]
                hc["spansWithDuration"] += meta.get("seen_dur", meta["n_dur"]) - meta["n_dur"]
                hc["spansWithError"] += meta.get("seen_err", meta["n_err"]) - meta["n_err"]
            agg.wal_seq = seq
            applied += 1
    finally:
        agg.wal_hook = hook
    if applied:
        logger.info("WAL: replayed %d records (> seq %d)", applied, from_seq)
    return applied

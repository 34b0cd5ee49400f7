"""Time-disaggregated sketch tier: sealed time-bucket segments (port of
``zipkin_tpu/tpu/timetier.py``, numpy only; duck-typed on the
aggregator's ``tt_read`` / ``tt_max_epoch``).

The device keeps a FAT current-bucket update sketch (the tb_* AggState
leaves: per-key t-digest clusters, HLL registers, link-edge planes — an
epoch ring of ``time_buckets`` slots x ``time_bucket_minutes`` each,
updated at line rate by the ingest step). This module is the other half
of the SF-sketch two-stage split: a ticker-driven **bucket seal** reads
one finished bucket off the device (``TorchAggregator.tt_read`` with
lo==hi — one packed transfer) and freezes it into a compact, mergeable,
host-side **segment**. Windowed ``[lookback, endTs]`` queries then
select the covering run of segments and merge them in pure numpy
(ops/ttmerge.py) — digest recluster, HLL register-max, edge sums — with
at most ONE device pull for the unsealed current bucket.

Memory stays fixed the way obs/windows.py keeps its two tiers fixed:
a FINE ring of the most recent sealed buckets, coalescing into a COARSE
ring of pre-merged blocks of ``coarse_factor`` buckets each (a 24 h
lookback folds ~dozens of coarse blocks + a few fine edges, not
hundreds of fine buckets). Aged-out fine segments stay reachable on
disk.

Durability mirrors the snapshot protocol: a segment is one
``tt-<epoch>.npz`` (fsync + atomic rename) plus a crc32-per-array
manifest sidecar committed after it; restore verifies the manifest and
QUARANTINES (renames aside, never unlinks) a rotted segment, serving
the window with a coverage gap instead of garbage. The seal path
carries the ``timetier.seal.pre_commit`` / ``post_commit`` crashpoints
and the ``timetier.segment`` corrupt site (zipkin_tpu_torch.faults); the
device current-bucket leaves ride snapshot/WAL like every other leaf,
so a crash-resume reseals pending buckets from bit-identical state.

Staleness contract: bucket epoch ``e`` is sealable once ingest has
seen epoch ``e+1`` (``tt_max_epoch``); the newest epoch is always the
UNSEALED current bucket and is served straight off the device. A
window's sealed prefix never changes after seal — which is what makes
the demand-registered mirror keys (store.py ``ttq:`` keys) cacheable.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import tempfile
import threading
import time
import zlib
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Tuple

import numpy as np

from zipkin_tpu_torch import faults
from zipkin_tpu_torch.ops import ttmerge

logger = logging.getLogger(__name__)

SEGMENT_VERSION = 1
_SEG_PREFIX = "tt-"
QUARANTINE_SUFFIX = ".quarantine"
# segment npz member order — the manifest records one crc per member
_MEMBERS = ("digest", "hll", "calls", "errs")


@dataclasses.dataclass(frozen=True)
class Segment:
    """One sealed bucket (``lo_ep == hi_ep``) or a coalesced coarse
    block (``[lo_ep, hi_ep]`` inclusive). Arrays are the mergeable
    compact forms the device read produced: digest [K, Cw, 2] f32,
    hll [S+1, m] u8, calls/errs [S, S] u32."""

    lo_ep: int
    hi_ep: int
    digest: np.ndarray
    hll: np.ndarray
    calls: np.ndarray
    errs: np.ndarray


@dataclasses.dataclass
class WindowAnswer:
    """One merged windowed read: the requested epoch range, the epochs
    actually covered (sealed segments + unsealed device read), and the
    merged sketches. ``missing`` counts requested epochs with no data
    (older than tier retention, or quarantined)."""

    lo_ep: int
    hi_ep: int
    covered: int
    missing: int
    unsealed: bool
    digest: np.ndarray
    hll: np.ndarray
    calls: np.ndarray
    errs: np.ndarray


def _fsync_dir(directory: str) -> None:
    dfd = os.open(directory, os.O_RDONLY)
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)


class TimeTier:
    """Host ring of sealed time-bucket segments + the seal protocol.

    Thread model: the sealer runs on the obs ticker thread; windowed
    reads run on server threads and at mirror-publish time. One plain
    RLock guards the rings and counters — hold times are small host
    folds (the aggregator lock is NOT taken under it; ``window`` takes
    the agg lock only through ``agg.tt_read`` for the unsealed tail)."""

    def __init__(
        self,
        config,
        directory: Optional[str] = None,
        fine_slots: int = 64,
        coarse_factor: int = 12,
        coarse_slots: int = 64,
        disk_cache_slots: int = 32,
    ) -> None:
        self.config = config
        self.granularity = int(config.time_bucket_minutes)
        self.directory = directory
        self.fine_slots = int(fine_slots)
        self.coarse_factor = int(coarse_factor)
        self.coarse_slots = int(coarse_slots)
        self._lock = threading.RLock()
        # fine ring: most recent sealed buckets, epoch-keyed
        self._fine: "OrderedDict[int, Segment]" = OrderedDict()
        # buckets evicted from fine, waiting to coalesce into one block
        self._pending_coarse: List[Segment] = []
        # coarse ring: pre-merged blocks, oldest first
        self._coarse: "deque[Segment]" = deque(maxlen=self.coarse_slots)
        # LRU of segments re-loaded from disk for old windows
        self._disk_cache: "OrderedDict[int, Segment]" = OrderedDict()
        self._disk_cache_slots = int(disk_cache_slots)
        self._disk_epochs: set = set()
        self.sealed_through = -1
        self.counters: Dict[str, float] = {
            "ttSeals": 0,
            "ttSealWallMsLast": 0.0,
            "ttSegmentsFine": 0,
            "ttSegmentsCoarse": 0,
            "ttSegmentsDisk": 0,
            "ttSegmentsQuarantined": 0,
            "ttDiskLoads": 0,
            "ttWindowReads": 0,
            "ttWindowMergeMsLast": 0.0,
            "ttMissingEpochs": 0,
        }
        if directory:
            os.makedirs(directory, exist_ok=True)
            self._boot_scan()

    # -- boot ------------------------------------------------------------

    def _boot_scan(self) -> None:
        """Adopt committed segments from a previous run: the on-disk
        epoch set is the restore source of truth (a post_commit crash
        left the segment durable before sealed_through advanced — it
        must be adopted, not resealed). Stray tmp files from a
        pre_commit crash are dead weight."""
        with self._lock:
            self._boot_scan_locked()

    def _boot_scan_locked(self) -> None:
        for name in os.listdir(self.directory):
            path = os.path.join(self.directory, name)
            if name.endswith(".tmp"):
                try:
                    os.unlink(path)
                except OSError:
                    pass
                continue
            if not (name.startswith(_SEG_PREFIX) and name.endswith(".npz")):
                continue
            try:
                epoch = int(name[len(_SEG_PREFIX):-4])
            except ValueError:
                continue
            self._disk_epochs.add(epoch)
        if self._disk_epochs:
            self.sealed_through = max(self._disk_epochs)
        self.counters["ttSegmentsDisk"] = len(self._disk_epochs)

    # -- seal protocol ---------------------------------------------------

    def seal_due(self, agg) -> int:
        """Epochs ready to seal: everything strictly below the newest
        epoch ingest has touched (the unsealed current bucket), clamped
        to device-ring residency exactly like ``seal_up_to`` — epochs
        the W-slot ring has recycled are gaps, not due work."""
        top = agg.tt_max_epoch
        if top < 0:
            return 0
        lo = max(
            self.sealed_through + 1,
            top - (int(self.config.time_buckets) - 1),
        )
        return max(0, top - lo)

    def seal_up_to(self, agg, limit: Optional[int] = None) -> int:
        """Seal every due epoch (oldest first). Epochs the device ring
        has already recycled past seal as EMPTY segments — retention
        ran out before the sealer caught up; the gap is recorded, not
        invented. Returns segments sealed."""
        top = agg.tt_max_epoch
        if top < 0:
            return 0
        lo = self.sealed_through + 1
        # never backfill past device residency: an epoch the W-slot ring
        # has recycled would seal as an EMPTY segment — skip it instead
        # (cover() reports the gap as missing), which also bounds a
        # post-downtime catch-up to at most W-1 seals
        lo = max(lo, top - (int(self.config.time_buckets) - 1))
        sealed = 0
        for epoch in range(lo, top):
            self._seal_one(agg, epoch)
            sealed += 1
            if limit is not None and sealed >= limit:
                break
        return sealed

    def _seal_one(self, agg, epoch: int) -> None:
        """Freeze bucket ``epoch`` into a segment: one device read
        (tt_read flushes pending digest points first — the ttflush WAL
        marker keeps that replay-exact), atomic persist, then admit to
        the fine ring. Idempotent by epoch-named file: resealing after
        a post_commit crash adopts the committed file."""
        t0 = time.perf_counter()
        ep, regs, digest, calls, errs = agg.tt_read(epoch, epoch)
        seg = Segment(
            lo_ep=epoch, hi_ep=epoch,
            digest=np.asarray(digest, np.float32),
            hll=np.asarray(regs, np.uint8),
            calls=np.asarray(calls, np.uint32),
            errs=np.asarray(errs, np.uint32),
        )
        with self._lock:
            if self.directory:
                self._persist(seg)
            faults.crashpoint("timetier.seal.post_commit")
            self._admit(seg)
            self.sealed_through = max(self.sealed_through, epoch)
            self.counters["ttSeals"] += 1
            self.counters["ttSealWallMsLast"] = (
                time.perf_counter() - t0
            ) * 1000.0

    def _seg_name(self, epoch: int) -> str:
        return f"{_SEG_PREFIX}{epoch:012d}.npz"

    def _persist(self, seg: Segment) -> None:
        """Commit one segment: npz tmp + fsync, crashpoint, atomic
        rename, dir fsync, then the crc manifest sidecar (same commit
        shape as snapshot generations — the sidecar is the integrity
        record, the npz rename is the existence commit)."""
        arrays = {
            "digest": seg.digest, "hll": seg.hll,
            "calls": seg.calls, "errs": seg.errs,
        }
        name = self._seg_name(seg.lo_ep)
        fd, tmp = tempfile.mkstemp(dir=self.directory, suffix=".npz.tmp")
        with os.fdopen(fd, "wb") as f:
            np.savez_compressed(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        faults.crashpoint("timetier.seal.pre_commit")
        path = os.path.join(self.directory, name)
        os.replace(tmp, path)
        _fsync_dir(self.directory)
        meta = {
            "version": SEGMENT_VERSION,
            "epoch": seg.lo_ep,
            "granularity_minutes": self.granularity,
            "digest": "crc32",
            "member_crcs": {
                m: zlib.crc32(np.ascontiguousarray(arrays[m]).tobytes())
                for m in _MEMBERS
            },
        }
        mfd, mtmp = tempfile.mkstemp(dir=self.directory, suffix=".json.tmp")
        with os.fdopen(mfd, "w") as f:
            f.write(json.dumps(meta))
            f.flush()
            os.fsync(f.fileno())
        os.replace(mtmp, path[:-4] + ".meta.json")
        _fsync_dir(self.directory)
        # bit-rot injection: damage the just-committed segment at rest
        # so the load-time manifest check + quarantine path is soak-
        # tested (the ZT_CORRUPT family)
        faults.corrupt_point(
            "timetier.segment", path, 0, os.path.getsize(path)
        )
        self._disk_epochs.add(seg.lo_ep)
        self.counters["ttSegmentsDisk"] = len(self._disk_epochs)

    def _admit(self, seg: Segment) -> None:
        """Fine ring admit + fixed-memory coalesce (callers hold lock)."""
        self._fine[seg.lo_ep] = seg
        self._fine.move_to_end(seg.lo_ep)
        while len(self._fine) > self.fine_slots:
            _, old = self._fine.popitem(last=False)
            self._pending_coarse.append(old)
            if len(self._pending_coarse) >= self.coarse_factor:
                self._coarse.append(self._coalesce(self._pending_coarse))
                self._pending_coarse = []
        self.counters["ttSegmentsFine"] = len(self._fine)
        self.counters["ttSegmentsCoarse"] = len(self._coarse)

    def _coalesce(self, segs: List[Segment]) -> Segment:
        """Pre-merge a run of fine segments into one coarse block —
        the fold a 24 h window would otherwise redo per query."""
        segs = sorted(segs, key=lambda s: s.lo_ep)
        return Segment(
            lo_ep=segs[0].lo_ep, hi_ep=segs[-1].hi_ep,
            digest=ttmerge.merge_digests([s.digest for s in segs]),
            hll=ttmerge.merge_hll([s.hll for s in segs]),
            calls=ttmerge.merge_edges(
                [s.calls for s in segs]
            ).astype(np.uint32),
            errs=ttmerge.merge_edges(
                [s.errs for s in segs]
            ).astype(np.uint32),
        )

    # -- disk load -------------------------------------------------------

    def _load_disk(self, epoch: int) -> Optional[Segment]:
        """Load + verify one on-disk segment (callers hold lock). A
        manifest mismatch or unreadable npz quarantines the pair and
        reports the epoch missing — a flipped bit must cost coverage,
        never a silently-wrong percentile."""
        if epoch in self._disk_cache:
            self._disk_cache.move_to_end(epoch)
            return self._disk_cache[epoch]
        if epoch not in self._disk_epochs:
            return None
        path = os.path.join(self.directory, self._seg_name(epoch))
        meta_path = path[:-4] + ".meta.json"
        try:
            with open(meta_path) as f:
                meta = json.load(f)
            loaded = np.load(path)
            arrays = {m: loaded[m] for m in _MEMBERS}
        except Exception as e:
            logger.warning(
                "time-tier segment %s unreadable (%s); quarantining",
                path, e,
            )
            self._quarantine(epoch)
            return None
        crcs = meta.get("member_crcs", {})
        for m in _MEMBERS:
            got = zlib.crc32(np.ascontiguousarray(arrays[m]).tobytes())
            if int(crcs.get(m, -1)) != got:
                logger.warning(
                    "time-tier segment %s: member %s crc mismatch "
                    "(%08x != manifest %s) — bit rot; quarantining",
                    path, m, got, crcs.get(m),
                )
                self._quarantine(epoch)
                return None
        seg = Segment(
            lo_ep=epoch, hi_ep=epoch,
            digest=arrays["digest"], hll=arrays["hll"],
            calls=arrays["calls"], errs=arrays["errs"],
        )
        self._disk_cache[epoch] = seg
        self._disk_cache.move_to_end(epoch)
        while len(self._disk_cache) > self._disk_cache_slots:
            self._disk_cache.popitem(last=False)
        self.counters["ttDiskLoads"] += 1
        return seg

    def _quarantine(self, epoch: int) -> None:  # zt-lint: disable=ZT04 — caller holds self._lock
        path = os.path.join(self.directory, self._seg_name(epoch))
        for victim in (path, path[:-4] + ".meta.json"):
            try:
                # zt-lint: disable=ZT12 — quarantine moves already-corrupt bytes ASIDE; the poison file's durability is not a recovery invariant (a lost rename just re-quarantines next boot)
                os.replace(victim, victim + QUARANTINE_SUFFIX)
            except OSError:
                pass
        self._disk_epochs.discard(epoch)
        self._disk_cache.pop(epoch, None)
        self.counters["ttSegmentsQuarantined"] += 1
        self.counters["ttSegmentsDisk"] = len(self._disk_epochs)

    # -- query side ------------------------------------------------------

    def cover(
        self, lo_ep: int, hi_ep: int, sealed_through: Optional[int] = None
    ) -> Tuple[List[Segment], int, int]:
        """(segments, covered, missing) for the SEALED epochs of
        ``[lo_ep, hi_ep]``: coarse blocks where one fits entirely inside
        the range, fine/memory segments next, disk loads last. Epochs
        with no surviving segment count as missing. ``sealed_through``:
        the caller's reading of it (default: the tier's own)."""
        parts: List[Segment] = []
        covered = 0
        missing = 0
        with self._lock:
            if sealed_through is None:
                sealed_through = self.sealed_through
            hi = min(hi_ep, sealed_through)
            # everything below the tier's oldest reachable epoch is
            # missing by arithmetic — a multi-year lookback must not
            # turn into a per-epoch scan of epochs nothing retains
            floor = sealed_through + 1
            if self._disk_epochs:
                floor = min(floor, min(self._disk_epochs))
            if self._fine:
                floor = min(floor, next(iter(self._fine)))
            if self._coarse:
                floor = min(floor, self._coarse[0].lo_ep)
            start = max(lo_ep, floor)
            if hi >= lo_ep:
                missing += max(0, min(start, hi + 1) - lo_ep)
            coarse_at = {b.lo_ep: b for b in self._coarse}
            e = start
            while e <= hi:
                block = coarse_at.get(e)
                if block is not None and block.hi_ep <= hi:
                    parts.append(block)
                    covered += block.hi_ep - block.lo_ep + 1
                    e = block.hi_ep + 1
                    continue
                seg = self._fine.get(e)
                if seg is None:
                    # epochs inside a PARTIALLY-overlapping coarse block
                    # land here too: the pre-merged block folded epochs
                    # outside the range, so exactness requires the fine
                    # segment — disk retains every sealed fine bucket
                    seg = self._load_disk(e) if self.directory else None
                if seg is not None:
                    parts.append(seg)
                    covered += 1
                else:
                    missing += 1
                e += 1
        return parts, covered, missing

    def window(self, agg, lo_ep: int, hi_ep: int) -> WindowAnswer:
        """The merged windowed read: sealed segments folded host-side
        (ops/ttmerge.py) + one device read for the unsealed suffix when
        the range reaches past ``sealed_through``. This function is the
        compute behind the mirror's demand-registered ``ttq:`` keys —
        a sealed-only window never touches the aggregator lock."""
        t0 = time.perf_counter()
        # one reading of sealed_through for both halves: a seal that lands
        # between them must not drop its epoch from the answer (the
        # reference reads it twice, ``zipkin_tpu/tpu/timetier.py:window``);
        # an epoch sealed after this reading is still on the device
        with self._lock:
            sealed = self.sealed_through
        parts, covered, missing = self.cover(lo_ep, hi_ep, sealed)
        unsealed = hi_ep > sealed
        if unsealed:
            u_lo = max(lo_ep, sealed + 1)
            ep, regs, digest, calls, errs = agg.tt_read(u_lo, hi_ep)
            parts = parts + [Segment(
                lo_ep=u_lo, hi_ep=hi_ep,
                digest=np.asarray(digest, np.float32),
                hll=np.asarray(regs, np.uint8),
                calls=np.asarray(calls, np.uint32),
                errs=np.asarray(errs, np.uint32),
            )]
            present = set(int(x) for x in np.asarray(ep) if x >= 0)
            covered += len(
                [e for e in present if u_lo <= e <= hi_ep]
            )
        if parts:
            digest = ttmerge.merge_digests([p.digest for p in parts])
            hll = ttmerge.merge_hll([p.hll for p in parts])
            calls = ttmerge.merge_edges([p.calls for p in parts])
            errs = ttmerge.merge_edges([p.errs for p in parts])
        else:
            cfg = self.config
            k = int(cfg.max_keys)
            cw = int(cfg.time_digest_centroids)
            s = int(cfg.max_services)
            digest = np.zeros((k, cw, 2), np.float32)
            hll = np.zeros(
                (int(cfg.hll_rows), 1 << int(cfg.hll_precision)), np.uint8
            )
            calls = np.zeros((s, s), np.uint64)
            errs = np.zeros((s, s), np.uint64)
        with self._lock:
            self.counters["ttWindowReads"] += 1
            self.counters["ttWindowMergeMsLast"] = (
                time.perf_counter() - t0
            ) * 1000.0
            self.counters["ttMissingEpochs"] += missing
        return WindowAnswer(
            lo_ep=lo_ep, hi_ep=hi_ep, covered=covered, missing=missing,
            unsealed=unsealed, digest=digest, hll=hll,
            calls=calls, errs=errs,
        )

    # -- maintenance -----------------------------------------------------

    def clear(self) -> None:
        """Forget every segment (store.clear()): rings, caches, and the
        on-disk epoch index reset; disk files are left for postmortem
        (clear is a test/ops affordance, not retention)."""
        with self._lock:
            self._fine.clear()
            self._pending_coarse = []
            self._coarse.clear()
            self._disk_cache.clear()
            self._disk_epochs = set()
            self.sealed_through = -1
            self.counters["ttSegmentsFine"] = 0
            self.counters["ttSegmentsCoarse"] = 0
            self.counters["ttSegmentsDisk"] = 0

    def export_counters(self) -> Dict[str, float]:
        with self._lock:
            return dict(self.counters)

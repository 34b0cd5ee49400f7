"""Background at-rest crc scrubber of the durable artifacts (the port's copy
of ``zipkin_tpu/runtime/scrub.py``; numpy and the standard library).

Restore-time digest checks catch rot only when a boot happens to read the
rotted file, so sealed WAL segments, sealed archive segments, retained
snapshot generations and the archive's vocab sidecar are re-verified while
the server runs, paced by a byte budget so a pass never competes with
ingest for the disk.

Quarantine semantics (shared with the snapshot restore's fallback):

- a bad artifact is renamed aside with ``.quarantine``, never unlinked: it
  is the evidence of what rotted;
- an archive segment with a bad frame leaves the read set whole (searches
  skip it, counted in ``spansQuarantined``, instead of failing the query;
  a read holding an earlier ``views()`` keeps its retained fd);
- a WAL segment is quarantined only when every record it holds is covered
  by the newest durable snapshot, so pulling it loses nothing; a bad
  record in the uncovered suffix stays in place (replay's torn-tail rule
  keeps the good prefix) and counts in ``scrubCorruptDetected``;
- a snapshot generation failing its leaf-digest manifest is quarantined
  as at restore; the next boot falls back to an older generation and the
  longer WAL suffix.

Counters reach ``ingest_counters()`` and ``/metrics``; ``status()`` holds
the last pass.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
import zlib
from typing import Optional

import numpy as np

from zipkin_tpu_torch.tpu import archive as archive_mod
from zipkin_tpu_torch.tpu import snapshot as snap_mod
from zipkin_tpu_torch.tpu import wal as wal_mod

logger = logging.getLogger(__name__)


class Scrubber:
    """Paced background scanner over a store's durable artifacts.

    ``interval_s`` is the idle gap between full passes;
    ``bytes_per_sec`` caps read bandwidth WITHIN a pass (0 = unpaced, as
    tests scan)."""

    def __init__(
        self,
        store,
        *,
        interval_s: float = 300.0,
        bytes_per_sec: int = 8 << 20,
    ) -> None:
        self.store = store
        self.interval_s = float(interval_s)
        self.bytes_per_sec = int(bytes_per_sec)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._counters = {
            "scrubBytes": 0,
            "scrubPasses": 0,
            "scrubFiles": 0,
            "segmentsQuarantined": 0,
            "spansQuarantined": 0,
            "scrubCorruptDetected": 0,
        }
        self._last_pass: Optional[dict] = None
        # pacing state (single scan thread; never touched under _lock)
        self._t0 = 0.0
        self._debt = 0.0

    # -- lifecycle -------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, name="zipkin-tpu-scrub", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            self._thread = None

    def _run(self) -> None:
        # first pass only after one full interval: the boot restore just
        # verified everything a restore touches, so scrubbing at t=0
        # would double-read the hot set during startup
        while not self._stop.wait(self.interval_s):
            try:
                self.scan_once()
            except Exception:  # pragma: no cover - defensive
                logger.exception("scrub pass failed; will retry next interval")

    # -- pacing ----------------------------------------------------------

    def _pace(self, nbytes: int) -> None:
        if self.bytes_per_sec <= 0 or nbytes <= 0:
            return
        self._debt += nbytes / self.bytes_per_sec
        while not self._stop.is_set():
            ahead = self._debt - (time.monotonic() - self._t0)
            if ahead <= 0:
                break
            self._stop.wait(min(ahead, 0.2))

    # -- one full pass ---------------------------------------------------

    def scan_once(self) -> dict:
        """Verify every at-rest artifact once; returns this pass's
        summary (also retained for ``status()``). Safe to call from
        tests without ``start()``."""
        t_start = time.time()
        self._t0 = time.monotonic()
        self._debt = 0.0
        stats = dict(
            files=0, bytes=0, corrupt=0, quarantined=0, spans_quarantined=0
        )
        self._scrub_wal(stats)
        self._scrub_archive(stats)
        self._scrub_generations(stats)
        self._scrub_vocab_sidecar(stats)
        pass_ms = round((time.time() - t_start) * 1000.0, 3)
        with self._lock:
            self._counters["scrubPasses"] += 1
            self._counters["scrubFiles"] += stats["files"]
            self._counters["scrubBytes"] += stats["bytes"]
            self._counters["scrubCorruptDetected"] += stats["corrupt"]
            self._counters["segmentsQuarantined"] += stats["quarantined"]
            self._counters["spansQuarantined"] += stats["spans_quarantined"]
            self._last_pass = {
                "at": t_start,
                "ms": pass_ms,
                "files": stats["files"],
                "bytes": stats["bytes"],
                "corruptDetected": stats["corrupt"],
                "quarantined": stats["quarantined"],
            }
        if stats["corrupt"] or stats["quarantined"]:
            logger.warning(
                "scrub pass: %d files / %d bytes verified, %d corrupt, "
                "%d quarantined",
                stats["files"], stats["bytes"], stats["corrupt"],
                stats["quarantined"],
            )
        return dict(stats, ms=pass_ms)

    def _snapshot_covered_seq(self) -> int:
        """wal_seq of the newest durable snapshot (meta.json) — the
        loss-free WAL quarantine bar. 0 when no snapshot exists (then
        NO record is covered and no WAL segment is ever quarantined)."""
        directory = getattr(self.store, "checkpoint_dir", None)
        if not directory:
            return 0
        try:
            with open(os.path.join(directory, snap_mod.META_FILE)) as f:
                return int(json.load(f).get("wal_seq", 0))
        except (OSError, ValueError):
            return 0

    def _scrub_wal(self, stats: dict) -> None:
        wal = getattr(self.store, "wal", None)
        if wal is None:
            return
        for path in wal.sealed_segment_paths():
            try:
                size = os.path.getsize(path)
                res = wal_mod.verify_segment(path)
            except OSError:
                continue  # truncate_covered raced us; nothing to verify
            stats["files"] += 1
            stats["bytes"] += size
            self._pace(size)
            if res["ok"]:
                continue
            stats["corrupt"] += 1
            covered = self._snapshot_covered_seq()
            if res["max_seq"] <= covered:
                # every readable record is snapshot-covered and the
                # unreadable tail is unreplayable either way: pulling
                # the file is loss-equivalent and cleans the next boot
                try:
                    os.replace(path, path + ".quarantine")
                    stats["quarantined"] += 1
                    logger.warning(
                        "WAL segment %s quarantined (bad record seq %s at "
                        "offset %s; all %d readable records <= covered %d)",
                        path, res["bad_seq"], res["bad_offset"],
                        res["records"], covered,
                    )
                except OSError:
                    pass
            else:
                logger.warning(
                    "WAL segment %s has a bad record (seq %s at offset %s) "
                    "in the UNCOVERED suffix; leaving in place for replay's "
                    "torn-tail salvage", path, res["bad_seq"],
                    res["bad_offset"],
                )

    def _scrub_archive(self, stats: dict) -> None:
        disk = getattr(self.store, "_disk", None)
        if disk is None:
            return
        for path in disk.sealed_segment_paths():
            try:
                size = os.path.getsize(path)
                res = archive_mod.verify_frames(path)
            except OSError:
                continue  # retention unlinked it mid-pass
            stats["files"] += 1
            stats["bytes"] += size
            self._pace(size)
            if res["ok"]:
                continue
            stats["corrupt"] += 1
            n = disk.quarantine_segment(path)
            if n or not os.path.exists(path):
                stats["quarantined"] += 1
                stats["spans_quarantined"] += n

    def _scrub_generations(self, stats: dict) -> None:
        directory = getattr(self.store, "checkpoint_dir", None)
        if not directory or not os.path.isdir(directory):
            return
        for _, name in snap_mod._state_generations(directory):
            gm_path = os.path.join(directory, snap_mod._gen_meta_name(name))
            state_path = os.path.join(directory, name)
            try:
                with open(gm_path) as f:
                    crcs = json.load(f).get("leaf_crcs")
            except (OSError, ValueError):
                continue  # orphan or pre-manifest generation: unjudgeable
            bad = False
            try:
                size = os.path.getsize(state_path)
                loaded = np.load(state_path)
                leaves = [loaded[k] for k in loaded.files]
                got = snap_mod.leaf_digests(leaves)
                bad = crcs is None or len(crcs) != len(got) or any(
                    int(w) != g for w, g in zip(crcs, got)
                )
            except FileNotFoundError:
                continue  # pruned mid-pass
            except Exception:
                bad = True
                size = 0
                try:
                    size = os.path.getsize(state_path)
                except OSError:
                    pass
            stats["files"] += 1
            stats["bytes"] += size
            self._pace(size)
            if bad:
                stats["corrupt"] += 1
                stats["quarantined"] += 1
                snap_mod.quarantine_generation(directory, name)

    def _scrub_vocab_sidecar(self, stats: dict) -> None:
        """The archive vocab sidecar self-records a payload crc32 (see
        store._persist_archive_vocab); rot there would remap every id
        on recovered segments at the NEXT boot — catch it now."""
        path = getattr(self.store, "_archive_vocab_path", None)
        if not path or not os.path.exists(path):
            return
        try:
            size = os.path.getsize(path)
            with open(path) as f:
                meta = json.load(f)
            want = meta.pop("crc32", None)
            ok = want is None or zlib.crc32(
                json.dumps(meta, sort_keys=True, separators=(",", ":")).encode()
            ) == int(want)
        except (OSError, ValueError):
            ok, size = False, 0
        stats["files"] += 1
        stats["bytes"] += size
        self._pace(size)
        if not ok:
            stats["corrupt"] += 1
            # do not quarantine out from under a RUNNING store — its
            # vocab is live in memory and the next persist rewrites the
            # sidecar whole; boot-time verification handles a cold read
            logger.warning(
                "archive vocab sidecar %s failed its digest at rest; the "
                "next vocab growth rewrites it", path,
            )

    # -- surfaces --------------------------------------------------------

    def counters(self) -> dict:
        with self._lock:
            return dict(self._counters)

    def status(self) -> dict:
        with self._lock:
            last = dict(self._last_pass) if self._last_pass else None
        return {
            "running": self._thread is not None,
            "intervalS": self.interval_s,
            "bytesPerSec": self.bytes_per_sec,
            "lastPass": last,
        }

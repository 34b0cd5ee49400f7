"""STORAGE_TYPE=tpu: the resume adapter over the device store (port of
``zipkin_tpu/storage/tpu.py:22-318``).

It subclasses :class:`zipkin_tpu_torch.tpu.store.TorchStorage`, as the
reference subclasses its core store, and owns durable boot:

1. disarm the sampling gate (WAL records hold verdict-kept lanes and their
   tallies: a second verdict pass would drop or count them again);
2. restore the newest intact snapshot generation (``checkpoint_dir``);
3. replay the WAL records past its ``wal_seq`` (``wal_dir``);
4. attach the WAL, so new batches log with delta cursors at the post-replay
   vocab;
5. re-arm the sampling gate (the restored host tables go to the device
   leaves) and start the rate controller, whose first tick then sees
   post-replay tallies;
6. ``resume_offset``: the durable span count, where a transport that tracks
   offsets resumes;
7. with ``mirror_segment_bytes`` > 0, create the shared-memory mirror
   segment (:class:`~zipkin_tpu_torch.serving.segment.MirrorSegment`, one
   heartbeat and demand stripe for each of ``mirror_segment_readers``) and
   attach it, so the first epoch lands in it;
8. cut the first read-mirror epoch from the restored state
   (:meth:`publish_mirror`): the first read after boot serves lock-free,
   and its digest read flushes the pending digest points (a ``ttflush``
   record with the time tier on), as the reference's does;
9. with ``scrub_interval_s`` > 0 and something durable to scrub, start the
   at-rest scrubber (:mod:`zipkin_tpu_torch.runtime.scrub`).

The disk archive (``archive_dir``) opens in the core store's constructor,
before all this: it recovers its unsealed tail and loads its vocab sidecar,
which the snapshot's vocab then replaces (the same id stream) and the WAL
replay extends; the C interner of the line-rate path is rebuilt from the
final vocab at the next fast ingest.

``snapshot()`` persists the state, truncates the WAL to the oldest retained
generation's ``wal_seq``, and degrades on a full disk (the retained
generations stay intact; the save is retried next cycle). ``close()``
drains and closes an attached multi-process tier (``mp_ingester``) before
the WAL detaches, when the server's ``stop()`` has not, and retires the
mirror segment. Left out against the reference: the mesh (``num_devices``).
"""

from __future__ import annotations

import errno
import logging
import threading
import time
from typing import Optional, Sequence

from zipkin_tpu_torch import obs
from zipkin_tpu_torch.obs import querytrace
from zipkin_tpu_torch.runtime.scrub import Scrubber
from zipkin_tpu_torch.tpu import snapshot as snap
from zipkin_tpu_torch.tpu import wal as wal_mod
from zipkin_tpu_torch.tpu.state import AggConfig
from zipkin_tpu_torch.tpu.store import DEPS_MAX_STALE_MS, MAX_DEVICE_BATCH
from zipkin_tpu_torch.tpu.store import TorchStorage as _CoreStorage

logger = logging.getLogger(__name__)


class TorchStorage(_CoreStorage):
    def __init__(
        self,
        *,
        max_span_count: int = 500_000,
        batch_size: int = 8192,
        device=None,
        checkpoint_dir: Optional[str] = None,
        config: Optional[AggConfig] = None,
        strict_trace_id: bool = True,
        search_enabled: bool = True,
        autocomplete_keys: Sequence[str] = (),
        fast_archive_sample: int = 64,
        max_device_batch: int = MAX_DEVICE_BATCH,
        deps_max_stale_ms: float = DEPS_MAX_STALE_MS,
        wal_dir: Optional[str] = None,
        wal_fsync: bool = False,
        archive_dir: Optional[str] = None,
        archive_max_bytes: int = 2 << 30,
        archive_segment_bytes: int = 64 << 20,
        sampling_budget: float = 0.0,
        sampling_interval_s: float = 5.0,
        sampling_min_rate: int = 256,
        sampling_tail_quantile: float = 0.99,
        sampling_rare_min: Optional[int] = None,
        snapshot_keep: int = 2,
        scrub_interval_s: float = 0.0,
        scrub_bytes_per_sec: int = 8 << 20,
        mirror_segment_bytes: int = 0,
        mirror_segment_readers: int = 4,
    ) -> None:
        """``device``: where the state lives and is restored to, the card
        unless the caller names another. ``wal_fsync``: fsync each append,
        so the log survives a host or power failure at a per-batch cost;
        without it the log survives a process crash (the page cache holds
        it). ``scrub_interval_s``: the gap between the scrubber's passes (0:
        no scrubber), each read paced at ``scrub_bytes_per_sec``.
        ``mirror_segment_bytes``: each of the segment's two payload buffers
        (0: no segment)."""
        super().__init__(
            config=config,
            device=device,
            strict_trace_id=strict_trace_id,
            search_enabled=search_enabled,
            autocomplete_keys=autocomplete_keys,
            archive_max_span_count=max_span_count,
            pad_to_multiple=min(batch_size, 1024),
            fast_archive_sample=fast_archive_sample,
            max_device_batch=max_device_batch,
            deps_max_stale_ms=deps_max_stale_ms,
            archive_dir=archive_dir,
            archive_max_bytes=archive_max_bytes,
            archive_segment_bytes=archive_segment_bytes,
            sampling_budget=sampling_budget,
            sampling_interval_s=sampling_interval_s,
            sampling_min_rate=sampling_min_rate,
            sampling_tail_quantile=sampling_tail_quantile,
            sampling_rare_min=sampling_rare_min,
        )
        self.checkpoint_dir = checkpoint_dir
        # the fallback depth: a commit retains this many intact generations
        self.snapshot_keep = max(1, int(snapshot_keep))
        self._snapshot_lock = threading.Lock()
        # the age of the last persisted generation (boot counts as one)
        self._last_snapshot_mono = time.monotonic()
        # disk-full degraded mode of the snapshot
        self._snapshot_at_risk = False
        self._snapshot_enospc = 0
        self.wal: Optional[wal_mod.WriteAheadLog] = None
        self.agg.sampler = None
        restored = False
        if checkpoint_dir:
            t0 = time.perf_counter()
            restored = snap.maybe_restore(self, checkpoint_dir)
            self.restore_stats["restoreMs"] = round((time.perf_counter() - t0) * 1000.0, 3)
        if wal_dir:
            wal = wal_mod.WriteAheadLog(wal_dir, fsync=wal_fsync)
            t0 = time.perf_counter()
            # the contention ledger names the boot's replay holds
            with querytrace.lock_label("wal_replay"):
                applied = wal_mod.replay(self, wal, from_seq=self.agg.wal_seq)
            self.agg.block_until_ready()  # the replayed steps count in walReplayMs
            self.restore_stats["walReplayBatches"] = applied
            self.restore_stats["walReplayMs"] = round((time.perf_counter() - t0) * 1000.0, 3)
            wal_mod.attach(self, wal)
        if restored or self.restore_stats["walReplayBatches"]:
            logger.info(
                "boot resume: snapshot %s (%.1f ms), WAL replayed %d records (%.1f ms); durable "
                "span count %d (transport offset resume point)",
                "restored" if restored else "absent", self.restore_stats["restoreMs"],
                self.restore_stats["walReplayBatches"], self.restore_stats["walReplayMs"],
                self.agg.host_counters["spans"])
        self.install_sampler()
        if self.sampling_controller is not None:
            self.sampling_controller.start()
        self.resume_offset = int(self.agg.host_counters["spans"])
        # the segment exists before the boot publish below, so readers that
        # attach after a crash-resume serve the restored epoch
        self.mirror_segment = None
        if mirror_segment_bytes > 0:
            from zipkin_tpu_torch.serving.segment import MirrorSegment

            self.mirror_segment = MirrorSegment(readers=mirror_segment_readers,
                                                capacity=mirror_segment_bytes)
            self.attach_mirror_segment(self.mirror_segment)
        # the first epoch, cut from the restored state before any ticker:
        # its digest read flushes the pending digest points (a ttflush
        # record with the time tier on), at the reference's point
        self.publish_mirror()
        # boot's restore, replay and publish pulls are not query transfers
        self.agg.read_stats["host_transfers"] = 0
        # the first pass waits one interval: the boot just read what a
        # restore verifies
        if scrub_interval_s > 0 and (checkpoint_dir or wal_dir or self._disk is not None):
            self.scrubber = Scrubber(self, interval_s=scrub_interval_s,
                                     bytes_per_sec=scrub_bytes_per_sec)
            self.scrubber.start()

    def snapshot(self) -> Optional[str]:
        """Persist the device state (:func:`snapshot.save`); returns the
        directory, or None without a checkpoint dir, after close, or when the
        disk is full. WAL segments the oldest retained generation covers are
        deleted. Serialized, so a periodic save and the final one cannot
        pair a newer state file with an older wal_seq."""
        if not self.checkpoint_dir:
            return None
        with self._snapshot_lock:
            if self._closed:
                return None  # close() holds this lock, so the check is race-free
            t0 = time.perf_counter()
            try:
                # the contention ledger names the save's hold
                with querytrace.lock_label("snapshot"):
                    path = snap.save(self, self.checkpoint_dir, keep=self.snapshot_keep)
            except OSError as e:
                if e.errno != errno.ENOSPC:
                    raise
                # degraded, not dead: renames happen only after a complete
                # write, so every retained generation is intact
                self._snapshot_enospc += 1
                if not self._snapshot_at_risk:
                    logger.error("snapshot save hit ENOSPC: durability AT RISK (retained "
                                 "generations intact; retrying next cycle)")
                self._snapshot_at_risk = True
                return None
            if self.wal is not None:
                covered = snap.retained_coverage(self.checkpoint_dir)
                if covered is not None:
                    self.wal.truncate_covered(covered)
                # the whole state is durable: a missed WAL window no longer
                # threatens acked spans
                self.wal.clear_at_risk()
            self._snapshot_at_risk = False
            obs.record("snapshot", time.perf_counter() - t0)
            self._last_snapshot_mono = time.monotonic()
        return path

    def ingest_counters(self) -> dict:
        counters = super().ingest_counters()
        if self.checkpoint_dir:
            counters["snapshotAgeS"] = round(time.monotonic() - self._last_snapshot_mono, 3)
        counters["snapshotEnospc"] = self._snapshot_enospc
        if self.wal is not None:
            counters["walEnospc"] = self.wal.enospc_count
            counters["walMissedRecords"] = self.wal.missed_records
        # 1 while any durable tier is in its disk-full degraded mode
        counters["durabilityAtRisk"] = int(
            self._snapshot_at_risk or (self.wal is not None and self.wal.at_risk))
        return counters

    def close(self) -> None:
        # an attached multi-process tier is drained and closed before the
        # WAL detaches: its dispatcher logs through the aggregator's
        # wal_hook, and a log closed under it would strand 202-acked spans.
        # The server's stop() does this first; this covers callers that
        # only close the storage
        ing = self.mp_ingester
        if ing is not None:
            try:
                if ing._dispatch_error is None and not ing._closed:
                    ing.drain()
            except Exception:
                logger.exception("mp-ingest drain failed during close")
            finally:
                ing.close()
                self.mp_ingester = None
        if self.scrubber is not None:
            self.scrubber.stop()  # no pass reads a log or a segment being closed
        # serialized with snapshot(): one in flight finishes first, and any
        # later one sees _closed
        with self._snapshot_lock:
            if self.sampling_controller is not None:
                self.sampling_controller.stop()  # no publish after the log closes
            if self.wal is not None:
                # detach the hook before closing the segment, or a reused
                # aggregator could append to a closed file
                self.agg.wal_hook = None
                self.wal.close()
            seg = self.mirror_segment
            if seg is not None:
                # detach the sink first, so a late publish cannot write
                # through a closed mapping
                self.mirror.segment_sink = None
                seg.close()
                self.mirror_segment = None
            super().close()

"""Host reference sampler: the authoritative, bit-exact verdict oracle
(port of ``zipkin_tpu/sampling/reference.py``, numpy only).

Two jobs:

1. **Gate retention on host.** WAL records, the disk archive, and the
   RAM archive sample persist only spans whose verdict is keep. The
   verdict math here mirrors :func:`zipkin_tpu_torch.sampling.device.
   device_verdict` operation-for-operation over the SAME published
   tables (``columnar._mix32`` is the proven numpy mirror of
   ``ops.hashing.fmix32``), so host gating and the device's recorded
   ``r_keep`` bits agree exactly — the tier's parity oracle.

2. **Feed the controller.** Every batch that reaches
   ``TorchAggregator.ingest_fused`` (the funnel all ingest paths share
   — sync fast path, object path, MP dispatcher) is ``observe``d once:
   exact per-service seen/kept tallies plus the LIVE (svc, rsvc) edge
   counts the controller publishes from. The live counts never gate
   anything directly — verdicts read only the last PUBLISHED tables, on
   both host and device, which is what makes them reproducible.
"""

from __future__ import annotations

import threading
from typing import Optional, Tuple

import numpy as np

from zipkin_tpu_torch.sampling import RATE_ONE, VERDICT_SALT
from zipkin_tpu_torch.tpu.columnar import SpanColumns, _hash2_np, _mix32


def host_verdict(
    trace_h: np.ndarray,
    svc: np.ndarray,
    rsvc: np.ndarray,
    key: np.ndarray,
    dur: np.ndarray,
    has_dur: np.ndarray,
    err: np.ndarray,
    valid: np.ndarray,
    rate: np.ndarray,
    tail: np.ndarray,
    link: np.ndarray,
    rare_min: int,
) -> np.ndarray:
    """numpy mirror of :func:`sampling.device.device_verdict` (keep the
    two in lockstep — the parity test fails on any divergence)."""
    h16 = _mix32(trace_h.astype(np.uint32) ^ np.uint32(VERDICT_SALT)) >> np.uint32(16)
    svc_c = np.clip(svc, 0, rate.shape[0] - 1).astype(np.int64)
    rsvc_c = np.clip(rsvc, 0, rate.shape[0] - 1).astype(np.int64)
    key_c = np.clip(key, 0, tail.shape[0] - 1).astype(np.int64)
    tail_hit = has_dur & (dur >= tail[key_c])
    rare = (rsvc > 0) & (link[svc_c, rsvc_c] < np.uint32(rare_min))
    return valid & (err | tail_hit | rare | (h16 < rate[svc_c]))


class HostSampler:
    """Published tables + live observations for one storage instance.

    Thread model: verdicts only READ the published table references
    (publish swaps whole arrays — a Python attribute store, atomic), so
    they take no lock. ``observe`` and the controller's table reads
    mutate shared tallies and serialize on ``self._lock``; the caller
    (``ingest_fused``) additionally holds the aggregator lock, which is
    what orders observations against table publishes.
    """

    def __init__(self, max_services: int, max_keys: int, rare_min: int = 4) -> None:
        self.rare_min = int(rare_min)
        # published tables — always swapped wholesale, never mutated in
        # place (except apply_sctl during single-threaded boot replay)
        self.rate = np.full(max_services, RATE_ONE, np.uint32)
        self.tail = np.full(max_keys, 0xFFFFFFFF, np.uint32)
        self.link = np.zeros((max_services, max_services), np.uint32)
        # live observations the controller publishes FROM
        self.link_live = np.zeros((max_services, max_services), np.uint64)
        self.seen_by_svc = np.zeros(max_services, np.int64)
        self.kept_by_svc = np.zeros(max_services, np.int64)
        self._lock = threading.Lock()

    # -- verdicts (pure reads of the published tables) -------------------

    def verdict_cols(self, cols: SpanColumns) -> np.ndarray:
        """[n] bool keep verdicts in SpanColumns lane order (gates the
        RAM/disk archive writes, which see the batch pre-routing)."""
        return host_verdict(
            cols.trace_h, cols.svc, cols.rsvc, cols.key, cols.dur,
            cols.has_dur, cols.err, cols.valid,
            self.rate, self.tail, self.link, self.rare_min,
        )

    def verdict_fused(self, fused: np.ndarray) -> np.ndarray:
        """[shards, per] bool keep verdicts over a routed wire image —
        the same pure function in the device's lane order (gates WAL
        persistence and is what the parity oracle compares to r_keep)."""
        f = np.asarray(fused)
        sr, kf = f[..., 9, :], f[..., 10, :]
        return host_verdict(
            f[..., 0, :],
            (sr >> np.uint32(16)).astype(np.int64),
            (sr & np.uint32(0xFFFF)).astype(np.int64),
            (kf >> np.uint32(8)).astype(np.int64),
            f[..., 7, :],
            (kf & np.uint32(8)) != 0,
            (kf & np.uint32(4)) != 0,
            (kf & np.uint32(1)) != 0,
            self.rate, self.tail, self.link, self.rare_min,
        )

    def gate_record(self, rec: tuple):
        """Gate one prebuilt disk-archive record (archive.parsed_record
        layout: payload, off, ln, tl0, tl1, th0, th1, svc, rsvc, name,
        key, ts_min, dur, err — GLOBAL vocab ids) down to its kept
        spans, compacting the raw-byte payload. Returns the filtered
        record, or None when nothing survives. The MP dispatcher's
        archive seam — worker-shipped records never pass through
        SpanColumns, so the verdict is recomputed from the index
        columns here. ``has_dur`` approximates as ``dur > 0``: the
        controller's tail thresholds are always >= 1, so the tail
        clause is unaffected and the verdict matches the cols path."""
        tl0, tl1, th0, th1 = rec[3], rec[4], rec[5], rec[6]
        trace_h = _hash2_np(_hash2_np(tl0, tl1), _hash2_np(th0, th1))
        dur = np.minimum(rec[12], 0xFFFFFFFF).astype(np.uint32)
        keep = host_verdict(
            trace_h,
            rec[7].astype(np.int64), rec[8].astype(np.int64),
            rec[10].astype(np.int64),
            dur, dur > 0, np.asarray(rec[13], bool),
            np.ones(len(rec[1]), bool),
            self.rate, self.tail, self.link, self.rare_min,
        )
        if bool(keep.all()):
            return rec
        idx = np.nonzero(keep)[0]
        if not len(idx):
            return None
        payload, off, ln = rec[0], rec[1], rec[2]
        parts = [bytes(payload[off[i] : off[i] + ln[i]]) for i in idx]
        new_ln = np.asarray(ln)[idx].astype(np.uint32)
        new_off = np.zeros(len(idx), np.uint32)
        pos = 0
        for j, p in enumerate(parts):
            new_off[j] = pos
            pos += len(p)
        rest = tuple(np.asarray(col)[idx] for col in rec[3:])
        return (b"".join(parts), new_off, new_ln) + rest

    # -- observations (once per batch, at the ingest_fused funnel) -------

    def observe(self, fused: np.ndarray, keep: np.ndarray) -> Tuple[int, int]:
        """Fold one routed batch's lanes into the live tallies; returns
        (seen, kept) span counts for the batch. Call exactly ONCE per
        batch — ``ingest_fused`` is the funnel every path goes through."""
        f = np.asarray(fused)
        sr, kf = f[..., 9, :], f[..., 10, :]
        valid = (kf & np.uint32(1)) != 0
        svc = np.clip(
            (sr >> np.uint32(16)).astype(np.int64)[valid],
            0, self.rate.shape[0] - 1,
        )
        rsvc = (sr & np.uint32(0xFFFF)).astype(np.int64)[valid]
        k = np.asarray(keep)[valid]
        with self._lock:
            e = rsvc > 0
            np.add.at(self.link_live, (svc[e], np.clip(rsvc[e], 0, self.rate.shape[0] - 1)), 1)
            np.add.at(self.seen_by_svc, svc, 1)
            np.add.at(self.kept_by_svc, svc, k.astype(np.int64))
        return int(valid.sum()), int(k.sum())

    def take_tallies(self) -> Tuple[np.ndarray, np.ndarray]:
        """(seen, kept) per-service counts since the last take; resets."""
        with self._lock:
            seen, kept = self.seen_by_svc.copy(), self.kept_by_svc.copy()
            self.seen_by_svc[:] = 0
            self.kept_by_svc[:] = 0
        return seen, kept

    def link_snapshot(self) -> np.ndarray:
        """u32 publishable copy of the live edge counts (clamped)."""
        with self._lock:
            return np.minimum(self.link_live, 0xFFFFFFFF).astype(np.uint32)

    # -- WAL compaction --------------------------------------------------

    def compact_fused(
        self, fused: np.ndarray, keep: np.ndarray, pad: int = 256
    ) -> Optional[Tuple[np.ndarray, int, int, int, tuple]]:
        """Repack a routed wire image down to its KEPT lanes (per-shard
        stable order, zero-padded to a ``pad`` multiple) — what the WAL
        persists instead of the full batch. Returns (fused', n_spans,
        n_dur, n_err, ts_range), or None when nothing was kept (the
        caller then skips the WAL record entirely)."""
        f = np.asarray(fused)
        k = np.asarray(keep)
        shards, rows, _ = f.shape
        counts = k.sum(axis=1)
        m = int(counts.max()) if counts.size else 0
        if m == 0:
            return None
        per2 = -(-m // pad) * pad
        out = np.zeros((shards, rows, per2), np.uint32)
        for s in range(shards):
            idx = np.nonzero(k[s])[0]
            out[s, :, : len(idx)] = f[s][:, idx]
        kf = out[:, 10, :]
        valid = (kf & np.uint32(1)) != 0
        ts = out[:, 8, :][valid]
        return (
            out,
            int(valid.sum()),
            int(((kf & np.uint32(8)) != 0).sum()),
            int(((kf & np.uint32(4)) != 0).sum()),
            (int(ts.min()), int(ts.max())) if ts.size else (0, 0),
        )

    # -- publish / restore ----------------------------------------------

    def sctl_delta(
        self, rate: np.ndarray, tail: np.ndarray, link: np.ndarray
    ) -> dict:
        """Sparse JSON-able diff of a new publish vs the current tables —
        the WAL ``sctl`` record payload. Replaying these deltas in order
        on top of snapshot-restored tables reconstructs the EXACT tables
        at every point of the batch stream, which is what makes
        post-resume verdicts byte-identical. Link diffs use flat [S*S]
        indices; real service graphs are sparse so they stay small."""
        d: dict = {}
        r = np.nonzero(rate != self.rate)[0]
        if len(r):
            d["r"] = [[int(i), int(rate[i])] for i in r]
        t = np.nonzero(tail != self.tail)[0]
        if len(t):
            d["t"] = [[int(i), int(tail[i])] for i in t]
        l = np.nonzero(link.ravel() != self.link.ravel())[0]
        if len(l):
            d["l"] = [[int(i), int(link.ravel()[i])] for i in l]
        return d

    def set_tables(
        self, rate: np.ndarray, tail: np.ndarray, link: np.ndarray
    ) -> None:
        """Swap in newly published tables (whole-array stores: verdict
        readers see either the old or the new publish, never a mix of a
        mutated array)."""
        self.rate = np.ascontiguousarray(rate, np.uint32)
        self.tail = np.ascontiguousarray(tail, np.uint32)
        self.link = np.ascontiguousarray(link, np.uint32)

    def apply_sctl(self, delta: dict) -> None:
        """Apply one replayed ``sctl`` WAL delta (boot-time, before the
        sampler gates anything — single-threaded by construction)."""
        rate, tail, link = self.rate.copy(), self.tail.copy(), self.link.copy()
        for i, v in delta.get("r", ()):
            rate[int(i)] = np.uint32(v)
        for i, v in delta.get("t", ()):
            tail[int(i)] = np.uint32(v)
        flat = link.ravel()
        for i, v in delta.get("l", ()):
            flat[int(i)] = np.uint32(v)
        self.set_tables(rate, tail, link)

    def restore_tables(
        self, s_rate: np.ndarray, s_tail: np.ndarray, s_link: np.ndarray
    ) -> None:
        """Seed the published tables from snapshot-restored state leaves
        (one shard's copy — the leaves are replicated by construction)
        and the live counts from the published link table. Edges
        observed after the last publish but before the crash are lost
        from link_live (the WAL logs verdict INPUTS, not every
        observation); the loss biases toward treating edges as rare,
        i.e. toward KEEPING spans — fail-open."""
        self.set_tables(s_rate, s_tail, s_link)
        with self._lock:
            self.link_live = self.link.astype(np.uint64)
            self.seen_by_svc[:] = 0
            self.kept_by_svc[:] = 0

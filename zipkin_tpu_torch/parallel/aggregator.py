"""TorchAggregator: the aggregation tier over a shard mesh
(port of ``zipkin_tpu/parallel/sharded.py``).

Keeps ``ShardedAggregator``'s public names and host bookkeeping. The mesh
(:mod:`zipkin_tpu_torch.parallel.mesh`) is a list of devices, one per
shard; shard ``s`` keeps its own :class:`AggState` on ``mesh[s]`` and runs
the single-shard programs of :mod:`zipkin_tpu_torch.tpu.ingest` on it, as
the reference's ``shard_map`` runs them on each device. A host batch is
routed trace-affine (:func:`route_fused`) into a ``[S, 11, per]`` wire
image; each shard's slice is unpacked on its device
(:func:`unfuse_columns`), due maintenance (digest flush, link rollup) runs
in front of every shard's step exactly where the reference fuses it into
the step program, and every shard steps, empty ones included.

On a card each shard's step of each variant is one captured CUDA graph,
replayed for every batch of its lane count (:class:`StepGraphs`, the
counterpart of the reference's compiled step); on the CPU the same
static-shape step runs eagerly. The states' leaves are written in place
and never swapped: replacing ``states`` drops the captured graphs.

Every read computes each shard's partial on its device, moves the partials
to ``mesh[0]`` and merges them there with the reference's collectives:
the u32 (wrapping) sum for its ``psum`` (histograms, counters, edge
matrices, the tier's calls and errors), the max for its ``pmax`` (HLL
registers, epochs), and :func:`tdigest.merge_many` for its all-gather +
recluster of the digests. One shard's merges are the identity. The merged
outputs are packed on ``mesh[0]`` into one ZPK1 buffer that crosses to the
host in one counted transfer (:mod:`zipkin_tpu_torch.readpack`), as numpy
arrays with the reference's dtypes.

With a :class:`zipkin_tpu_torch.sampling.HostSampler` installed as
``sampler``, every batch is also scored on the host over the same
published tables, and ``wal_hook`` (when set) receives the kept lanes;
without a sampler it receives every batch.

The lock is the query plane's :class:`~zipkin_tpu_torch.obs.querytrace.InstrumentedRLock`
(every outermost wait lands in the ``query_lock_wait`` stage). The host
paths stamp the flight recorder's ``route``, ``device_dispatch``,
``rollup``, ``mp_lut_remap``, ``coalesce`` and ``ctx_advance`` stages where
the reference does, and every device entry point runs inside a device
observatory wrapper under the reference's ``spmd_*`` name
(:mod:`zipkin_tpu_torch.obs.device`): the step variants, the flush and the
rollup, and each read's program, which ends in the packed buffer that
``_pull`` carries to the host. One wrapper covers every shard (one call a
step or a read, as in the reference), and its event pair is recorded on
``mesh[0]``'s stream. ``device_dispatch`` here is the host wall of the
whole step under the lock: the due flush and rollup, every shard's step
and their asynchronous launches.
"""

from __future__ import annotations

import time
from collections import deque
from typing import List, Optional, Tuple

import numpy as np
import torch

from zipkin_tpu_torch import convert, obs, readpack, u32
from zipkin_tpu_torch.device import resolve_device
from zipkin_tpu_torch.obs import querytrace
from zipkin_tpu_torch.obs.device import OBSERVATORY
from zipkin_tpu_torch.ops import histogram, hll, tdigest
from zipkin_tpu_torch.parallel.mesh import make_mesh
from zipkin_tpu_torch.tpu import ingest as ing
from zipkin_tpu_torch.tpu.columnar import SpanColumns, concat_remap, remap_fused, route_fused
from zipkin_tpu_torch.tpu.graphs import CAPTURE_LOCK, StepGraphs
from zipkin_tpu_torch.tpu.state import AggConfig, AggState, init_state


def unfuse_columns(fz: torch.Tensor) -> SpanColumns:
    """``[11, n]`` packed wire image (int64 holding u32) -> typed columns
    on the image's device: u32 lanes int64, ids int64, flags bool."""
    sr = fz[9]
    kf = fz[10]
    return SpanColumns(
        trace_h=fz[0], tl0=fz[1], tl1=fz[2],
        s0=fz[3], s1=fz[4], p0=fz[5], p1=fz[6],
        shared=(kf & 2) != 0,
        kind=(kf >> 4) & 7,
        svc=sr >> 16, rsvc=sr & 0xFFFF,
        key=kf >> 8,
        err=(kf & 4) != 0,
        dur=fz[7],
        has_dur=(kf & 8) != 0,
        ts_min=fz[8],
        valid=(kf & 1) != 0,
    )


def shard_program(cfg: AggConfig, need_flush: bool, need_rollup: bool):  # zt-captured: the step programs StepGraphs captures
    """One shard's step of a variant over its ``[11, lanes]`` int32 wire
    image: widen and unpack the image, the due flush and rollup, the
    ingest step, all in place on the state (what a captured graph holds)."""
    def program(state: AggState, bits: torch.Tensor) -> None:  # zt-in-place: state — flushed, rolled up and stepped in place
        batch = unfuse_columns(u32.widen(bits))
        if need_flush:
            ing.flush_digest(cfg, state)
        if need_rollup:
            ing.rollup_step(cfg, state)
        ing.ingest_step(cfg, state, batch)
    return program


def _capture_counter(steps):
    """The step graphs' ``on_capture``: a capture of a variant is one
    compile of that variant's wrapped program in the device observatory,
    and a recompile when a step had to make it after the boot captures.
    Holds the programs' stats, not the aggregator (no reference cycle)."""
    stats = {variant: wrapped.program_stats for variant, wrapped in steps.items()}

    def count(variant, seconds: float, recompile: bool) -> None:
        if OBSERVATORY.enabled:
            stats[variant].compiled(1, seconds, int(recompile))
    return count


def _edge_topk(calls: torch.Tensor, errors: torch.Tensor, e: int):
    """The first ``e`` nonzero cells of the call matrix by prefix-sum
    compaction: (flat_index int32, calls u32, errors u32), each [e]."""
    cf = calls.reshape(-1)
    ef = errors.reshape(-1)
    cs = torch.cumsum((cf > 0).to(torch.int64), 0)
    want = torch.arange(1, e + 1, dtype=torch.int64, device=cf.device)
    pos = torch.clamp(torch.searchsorted(cs, want, right=False), 0, cf.shape[0] - 1)
    have = torch.arange(e, device=cf.device) < cs[-1]
    return (
        torch.where(have, pos, 0),
        torch.where(have, cf[pos], 0),
        torch.where(have, ef[pos], 0),
    )


def _on_first(parts: List[torch.Tensor]) -> torch.Tensor:
    """The shards' partials stacked on the first one's device (the
    reference's all-gather): ``[S, ...]``."""
    dev = parts[0].device
    return torch.stack([p.to(dev) for p in parts])


def psum(parts: List[torch.Tensor]) -> torch.Tensor:
    """The reference's ``psum`` of u32 planes (int64 holding u32): the
    wrapping sum over shards, on the first shard's device."""
    if len(parts) == 1:
        return parts[0]
    return u32.wrap(_on_first(parts).sum(0))


def pmax(parts: List[torch.Tensor]) -> torch.Tensor:
    """The reference's ``pmax``: the elementwise max over shards."""
    if len(parts) == 1:
        return parts[0]
    return _on_first(parts).amax(0)


def digest_merge(parts: List[torch.Tensor]) -> torch.Tensor:
    """The reference's all-gather + row-wise recluster of per-shard
    ``[K, C, 2]`` digests (``_gather_recluster``): shard-major
    concatenation, then :func:`tdigest.merge_many` (one shard is the
    identity)."""
    return tdigest.merge_many([p.to(parts[0].device) for p in parts])


class TorchAggregator:
    """Owns the per-shard device states and runs the ingest step and the
    reads."""

    def __init__(self, config: AggConfig = AggConfig(), device=None, mesh=None) -> None:
        """``mesh``: the shards' devices (:func:`make_mesh`); ``device``
        alone is a one-shard mesh on that device; neither is every visible
        card, one shard each (without a card this raises)."""
        if mesh is None:
            mesh = [resolve_device(device)] if device is not None else make_mesh()
        else:
            mesh = [resolve_device(d) for d in mesh]
            if not mesh:
                raise ValueError("a mesh needs at least one device")
            if device is not None and resolve_device(device) != mesh[0]:
                raise ValueError(f"device {device} is not the mesh's first device {mesh[0]}")
        self.mesh = mesh
        self.n_shards = len(mesh)
        self.device = mesh[0]
        self.config = config
        self._wrap_programs()
        # each step variant's captured graph per lane count and shard (on a
        # card); a capture is a compile of the variant's program
        self.graphs = StepGraphs(on_capture=_capture_counter(self._step))
        self.states = self._p["spmd_init"](config, self.mesh)
        # the per-shard device LinkContexts of the current write_version
        self._ctx_cache = (-1, None)
        # exact host counters (the device counters are u32 and wrap)
        self.host_counters = {
            "spans": 0, "spansWithDuration": 0, "spansWithError": 0,
            "batches": 0, "sampledKept": 0, "sampledDropped": 0,
        }
        # guards every touch of self.states; reentrant (reads nest); its
        # contention ledger feeds the query plane
        self.lock = querytrace.InstrumentedRLock(name="agg")
        # host mirror of pend_pos: the flush runs before a batch that
        # would overflow the pending buffer
        self._pend_lanes = 0
        # lanes written since the last rollup: the rollup runs before a
        # batch would push this past rollup_segment (R/2), so no span is
        # overwritten before its links are folded
        self._lanes_since_rollup = 0
        # ring-resident time ranges (ts_lo, ts_hi, per-shard cursors
        # before), popped once every shard's cursor has advanced a full
        # ring past the batch
        self._resident: deque = deque()
        self._shard_cursor = np.zeros(self.n_shards, np.int64)
        # highest time-tier bucket epoch ingest has touched (-1: none); the
        # sealer seals the epochs below it
        self._tt_max_epoch = -1
        self.read_stats = {"rolled_only_reads": 0, "ctx_reads": 0, "host_transfers": 0}
        self.ctx_stats = {"ctx_advances": 0, "ctx_maintenance_ms": 0.0}
        # bumped on every query-visible state change (step, rollup)
        self.write_version = 0
        # write-ahead log seam: when set, every batch (its kept lanes, with
        # a sampler) and every explicit flush/rollup is logged under the
        # lock, and wal_seq holds the last sequence folded into the state
        self.wal_hook = None
        self.wal_seq = 0
        # host reference sampler (HostSampler): scores every batch over
        # the tables the step read, feeds the controller's tallies and
        # compacts what the WAL keeps
        self.sampler = None

    def _wrap_programs(self) -> None:
        """Every device entry point of this aggregator, wrapped in the
        device observatory under the reference's program name. Each takes
        the list of per-shard states (and per-shard link contexts), runs
        the single-shard program on every shard and merges on the first
        shard's device."""
        cfg = self.config

        # one shard's step program of each variant (flush due, rollup due)
        shard_programs = {(f, r): shard_program(cfg, f, r) for f in (False, True) for r in (False, True)}
        self._programs = shard_programs

        def step(need_flush, need_rollup):
            variant = (need_flush, need_rollup)
            program = shard_programs[variant]

            def run(states, wires, graphs):  # zt-in-place: states — each shard's state is stepped in place
                for shard, (state, wire) in enumerate(zip(states, wires)):
                    if state.hll.device.type == "cuda":
                        graphs.step(variant, shard, state, wire, program)
                    else:
                        program(state, u32.upload_bits(wire, state.hll.device))
                return states
            return run

        def each(fn):
            return lambda states: [fn(s) for s in states]

        def counts(states):
            return psum([histogram.total_count(s.hist) for s in states])

        def merge(states):
            return readpack.pack(
                (psum([s.hist for s in states]), pmax([s.hll for s in states]),
                 psum([s.counters for s in states])), (np.uint32, np.uint8, np.uint32))

        def quant_digest(states, qarr):
            merged = digest_merge([s.digest for s in states])
            return readpack.pack((tdigest.quantile(merged, qarr), counts(states)),
                                 (np.float32, np.uint32))

        def quant_hist(states, qarr):
            merged = psum([s.hist for s in states])
            return readpack.pack((histogram.quantile(merged, qarr), histogram.total_count(merged)),
                                 (np.float32, np.uint32))

        def windowed(states, lo, hi):
            return psum([ing.windowed_hist(cfg, s, lo, hi) for s in states])

        def quant_whist(states, qarr, lo, hi):
            merged = windowed(states, lo, hi)
            return readpack.pack((histogram.quantile(merged, qarr), histogram.total_count(merged)),
                                 (np.float32, np.uint32))

        def whist(states, lo, hi):
            return readpack.pack((windowed(states, lo, hi),), (np.uint32,))

        def card(states):
            return readpack.pack((hll.estimate(pmax([s.hll for s in states])),), (np.float32,))

        def overview(states, qarr):
            merged = digest_merge([s.digest for s in states])
            est = hll.estimate(pmax([s.hll for s in states]))
            return readpack.pack((tdigest.quantile(merged, qarr), counts(states), est),
                                 (np.float32, np.uint32, np.float32))

        def digest_read(states):
            # each shard's pending points folded into a local partial (the
            # state untouched), then the cross-shard recluster
            return readpack.pack((digest_merge([
                ing._flush_pending_digest(cfg, s.digest, s.pend_key, s.pend_val)
                for s in states]),), (np.float32,))

        def link_parts(states, ctxs, lo, hi):
            parts = [ing.dependency_links(cfg, s, lo, hi, ctx=c) for s, c in zip(states, ctxs)]
            return psum([p[0] for p in parts]), psum([p[1] for p in parts])

        def links(states, ctxs, lo, hi):
            return readpack.pack(link_parts(states, ctxs, lo, hi), (np.uint32, np.uint32))

        # no closure here may hold self: the wrapped programs live on self
        # (a cycle would keep a dropped aggregator's state until the
        # cycle collector runs)
        n_edges = min(4096, cfg.max_services ** 2)

        def edges_rolled(states, lo, hi):
            parts = [ing.rolled_links(cfg, s, lo, hi) for s in states]
            return readpack.pack(
                _edge_topk(psum([p[0] for p in parts]), psum([p[1] for p in parts]), n_edges),
                (np.int32, np.uint32, np.uint32))

        def edges_fresh(states, ctxs, lo, hi):
            return readpack.pack(_edge_topk(*link_parts(states, ctxs, lo, hi), n_edges),
                                 (np.int32, np.uint32, np.uint32))

        def ttread(states, ctxs, lo_ep, hi_ep):
            parts = [ing.tt_sketches(cfg, s, lo_ep, hi_ep, ctx=c) for s, c in zip(states, ctxs)]
            ep, regs, digest, calls, errs = (list(x) for x in zip(*parts))
            return readpack.pack(
                (pmax(ep), pmax(regs), digest_merge(digest), psum(calls), psum(errs)),
                (np.int32, np.uint8, np.float32, np.uint32, np.uint32))

        programs = {
            "spmd_init": lambda config, mesh: [init_state(config, d) for d in mesh],
            "spmd_flush": each(lambda s: ing.flush_digest(cfg, s)),
            "spmd_rollup": each(lambda s: ing.rollup_step(cfg, s)),
            "spmd_link_ctx": each(lambda s: ing.fresh_link_context(cfg, s)),
            "spmd_snap_copy": each(lambda s: AggState(*(t.clone() for t in s))),
            "spmd_merge": merge,
            "spmd_quant_digest": quant_digest, "spmd_quant_hist": quant_hist,
            "spmd_quant_whist": quant_whist, "spmd_whist": whist, "spmd_card": card,
            "spmd_overview": overview, "spmd_digest_read": digest_read, "spmd_links": links,
            "spmd_edges_rolled": edges_rolled, "spmd_edges_fresh": edges_fresh,
            "spmd_ttread": ttread,
        }
        self._p = {name: OBSERVATORY.wrap(name, fn, device=self.device)
                   for name, fn in programs.items()}
        # the step's variants by (flush due, rollup due), as the reference's
        # zt-in-place: states — every variant steps the states in place
        self._step = {
            (f, r): OBSERVATORY.wrap("spmd_step" + ("_flush" if f else "") + ("_rollup" if r else ""),
                                     step(f, r), device=self.device)
            for f in (False, True) for r in (False, True)
        }

    # -- write path ------------------------------------------------------

    def ingest(self, cols: SpanColumns) -> None:
        """Route one host batch across the shards by trace hash and fold it
        in (one shard: the wire image is the batch's packing)."""
        live_ts = cols.ts_min[cols.valid]
        t0 = time.perf_counter()
        routed = route_fused(cols, self.n_shards)
        obs.record("route", time.perf_counter() - t0)
        self.ingest_fused(
            routed,
            n_spans=int(cols.valid.sum()),
            n_dur=int((cols.valid & cols.has_dur).sum()),
            n_err=int((cols.valid & cols.err).sum()),
            ts_range=(int(live_ts.min()), int(live_ts.max())) if live_ts.size else (0, 0),
        )

    @property
    def lane_cap(self) -> int:
        """Hard lane ceiling of one fused batch."""
        return min(self.config.digest_buffer, self.config.rollup_segment)

    def ingest_fused(self, fused: np.ndarray, n_spans: int, n_dur: int, n_err: int,
                     ts_range=None) -> None:  # zt-dispatch-critical: the per-chunk device entry point — one host→device copy per shard + one step program under the state lock
        """Fold one routed wire image ``[S, 11, per]`` (u32) into the
        states, shard ``s``'s slice into ``states[s]``; the caller supplies
        the live/duration/error counts. Every shard steps, one that got no
        live lane included (its batch counter, pending cursor and slice
        epochs advance as the reference's do)."""
        if fused.ndim != 3 or fused.shape[0] != self.n_shards or fused.shape[1] != 11:
            raise ValueError(f"expected a [{self.n_shards}, 11, n] wire image, got {fused.shape}")
        lanes = int(fused.shape[-1])
        if lanes > self.lane_cap:
            raise ValueError(
                f"batch of {lanes} lanes/shard exceeds digest_buffer "
                f"({self.config.digest_buffer}) or rollup_segment "
                f"({self.config.rollup_segment}); chunk before ingest"
            )
        live_per_shard = (fused[:, 10, :] & 1).sum(axis=1, dtype=np.int64)
        with self.lock:
            # the contention ledger's holder: this hold is the write path
            self.lock.relabel("ingest_fused")
            need_flush = self._pend_lanes + lanes > self.config.digest_buffer
            need_rollup = self._lanes_since_rollup + lanes > self.config.rollup_segment
            if (0 if need_flush else self._pend_lanes) + lanes > self.config.digest_buffer:
                raise AssertionError("pending digest buffer would overflow")
            t0 = time.perf_counter()
            self._step[(need_flush, need_rollup)](self.states, fused, self.graphs)
            # the host wall of the step: its host work and its launches
            # (the device runs them after this returns)
            step_wall = time.perf_counter() - t0
            obs.record("device_dispatch", step_wall)
            if need_flush:
                self._pend_lanes = 0
            if need_rollup:
                self._lanes_since_rollup = 0
                self.ctx_stats["ctx_advances"] += 1
                self.ctx_stats["ctx_maintenance_ms"] = step_wall * 1000.0
                obs.record("rollup", step_wall)
            self._pend_lanes += lanes
            self._lanes_since_rollup += lanes
            self.write_version += 1
            c = self.host_counters
            c["spans"] += n_spans
            c["spansWithDuration"] += n_dur
            c["spansWithError"] += n_err
            c["batches"] += 1
            lo, hi = ts_range if ts_range is not None else (0, (1 << 32) - 1)
            if n_spans > 0 and self.config.timetier_enabled and ts_range is not None:
                self._tt_max_epoch = max(self._tt_max_epoch, int(hi) // self.config.time_bucket_minutes)
            if n_spans > 0:
                self._resident.append((lo, hi, self._shard_cursor.copy()))
                self._shard_cursor = self._shard_cursor + live_per_shard
            # zt-lint: disable=ZT09 — per RETIRED resident range (ring-wrap bookkeeping, one pop per overwritten batch), never per span
            while self._resident and (
                (self._shard_cursor - self._resident[0][2]).min() >= self.config.ring_capacity
            ):
                self._resident.popleft()
            if self.sampler is not None:
                # the host verdicts over the tables the step just read (both
                # under this lock, so a publish never straddles a batch)
                keep2d = self.sampler.verdict_fused(fused)
                seen_b, kept_b = self.sampler.observe(fused, keep2d)
                c["sampledKept"] += kept_b
                c["sampledDropped"] += seen_b - kept_b
                if self.wal_hook is not None:
                    compacted = self.sampler.compact_fused(fused, keep2d)  # zt-lint: disable=ZT09 — per SHARD (mesh-sized) fancy-index gather; the per-lane work inside is vectorized
                    if compacted is not None:
                        cf, k_spans, k_dur, k_err, k_ts = compacted
                        # pre-compaction tallies restore the host counters
                        # on replay
                        self.wal_seq = self.wal_hook(
                            cf, k_spans, k_dur, k_err, k_ts,
                            extra={"seen": seen_b, "kept": kept_b,
                                   "seen_dur": n_dur, "seen_err": n_err},
                        )
            elif self.wal_hook is not None:
                self.wal_seq = self.wal_hook(fused, n_spans, n_dur, n_err, ts_range)

    def ingest_fused_multi(self, parts, n_spans: int, n_dur: int, n_err: int,
                           ts_range=None, pad_to_multiple: int = 256) -> None:  # zt-dispatch-critical: the coalesced multi-chunk device entry point
        """Coalesce ``(fused, svc_map, key_map)`` chunk images into one
        bucket-padded batch (the :func:`lane_bucket` ladder keeps shapes
        few) and fold it with one step."""
        if len(parts) == 1:
            fused, svc_map, key_map = parts[0]
            t0 = time.perf_counter()
            remap_fused(fused, svc_map, key_map)
            obs.record("mp_lut_remap", time.perf_counter() - t0)
            self.ingest_fused(fused, n_spans, n_dur, n_err, ts_range)
            return
        # zt-lint: disable=ZT09 — per CHUNK of the coalesced run (bounded
        # by coalesce_max), integer shape reads only
        total = sum(int(p[0].shape[-1]) for p in parts)
        cap = self.lane_cap
        if total > cap:
            raise ValueError(
                f"coalesced run of {total} lanes/shard exceeds the lane "
                f"cap ({cap}); the planner must split the run"
            )
        bucket = ing.lane_bucket(total, pad_to_multiple, cap)
        shards, rows = parts[0][0].shape[0], parts[0][0].shape[1]
        t0 = time.perf_counter()
        out = np.zeros((shards, rows, bucket), np.uint32)
        concat_remap(parts, out)
        obs.record("coalesce", time.perf_counter() - t0)
        self.ingest_fused(out, n_spans, n_dur, n_err, ts_range)

    def set_sampler_tables(self, rate: np.ndarray, tail: np.ndarray, link: np.ndarray) -> None:
        """Publish host-computed sampling tables into every shard's table
        leaves under the lock; every later step scores against them.
        Verdicts gate retention only, so write_version stays."""
        with self.lock:
            for s, d in zip(self.states, self.mesh):
                s.s_rate.copy_(u32.from_numpy(rate, d))
                s.s_tail.copy_(u32.from_numpy(tail, d))
                s.s_link.copy_(u32.from_numpy(link, d))

    @property
    def states(self) -> List[AggState]:
        """The per-shard states (shard ``s`` on ``mesh[s]``)."""
        return self._states

    @states.setter
    def states(self, states: List[AggState]) -> None:
        """Replace the per-shard states wholesale: the captured step graphs
        read the old leaves' addresses, so they go with them."""
        self.graphs.drop()
        self._states = states

    def load_states(self, leaves) -> None:
        """Copy the reference's leaves (with the leading shard axis, as
        ``state_arrays()`` gives them) into the live states under the lock,
        keeping every leaf's storage (a snapshot restore), then re-derive
        the host bookkeeping (:meth:`sync_pend_lanes`)."""
        with self.lock:
            convert.state_from_numpy(leaves, self.config, mesh=self.mesh, into=self.states)
            self.sync_pend_lanes()

    # -- maintenance -----------------------------------------------------

    def _flush_now(self) -> None:
        """Flush the pending digest buffer (callers hold the lock). Query
        invisible, so write_version stays."""
        self._p["spmd_flush"](self.states)
        self._pend_lanes = 0
        self._wal_marker("ttflush")

    def _wal_marker(self, tag: str) -> None:  # zt-lint: disable=ZT04 — called from _flush_now/rollup_now, both under self.lock (same critical section as the state swap being recorded)
        """Log a zero-lane WAL record at an explicit flush or rollup
        (callers hold the lock): digest folding depends on where flushes
        fall, so replay re-applies them at the same stream position."""
        if self.wal_hook is not None and self.config.timetier_enabled:
            self.wal_seq = self.wal_hook(
                np.zeros((self.n_shards, 11, 0), np.uint32), 0, 0, 0, (0, 0), extra={tag: 1})

    def flush_now(self) -> None:
        with self.lock:
            self._flush_now()

    def rollup_now(self) -> None:
        """Run the link rollup (which also advances the link ctx)."""
        with self.lock:
            t0 = time.perf_counter()
            self._p["spmd_rollup"](self.states)
            self._lanes_since_rollup = 0
            self.ctx_stats["ctx_advances"] += 1
            self.ctx_stats["ctx_maintenance_ms"] = (time.perf_counter() - t0) * 1000.0
            self.write_version += 1
            self._wal_marker("ttroll")

    def capture_steps(self, lane_counts) -> int:
        """Capture every step variant of every shard at each of
        ``lane_counts`` lanes a shard, running nothing on the states (a
        store or server calls this at boot, so no capture lands in a
        serving window); returns the graphs captured. On the CPU there is
        nothing to capture. From then on a capture a step has to make is
        a recompile."""
        with self.lock:
            before = self.graphs.captures
            for lanes in lane_counts:
                if not 0 < lanes <= self.lane_cap:
                    raise ValueError(f"{lanes} lanes a shard: outside (0, {self.lane_cap}]")
                for shard, state in enumerate(self.states):
                    if state.hll.device.type == "cuda":
                        for variant, program in self._programs.items():
                            self.graphs.capture(variant, shard, state, lanes, program)
            self.graphs.booted = True
            return self.graphs.captures - before

    def warm_programs(self, cols: SpanColumns) -> None:
        """Run every maintenance combination the ingest loop can take
        (step alone, with a flush, with a rollup, with both), then the
        standalone rollup and flush, on a real batch, and wait for the
        device: first-use costs (allocator growth, kernel build, each step
        variant's graph capture at this batch's lane count) land here and
        not in a timed or serving window. Ingests ``cols`` four times."""
        for force_flush, force_rollup in ((False, False), (True, False), (False, True), (True, True)):
            with self.lock:
                if force_flush:
                    self._pend_lanes = self.config.digest_buffer
                if force_rollup:
                    self._lanes_since_rollup = self.config.rollup_segment
            self.ingest(cols)
        self.rollup_now()
        self.flush_now()
        self.block_until_ready()

    # -- reads -----------------------------------------------------------
    #
    # Every read below ends in exactly one device->host transfer: its
    # program packs its outputs on the device into one buffer
    # (readpack.pack) and self._pull makes the one counted
    # readpack.device_get.

    def _pull(self, packed) -> list:
        """THE read path's device->host pull (callers hold the lock): one
        counted transfer of a read program's packed buffer, then zero-copy
        numpy views of the sections."""
        self.read_stats["host_transfers"] += 1
        if querytrace.active() is not None:
            # a traced query splits its device wall (launches done -> the
            # buffer ready) from the transfer; the pull below would wait
            # for the same work (a CPU tensor is ready when made)
            t0 = time.perf_counter_ns()
            if packed.device.type == "cuda":
                # zt-lint: disable=ZT06 — measurement IS the contract: only
                # a traced query takes this branch, and the pull below would
                # block identically; the split makes device wall observable
                torch.cuda.current_stream(packed.device).synchronize()
            querytrace.stamp_active(querytrace.QSEG_DEVICE_WALL, t0, time.perf_counter_ns())
        return readpack.pull(packed)

    def _quantile_list(self, qs) -> torch.Tensor:
        """The read's quantile list on the state's device. It goes up from
        pinned memory without waiting for the stream, so the read's one
        sync is its pull: a pageable upload would block on the work queued
        before it."""
        q = torch.tensor(np.asarray(qs, np.float32))
        if self.device.type == "cuda":
            q = q.pin_memory()
        return q.to(self.device, non_blocking=True)

    def quantiles(self, qs, source: str = "digest", ts_lo_min: Optional[int] = None,
                  ts_hi_min: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
        """([K, Q] quantiles, [K] counts); ``source`` "digest" or "hist";
        a (ts_lo_min, ts_hi_min) window reads the time-sliced histograms."""
        if (ts_lo_min is None) != (ts_hi_min is None):
            raise ValueError(
                "ts_lo_min and ts_hi_min must be given together "
                f"(got ts_lo_min={ts_lo_min!r}, ts_hi_min={ts_hi_min!r})"
            )
        qarr = self._quantile_list(qs)
        with self.lock:
            if ts_lo_min is not None:
                packed = self._p["spmd_quant_whist"](self.states, qarr, ts_lo_min, ts_hi_min)
            elif source == "digest":
                if self._pend_lanes:
                    self._flush_now()  # flush-then-read
                packed = self._p["spmd_quant_digest"](self.states, qarr)
            else:
                packed = self._p["spmd_quant_hist"](self.states, qarr)
            q, n = self._pull(packed)
            return q, n

    def windowed_histograms(self, ts_lo_min: int, ts_hi_min: int) -> np.ndarray:
        with self.lock:
            (out,) = self._pull(self._p["spmd_whist"](self.states, ts_lo_min, ts_hi_min))
            return out

    def cardinalities(self) -> np.ndarray:
        """[S+1] HLL distinct-trace estimates (last row global)."""
        with self.lock:
            (est,) = self._pull(self._p["spmd_card"](self.states))
            return est

    def sketch_overview(self, qs) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """([K, Q] digest quantiles, [K] counts, [S+1] HLL estimates)."""
        qarr = self._quantile_list(qs)
        with self.lock:
            if self._pend_lanes:
                self._flush_now()
            q, n, est = self._pull(self._p["spmd_overview"](self.states, qarr))
            return q, n, est

    def merged_digest(self) -> np.ndarray:
        """[K, C, 2] digest with the pending points folded in — a pure
        read: the state is left untouched."""
        with self.lock:
            (out,) = self._pull(self._p["spmd_digest_read"](self.states))
            return out

    def merged_sketches(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(hist [K, B] u32, hll [S+1, m] u8, counters u32) merged over the
        shards (sums and the register max) in one pull."""
        with self.lock:
            hist, hll_regs, counters = self._pull(self._p["spmd_merge"](self.states))
            return hist, hll_regs, counters

    def _link_context_cached(self):
        """Per-shard device LinkContexts for the current states (callers
        hold the lock)."""
        if self._ctx_cache[0] != self.write_version:
            t0 = time.perf_counter()
            self._ctx_cache = (self.write_version, self._p["spmd_link_ctx"](self.states))
            obs.record("ctx_advance", time.perf_counter() - t0)
        return self._ctx_cache[1]

    def dependency_matrices(self, ts_lo_min: int, ts_hi_min: int) -> Tuple[np.ndarray, np.ndarray]:
        with self.lock:
            calls, errors = self._pull(self._p["spmd_links"](
                self.states, self._link_context_cached(), ts_lo_min, ts_hi_min))
            return calls, errors

    def window_fully_rolled(self, ts_lo_min: int, ts_hi_min: int) -> bool:
        """True when no ring-resident span's timestamp can fall in the
        window: the rollup matrices alone then answer it exactly."""
        with self.lock:
            return all(ts_hi_min < lo or ts_lo_min > hi for lo, hi, _ in self._resident)

    def dependency_edges(self, ts_lo_min: int, ts_hi_min: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(flat_index, calls, errors) [E] — the nonzero cells of the
        link matrix over the window, compacted on the device. Windows no
        ring-resident span can touch read the rollups alone; a fresh read
        (first after a write) builds and caches the delta link ctx."""
        with self.lock:
            if self.window_fully_rolled(ts_lo_min, ts_hi_min):
                self.read_stats["rolled_only_reads"] += 1
                packed = self._p["spmd_edges_rolled"](self.states, ts_lo_min, ts_hi_min)
            else:
                self.read_stats["ctx_reads"] += 1
                packed = self._p["spmd_edges_fresh"](
                    self.states, self._link_context_cached(), ts_lo_min, ts_hi_min)
            idx, c, e = self._pull(packed)
            return idx, c, e

    def tt_read(self, lo_ep: int, hi_ep: int):
        """(slot_epochs [W] i32, hll_regs [S+1, m] u8, digest [K, Cw, 2]
        f32, calls [S, S] u32, errs [S, S] u32) for the bucket-epoch range
        ``[lo_ep, hi_ep]`` in one pull: the time tier's seal read
        (``lo == hi``) and its unsealed-suffix read. The pending digest
        points are flushed first, so the bucket digests hold every point."""
        with self.lock:
            if self._pend_lanes:
                self._flush_now()
            ep, regs, digest, calls, errs = self._pull(self._p["spmd_ttread"](
                self.states, self._link_context_cached(), int(lo_ep), int(hi_ep)))
            return ep, regs, digest, calls, errs

    @property
    def tt_max_epoch(self) -> int:
        """Highest bucket epoch ingest has touched (-1: none yet)."""
        return self._tt_max_epoch

    # -- state -----------------------------------------------------------

    def sync_pend_lanes(self) -> None:
        """Re-derive the host bookkeeping from the device states after
        ``states`` was replaced wholesale (snapshot restore): one packed
        pull of every shard's ``pend_pos`` and, with the tier, ``tb_epoch``
        (the max over shards of each)."""
        with self.lock:
            lanes = [s.pend_pos.reshape(-1).to(self.device) for s in self.states]
            if self.config.timetier_enabled:
                lanes += [s.tb_epoch.reshape(-1).to(self.device) for s in self.states]
            (packed,) = readpack.pull(readpack.pack((torch.cat(lanes),), (np.int32,)))
            n_pend = sum(s.pend_pos.numel() for s in self.states)
            self._pend_lanes = int(packed[:n_pend].max())
            # the write distance since the last rollup is not in the state:
            # assume the worst so the next batch rolls up first
            self._lanes_since_rollup = self.config.rollup_segment
            # restored ring content has unknown timestamps: one entry that
            # covers every window until a full ring of writes displaces it
            self._resident.clear()
            self._resident.append((0, (1 << 32) - 1, self._shard_cursor.copy()))
            if self.config.timetier_enabled:
                self._tt_max_epoch = int(packed[n_pend:].max())
            self.write_version += 1

    def state_clone(self):
        """(device clone of every shard's state, wal_seq, host_counters
        copy), all taken under the lock: one instant for a snapshot. The
        clone is the list of per-shard states, one for a one-shard mesh.
        Callers copy the clone to the host without the lock while ingest
        goes on."""
        with self.lock:
            clone = self._p["spmd_snap_copy"](self.states)
            return clone, self.wal_seq, dict(self.host_counters)

    def state_arrays(self) -> list:
        """Host copy of every state leaf with the reference's dtypes and a
        leading shard axis of S (one on a one-shard mesh), the reference's
        layout, from one :meth:`state_clone`."""
        clone, _, _ = self.state_clone()
        return convert.state_to_numpy(clone)

    def block_until_ready(self) -> None:
        for d in dict.fromkeys(self.mesh):
            if d.type == "cuda":
                with CAPTURE_LOCK:  # never inside another thread's capture (tpu/graphs.py)
                    torch.cuda.synchronize(d)

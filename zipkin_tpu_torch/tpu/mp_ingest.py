"""Multi-process parse fan-out feeding the one dispatcher that owns the
card (the port of ``zipkin_tpu/tpu/mp_ingest.py``).

Under CPython one process cannot parse at line rate and feed the device
too: the parse holds the GIL, and so does the host dispatch of the ingest
step. This tier moves the parse into processes, as the reference's
collectors scale with Kafka partitions:

- **N parse workers** (``spawn``; they never import torch): raw JSON v2 or
  proto3 bytes -> native C parse with LOCAL vocab interning -> columnar
  pack -> ``route_fused`` -> the packed 11-row wire image written straight
  into a shared-memory span-ring slot (:mod:`zipkin_tpu_torch.tpu.ring`)
  with the chunk's pickled sidecar (vocab journal, archive slices, disk
  record).
- **One dispatcher thread** (in the owning process, the only one that
  touches the card): drains contiguous runs of ready slots per stripe,
  replays each chunk's vocab journal into the GLOBAL vocab, then flushes
  completed payloads in **coalesced groups**: up to ``coalesce_max``
  chunks (bounded by the aggregator's lane cap) become one
  ``concat_remap`` gather into a ``lane_bucket`` image, one
  ``ingest_fused_multi`` step (one ``update_step`` launch) and one WAL
  record, acked together. The WAL append and the sampling verdicts ride
  the aggregator's step on this side, so ack-after-durability is the
  synchronous path's. Remapping worker-local ids to global ones is what
  lets workers intern without a lock.

Ordering across the two channels (ring slots for images; the result queue
for oversized sidecars, parser punts and EOF) is pinned by a per-worker
chunk sequence number: the dispatcher applies a worker's chunks strictly
in ``wseq`` order, so a payload's chunks and vocab deltas replay in the
order the worker produced them.

Backpressure: a full stripe stalls its worker's blocking ``claim()``, the
stalled worker stops pulling from its bounded delivery queue, and the
queue fills. ``submit(..., block=False)`` (the server boundary's mode)
raises :class:`IngestBackpressure` only when every live worker's queue is
full; the HTTP server answers it with 429.

Zero-loss worker death: the dispatcher keeps every submitted payload until
its results are APPLIED and buffers a payload's chunks until its last one
arrives. A worker that dies mid-payload loses nothing: its stripe is
reclaimed (published slots discarded, the torn slot a SIGKILL leaves reset
by the pid guard), its buffered chunks are dropped, and every payload it
owned re-ingests on the slow path (the object path). The pool keeps
serving on the survivors; only a dead dispatcher surfaces as an error.

The sampled archive: workers extract the same trace-affine 1/N span
slices the synchronous line-rate path archives, which the dispatcher
decodes into the host archive; with a disk archive the workers ship
per-chunk records whose ids the dispatcher remaps to global ones.

The flight recorder: the dispatcher stamps ``mp_vocab_replay``,
``mp_shm_copy``, ``mp_device_feed`` and, at each payload's ack,
``mp_record`` (its consume time plus its span-weighted share of the group
flushes); the workers' ``parse``, ``pack`` and ``route`` seconds ride each
chunk and are relayed into the recorder (histogram only), besides the
plain counters of :meth:`MultiProcessIngester.stats`. An attached
``shadow`` is offered every flushed chunk image.

The critical-path tracer (:mod:`zipkin_tpu_torch.obs.critpath`, with
``critpath_slots`` > 0): ``submit()`` claims a ledger slot for a payload
that carries a wire anchor (``critpath.WIRE_T0_NS``) and stamps its
enqueue; the worker stamps parse, pack, route and ring wait into the slot's
worker region (the slot rides the queue item and the ring's critical-path
word); the dispatcher stamps the journal replay, the shm copy, the device
feed (with the WAL's append and fsync inside it, through
``critpath.set_active``) and acks the slot once the payload is durable. The
stitcher (``.critpath``) folds the slots on the server's windows ticker. A
fallback or a reaped worker abandons its payloads' slots.

Tenants: ``submit(..., tenant=)`` interns the boundary's tenant id into a
bounded table (past ``_tenant_max`` names a tenant falls back to the default
index 0); the index rides the queue item, the ring slot's tenant word and
the critical-path slot, explicitly and never through a contextvar across
threads. At ack the dispatcher tallies each tenant's payloads and spans
(``mpTenantTable`` in :meth:`MultiProcessIngester.stats`) and calls
``tenant_sink(tenant, spans)`` (the admission table's retained-spans
charge); a ``feed.latency`` fault armed for one tenant stalls only its
groups. Admission itself sheds at the collector, before ``submit``.
"""

from __future__ import annotations

import logging
import multiprocessing as mp
import queue
import threading
import time
from typing import Dict, List, Optional, Set

import numpy as np

from zipkin_tpu_torch import faults, obs
from zipkin_tpu_torch.obs import critpath as _critpath
from zipkin_tpu_torch.tpu import ring as ring_mod

logger = logging.getLogger(__name__)

# worker -> dispatcher result-queue message kinds. Chunk images travel
# through the span ring; the queue carries what cannot ride a bounded slot
# (oversized sidecars, empty-payload completions), the parser punts and EOF.
_KIND_BATCH = 0      # (kind, widx, pid, wseq, fused|None, n_spans, n_dur,
#                       n_err, dropped, svc_new, name_new, pairs_new,
#                       arch, ts_range, rec, parse_s, pack_s, route_s)
_KIND_FALLBACK = 1   # (kind, widx, pid, wseq)
_KIND_EOF = 2        # (kind, widx)
_KIND_NUDGE = 3      # (kind,): wakeup only, a ring slot was published


class IngestBackpressure(RuntimeError):
    """A payload was refused: every live parse worker's delivery queue is
    full in ``submit(..., block=False)``, the admission chokepoint shed it
    (a tenant's budget or the global brownout ladder), or an injected
    allocation failure fired at the collector. The HTTP server answers 429
    (the throttle's shed stays 503) with backoff guidance and the shedding
    ``scope``: ``tenant`` (that tenant is limited, with a delay from its
    own budget) or ``global`` (the system is browning out)."""

    def __init__(self, msg: str = "", *, scope: str = "global", tenant: Optional[str] = None,
                 retry_after_s: Optional[float] = None) -> None:
        super().__init__(msg)
        self.scope = scope
        self.tenant = tenant
        self.retry_after_s = retry_after_s


def _worker_main(widx: int, work_q, result_q, ring_params: dict, params: dict) -> None:
    """Parse worker entry point (a spawned process). It and every module it
    imports are numpy, the standard library and the native parser's shared
    library; the build the parent made is loaded, never rebuilt."""
    from zipkin_tpu_torch import native
    from zipkin_tpu_torch.obs.critpath import (
        SEG_PACK,
        SEG_PARSE,
        SEG_RING_WAIT,
        SEG_ROUTE,
        CritPathWorkerView,
    )
    from zipkin_tpu_torch.tpu.archive import parsed_record
    from zipkin_tpu_torch.tpu.columnar import Vocab, pack_parsed, route_fused, sample_slices
    from zipkin_tpu_torch.tpu.ring import RingProducer, pack_aux

    prod = RingProducer(ring_params, widx)
    cp_params = params.get("critpath")
    cview = CritPathWorkerView(cp_params, widx) if cp_params is not None else None
    vocab = Vocab(params["max_services"], params["max_keys"])
    nvocab = native.NativeVocab(vocab) if native.available() else None
    n_shards = params["n_shards"]
    max_batch = params["max_batch"]
    pad = params["pad"]
    every = params["archive_every"]
    disk = params["archive_disk"]  # ship per-chunk records (worker-local ids)
    boundary = params["sample_boundary"]  # None: keep everything
    # journal cursors: how much of the local vocab has been reported
    sent_svc, sent_name, sent_pair = 1, 1, 1

    def handle(pid: int, payload: bytes, state: dict, cslot: int, tidx: int) -> None:
        nonlocal sent_svc, sent_name, sent_pair
        traced = cview is not None and cslot >= 0
        if traced:
            # a per-payload recalibration keeps the clock bridge fresh; the
            # stamps below reuse the stage timings' perf_counter readings
            cview.calibrate()
        t0 = time.perf_counter()
        # the parser sniffs the wire format: JSON v2 and proto3 both land here
        parsed = native.parse_spans(payload, nvocab=nvocab) if nvocab is not None else None
        if parsed is None:
            # the object path needs Span objects: punt to the dispatcher,
            # which still holds the payload's bytes
            state["completed"] = True
            result_q.put((_KIND_FALLBACK, widx, pid, prod.next_wseq()))
            return
        nvocab.sync()
        n = parsed.n
        dropped = 0
        if boundary is not None and n:
            keep = native.sampler_keep(parsed, n, boundary)
            dropped = int(n - keep.sum())
            if dropped:
                parsed = parsed.select(np.nonzero(keep)[0])
                n = parsed.n
        parse_s = time.perf_counter() - t0
        if traced:
            cview.stamp(cslot, SEG_PARSE, int(t0 * 1e9), int((t0 + parse_s) * 1e9))
        if n == 0:
            state["completed"] = True
            result_q.put((_KIND_BATCH, widx, pid, prod.next_wseq(), None, 0, 0, 0,
                          dropped, [], [], [], [], (0, 0), None, parse_s, 0.0, 0.0))
            return
        for lo in range(0, n, max_batch):
            hi = min(lo + max_batch, n)
            sub = parsed if (lo == 0 and hi == n) else parsed.select(slice(lo, hi))
            t1 = time.perf_counter()
            cols = pack_parsed(sub, vocab, pad)
            t2 = time.perf_counter()
            fused = route_fused(cols, n_shards)
            route_s = time.perf_counter() - t2
            pack_s = t2 - t1
            if traced:
                cview.stamp(cslot, SEG_PACK, int(t1 * 1e9), int(t2 * 1e9))
                cview.stamp(cslot, SEG_ROUTE, int(t2 * 1e9), int((t2 + route_s) * 1e9))
            arch = sample_slices(sub, every)  # the store's 1/N host-archive sample
            rec = parsed_record(sub) if disk else None
            # the vocab journal since the last report, in id order
            svc_new = vocab.services._names[sent_svc:]
            name_new = vocab.span_names._names[sent_name:]
            pairs_new = vocab._key_list[sent_pair:]
            sent_svc += len(svc_new)
            sent_name += len(name_new)
            sent_pair += len(pairs_new)
            n_spans = int(cols.valid.sum())
            n_dur = int((cols.valid & cols.has_dur).sum())
            n_err = int((cols.valid & cols.err).sum())
            live_ts = cols.ts_min[cols.valid]
            ts_range = (int(live_ts.min()), int(live_ts.max())) if live_ts.size else (0, 0)
            # -1 marks a continuation chunk: the dispatcher applies a payload
            # (and releases it from drain()) on its LAST chunk only; the
            # sampled-drop count rides that chunk
            is_last = hi == n
            if is_last:
                state["completed"] = True
            aux = pack_aux(svc_new, name_new, pairs_new, arch, rec)
            if fused.size <= prod.img_cap_u32 and len(aux) <= prod.aux_cap:
                ta = time.perf_counter()
                prod.claim()
                tb = time.perf_counter()
                if traced:
                    cview.stamp(cslot, SEG_RING_WAIT, int(ta * 1e9), int(tb * 1e9))
                prod.image(fused.size)[:] = fused.reshape(-1)
                # the wseq is taken at the last instant that cannot fail on
                # both channels, so a worker that survives an exception never
                # leaves a sequence gap that would stall the in-order pump
                prod.publish(
                    pidx=pid, wseq=prod.next_wseq(), per=int(fused.shape[-1]),
                    n_spans=n_spans, n_dur=n_dur, n_err=n_err,
                    dropped=dropped if is_last else -1,
                    cslot=cslot if traced else -1,
                    ts_min=ts_range[0], ts_max=ts_range[1],
                    parse_ns=int(parse_s * 1e9), pack_ns=int(pack_s * 1e9),
                    route_ns=int(route_s * 1e9), tenant=tidx, aux=aux,
                )
                # a publish carries no wakeup of its own: nudge the
                # dispatcher out of its backed-off idle wait
                result_q.put((_KIND_NUDGE,))
            else:
                # the sidecar outgrew the slot (a large disk record): the
                # whole chunk goes through the queue, ordered by its wseq
                result_q.put((_KIND_BATCH, widx, pid, prod.next_wseq(), fused,
                              n_spans, n_dur, n_err, dropped if is_last else -1,
                              svc_new, name_new, pairs_new, arch, ts_range, rec,
                              parse_s, pack_s, route_s))
            parse_s = 0.0  # the parse is billed once a payload

    try:
        while True:
            item = work_q.get()
            if item is None:
                break
            pid, payload, cslot, tidx = item
            state: dict = {"completed": False}
            try:
                handle(pid, payload, state, cslot, tidx)
            except Exception:  # keep the pool alive
                logging.getLogger(__name__).exception("mp-ingest worker %d failed on a payload", widx)
                if not state["completed"]:
                    # chunks apply only at the payload's last one, so the
                    # chunks it did ship were never applied: a whole-payload
                    # fallback cannot ingest twice
                    result_q.put((_KIND_FALLBACK, widx, pid, prod.next_wseq()))
    finally:
        result_q.put((_KIND_EOF, widx))
        prod.close()
        if cview is not None:
            cview.close()


class _IdMaps:
    """Worker-local -> global id tables, grown as journals arrive."""

    def __init__(self) -> None:
        self.svc = np.zeros(1, np.uint32)  # local id 0 -> global 0
        self.name = np.zeros(1, np.uint32)
        self.key = np.zeros(1, np.uint32)

    @staticmethod
    def _append(arr: np.ndarray, values: List[int]) -> np.ndarray:
        return np.concatenate([arr, np.asarray(values, np.uint32)]) if values else arr


class MultiProcessIngester:
    """Owns the worker pool, the span ring and the dispatcher thread.

    ``submit(payload)`` hands raw JSON v2 or proto3 bytes to one live worker
    and returns once the payload is accepted; ``submit(payload,
    block=False)`` raises :class:`IngestBackpressure` instead of blocking
    when every live worker is saturated. ``drain()`` blocks until every
    submitted payload has reached the card. ``coalesce_max`` bounds how
    many ready chunks one flush merges into one device step and WAL record;
    at 1 each chunk is its own step, as on the synchronous path.

    ``store`` is a :class:`zipkin_tpu_torch.tpu.store.TorchStorage` (or the
    resume adapter over it). ``metrics`` (collector-metrics shaped) counts
    spans as payloads land; ``sampler`` is the collector's boundary sampler.
    """

    def __init__(
        self,
        store,
        workers: int = 2,
        sampler=None,
        queue_depth: Optional[int] = None,
        metrics=None,
        ring_slots: int = 0,
        coalesce_max: int = 1,
        ring_aux_bytes: int = 1 << 20,
        critpath_slots: int = 0,
        critpath_reclaim_s: float = 60.0,
    ) -> None:
        from zipkin_tpu_torch import native
        from zipkin_tpu_torch.tpu.columnar import WIRE_ROWS

        # the parent builds (or finds) the native library before any worker
        # starts, so the workers load that build and never race to make it
        if not native.available():
            raise RuntimeError("native codec unavailable; the multi-process tier needs it")
        self.store = store
        self.workers = workers
        self.queue_depth = queue_depth or 2  # payloads a worker's queue holds
        self.coalesce_max = max(1, int(coalesce_max))
        self._sampler = sampler
        agg = store.agg
        self._n_shards = agg.n_shards
        self._wire_rows = WIRE_ROWS
        # worst case: every span of a max_batch chunk routes to one shard,
        # and route_fused rounds the per-shard lane count up to its 256 pad
        # multiple; the slots must cover the rounded bound or a near-full
        # chunk would spill past its image region
        per_cap = ((store.max_batch + 255) // 256) * 256
        img_cap_u32 = agg.n_shards * WIRE_ROWS * per_cap
        stripe = int(ring_slots) or 4  # slots a worker may publish ahead
        self._ring = ring_mod.SpanRing(workers, stripe, img_cap_u32, aux_cap=int(ring_aux_bytes))
        ctx = mp.get_context("spawn")
        # one bounded delivery queue per worker: the payload handoff and the
        # second backpressure surface (a frozen worker's stripe stays empty,
        # so ring occupancy alone would never push back on it)
        self._work_qs = [ctx.Queue(maxsize=self.queue_depth) for _ in range(workers)]
        self._result_q = ctx.Queue()
        has_disk = getattr(store, "_disk", None) is not None
        params = dict(
            max_services=store.vocab.services.capacity,
            max_keys=store.vocab.max_keys,
            n_shards=agg.n_shards,
            max_batch=store.max_batch,
            pad=store._pad,
            # workers build per-chunk disk records (worker-local ids) that
            # the dispatcher remaps and appends; the host sample then only
            # matters for autocomplete values, as on the synchronous path
            archive_disk=has_disk,
            archive_every=(store._fast_archive_every
                           if (not has_disk or store.autocomplete_keys) else 0),
            sample_boundary=(sampler._boundary
                             if sampler is not None and sampler.rate < 1.0 else None),
        )
        # the critical-path ledger, made before the pool spawns so workers
        # attach by name; the stitcher is .critpath, which the server puts
        # on its windows ticker and statusz reads
        self._cp_ledger = None
        self.critpath = None
        self._cslots: Dict[int, int] = {}  # payload id -> ledger slot, under _cv
        if critpath_slots > 0:
            self._cp_ledger = _critpath.CritPathLedger(workers, critpath_slots)
            self.critpath = _critpath.CritPathStitcher(
                self._cp_ledger, queue_capacity=workers * self.queue_depth,
                recorder=obs.RECORDER, reclaim_age_s=critpath_reclaim_s)
            params["critpath"] = self._cp_ledger.params()
        self._procs = [
            ctx.Process(target=_worker_main,
                        args=(w, self._work_qs[w], self._result_q, self._ring.params(), params),
                        daemon=True)
            for w in range(workers)
        ]
        for p in self._procs:
            p.start()
        self.metrics = metrics
        # the accuracy plane's tap (obs/shadow.py), set by the server
        self.shadow = None
        # tenant attribution: a bounded intern table maps the boundary's
        # tenant id to a small index (past the cap: 0, the default tenant);
        # _tenant_of maps a payload to its index, under _cv on submit and
        # on the dispatcher thread; the acked tallies are the dispatcher's.
        # tenant_sink(tenant, spans) is called on the dispatcher thread at
        # ack and must be thread-safe
        self._tenant_names: List[str] = ["default"]
        self._tenant_ids: Dict[str, int] = {"default": 0}
        self._tenant_max = 256
        self._tenant_of: Dict[int, int] = {}
        self._tenant_acked: Dict[str, Dict[str, int]] = {}
        self.tenant_sink = None
        self.counters = {
            "accepted": 0, "sampleDropped": 0, "fallbacks": 0, "rejected": 0,
            "coalescedBatches": 0, "coalescedChunks": 0, "groups": 0,
            "ringDiscarded": 0, "ringTorn": 0,
        }
        # host seconds by stage, in µs: the workers' parse, pack and route
        # (relayed with each chunk), and the dispatcher's journal replay,
        # device feed (ingest_fused_multi: gather, WAL, host dispatch) and
        # whole group flush. Mutated on the dispatcher thread only.
        self.stage_us = {"parse": 0, "pack": 0, "route": 0, "vocabReplay": 0,
                         "deviceFeed": 0, "flush": 0}
        # per-worker attribution (chunks carry widx); read lock-free by stats()
        self._wstats = [
            {"chunks": 0, "spans": 0, "payloads": 0, "parseUs": 0,
             "packUs": 0, "routeUs": 0, "fallbacks": 0}
            for _ in range(workers)
        ]
        # live per-worker occupancy (submitted minus finished) and its high
        # water mark, mutated under _cv
        self._qdepth = [0] * workers
        self._qhigh = [0] * workers
        self._ring_high = 0
        self._inflight = 0
        self._cv = threading.Condition()
        self._closed = False
        self._dispatch_error: Optional[BaseException] = None
        # payloads kept until APPLIED (zero-loss worker death): _pending
        # maps payload id -> bytes, _assigned -> the owning worker,
        # _buffered -> its chunks not yet applied. submit() (under _cv) and
        # the dispatcher mutate the first two; only the dispatcher the third.
        self._next_pid = 0
        self._rr = 0
        self._pending: Dict[int, bytes] = {}
        self._assigned: Dict[int, int] = {}
        self._buffered: Dict[int, list] = {}
        self._dead: Set[int] = set()
        self._maps: List[Optional[_IdMaps]] = [_IdMaps() for _ in range(workers)]
        # the in-order pump (dispatcher only): the next wseq per worker, and
        # queue messages that arrived ahead of their turn
        self._expected = [0] * workers
        self._holdback: List[Dict[int, tuple]] = [{} for _ in range(workers)]
        self._pending_eof: Set[int] = set()
        self._reap_later: List[int] = []
        # a reap drains result_q and pumps, which can find another premature
        # EOF: those fold into the running reap instead of recursing
        self._reaping = False
        self._reap_extra: List[int] = []
        self._dispatcher = threading.Thread(target=self._dispatch_loop,
                                            name="mp-ingest-dispatch", daemon=True)
        self._dispatcher.start()

    # -- producer side ---------------------------------------------------

    def _tenant_idx(self, tenant: Optional[str]) -> int:
        """Intern a boundary tenant id into the bounded index table; a new
        tenant past the cap falls back to the default index 0."""
        if not tenant or tenant == "default":
            return 0
        idx = self._tenant_ids.get(tenant)
        if idx is not None:
            return idx
        with self._cv:
            idx = self._tenant_ids.get(tenant)
            if idx is not None:
                return idx
            if len(self._tenant_names) >= self._tenant_max:
                return 0
            idx = len(self._tenant_names)
            self._tenant_names.append(tenant)
            self._tenant_ids[tenant] = idx
            return idx

    def _tenant_name(self, pid: int) -> str:
        tidx = self._tenant_of.get(pid, 0)
        return self._tenant_names[tidx] if 0 <= tidx < len(self._tenant_names) else "default"

    def submit(self, payload: bytes, *, block: bool = True, tenant: Optional[str] = None) -> None:
        """Hand a payload to one live, unsaturated worker.

        Registration happens before the queue put, under ``_cv``, the lock
        the reaper takes to mark workers dead: either the reap sees the
        registration and re-ingests the payload, or ``submit`` sees the
        worker dead and picks another. A worker whose stripe is full is
        passed over first, and taken in a second round only if its queue
        has room: ring congestion alone never rejects. ``tenant`` (the
        boundary's id) rides the queue item, the ring slot and the
        critical-path slot, so the ack is attributed to it."""
        tidx = self._tenant_idx(tenant)
        while True:
            if self._closed:
                raise RuntimeError("ingester closed")
            if self._dispatch_error is not None:
                raise RuntimeError("dispatcher died") from self._dispatch_error
            with self._cv:
                live = [w for w in range(self.workers) if w not in self._dead]
                if not live:
                    raise RuntimeError("mp-ingest worker pool exhausted (every worker "
                                       "died); restart the ingester")
                start = self._rr % len(live)
                self._rr += 1
                pid = self._next_pid
                self._next_pid += 1
                self._pending[pid] = payload
                if tidx:
                    self._tenant_of[pid] = tidx
                self._inflight += 1
            wire_ns = _critpath.WIRE_T0_NS.get() if self._cp_ledger is not None else 0
            for relax in (False, True):
                for w in live[start:] + live[:start]:
                    with self._cv:
                        if w in self._dead:
                            continue
                        self._assigned[pid] = w
                    if not relax and self._ring.stripe_full(w):
                        with self._cv:
                            if pid not in self._pending:
                                return  # a racing reap already re-ingested it
                            if self._assigned.get(pid) == w:
                                self._assigned.pop(pid)
                        continue
                    cslot = -1
                    if wire_ns:
                        t_en0 = time.perf_counter_ns()
                        cslot = self._cp_ledger.alloc(pid, w, wire_ns, tenant=tidx)
                        if cslot >= 0:
                            # stamped and registered before the queue put: the
                            # dispatcher writes the slot only after the
                            # worker's chunk arrives, so the main-side region
                            # keeps one writer at a time
                            self._cp_ledger.stamp(cslot, _critpath.SEG_ENQUEUE, t_en0,
                                                  time.perf_counter_ns(), pid)
                            with self._cv:
                                self._cslots[pid] = cslot
                    try:
                        self._work_qs[w].put_nowait((pid, payload, cslot, tidx))
                        with self._cv:
                            self._qdepth[w] += 1
                            self._qhigh[w] = max(self._qhigh[w], self._qdepth[w])
                        return
                    except queue.Full:
                        if cslot >= 0:
                            with self._cv:
                                self._cslots.pop(pid, None)
                            self._cp_ledger.abandon(cslot)
                        with self._cv:
                            if pid not in self._pending:
                                return  # a racing reap already re-ingested it
                            if self._assigned.get(pid) == w:
                                self._assigned.pop(pid)
            # every live worker is saturated: roll the registration back
            with self._cv:
                if pid not in self._pending:
                    return  # a racing reap consumed it
                self._pending.pop(pid)
                self._assigned.pop(pid, None)
                self._tenant_of.pop(pid, None)
                self._inflight -= 1
                if self._inflight == 0:
                    self._cv.notify_all()
            if not block:
                self.counters["rejected"] += 1
                raise IngestBackpressure(
                    f"ingest fan-out saturated: every live worker's delivery queue is "
                    f"full ({len(live)} workers x queue depth {self.queue_depth}, "
                    f"{self._ring.stripe_slots} ring slots each); retry after backoff")
            time.sleep(0.002)

    def drain(self, timeout: Optional[float] = None) -> None:
        """Block until every submitted payload has reached the card (the
        dispatcher has applied it and the card has finished the work).
        ``timeout`` (seconds) bounds the wait for the dispatcher: past it,
        ``TimeoutError``."""
        with self._cv:
            done = self._cv.wait_for(
                lambda: self._inflight == 0 or self._dispatch_error is not None, timeout)
        if self._dispatch_error is not None:
            raise RuntimeError("dispatcher died") from self._dispatch_error
        if not done:
            raise TimeoutError(f"mp-ingest drain: {self._inflight} payloads still in flight "
                               f"after {timeout} s")
        self.store.agg.block_until_ready()

    def stats(self) -> dict:
        """The tier's gauges, merged into the store's ``ingest_counters()``;
        after ``close()`` the ring's depths read 0 (its segment is gone)."""
        with self._cv:
            inflight = self._inflight
            dead = len(self._dead)
            qdepth = list(self._qdepth)
            qhigh = list(self._qhigh)
        depth = [0 if self._closed else self._ring.stripe_depth(w) for w in range(self.workers)]
        out = {
            "mpWorkers": self.workers,
            "mpWorkersAlive": self.workers - dead,
            "mpQueueDepth": self.queue_depth,
            "mpInflight": inflight,
            "mpAccepted": self.counters["accepted"],
            "mpSampleDropped": self.counters["sampleDropped"],
            "mpFallbacks": self.counters["fallbacks"],
            "mpRejected": self.counters["rejected"],
            "mpRingSlots": self._ring.capacity,
            "mpRingOccupancy": sum(depth),
            "mpRingHighWater": self._ring_high,
            "mpCoalesceMax": self.coalesce_max,
            "mpGroups": self.counters["groups"],
            "mpCoalescedBatches": self.counters["coalescedBatches"],
            "mpCoalescedChunks": self.counters["coalescedChunks"],
            "mpRingDiscarded": self.counters["ringDiscarded"],
            "mpRingTorn": self.counters["ringTorn"],
            **{f"mp{k[0].upper()}{k[1:]}Us": v for k, v in self.stage_us.items()},
            # a nested per-worker table: scalar-only consumers skip it
            "mpWorkerTable": [
                {"widx": w, "alive": w not in self._dead, "queueDepth": qdepth[w],
                 "queueHighWater": qhigh[w], "ringDepth": depth[w], **dict(ws)}
                for w, ws in enumerate(self._wstats)
            ],
            # acked payloads and spans by tenant, nested like the worker
            # table; bounded by the tenant intern cap
            "mpTenantTable": {name: dict(row) for name, row in list(self._tenant_acked.items())},
        }
        if self.critpath is not None:
            out.update(self.critpath.counters())
        return out

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for w, p in enumerate(self._procs):
            if w in self._dead:
                continue  # no consumer; nothing to shut down
            # a live worker keeps consuming its bounded queue, so a timed put
            # retried until it lands cannot hang; a worker that died during
            # shutdown stops needing one
            while True:
                try:
                    self._work_qs[w].put(None, timeout=0.5)
                    break
                except queue.Full:
                    if not p.is_alive():
                        break
        for p in self._procs:
            p.join(timeout=30)
            if p.is_alive():  # pragma: no cover - hang safety
                p.terminate()
                p.join(timeout=5)
        self._dispatcher.join(timeout=30)
        for q in self._work_qs + [self._result_q]:
            # a dead worker's queue may still hold payloads (already
            # re-ingested): its feeder thread must not block exit on a pipe
            # nobody reads
            q.close()
            q.cancel_join_thread()
        if self._dispatch_error is not None:
            # the stored traceback pins frames whose locals can be views
            # into ring slots, and the segment refuses to close while they
            # live; the dispatcher is joined, so the frames can go
            import traceback

            tb = self._dispatch_error.__traceback__
            if tb is not None:
                traceback.clear_frames(tb)
        self._buffered.clear()
        self._ring.close()
        if self._cp_ledger is not None:
            self._cp_ledger.close()

    # -- dispatcher ------------------------------------------------------

    def _dispatch_loop(self) -> None:
        try:
            self._run_dispatch()
        except BaseException as e:
            logger.exception("mp-ingest dispatcher failed")
            self._dispatch_error = e
            with self._cv:
                self._cv.notify_all()
            self._sink_until_closed()

    def _sink_until_closed(self) -> None:
        """After a dispatcher failure, keep draining result_q and freeing
        ring slots, so surviving workers never wedge in ``claim()`` with
        the only consumer gone. Results are discarded: the error already
        reached submit() and drain()."""
        while True:
            for w in range(self.workers):
                while self._ring.stripe_depth(w) > 0:
                    self._ring.free_next(w)
            try:
                self._result_q.get(timeout=0.25)
            except queue.Empty:
                if self._closed and not any(p.is_alive() for p in self._procs):
                    return

    def _run_dispatch(self) -> None:
        eof_set: set = set()
        last_liveness = time.monotonic()
        idle_wait = 0.0005
        while len(eof_set) < self.workers:
            if self._pass(eof_set):
                idle_wait = 0.0005
            else:
                # nothing ready: wait on the control queue. A publish nudges
                # it; the timeout is a poll backstop that backs off while
                # idle (a nudge can race the pass that consumed its slot)
                try:
                    msg = self._result_q.get(timeout=idle_wait)
                except queue.Empty:
                    if self._closed and not any(p.is_alive() for p in self._procs):
                        self._pass(eof_set)  # final sweep
                        break
                    idle_wait = min(idle_wait * 2, 0.05)
                else:
                    self._route_msg(msg, eof_set)
                    idle_wait = 0.0005
            # liveness also runs under sustained traffic: a busy survivor
            # keeps the ring non-empty, and a dead worker's payloads would
            # pin _inflight for as long as the load lasts
            if not self._closed and time.monotonic() - last_liveness > 2.0:
                self._check_liveness(eof_set)
                last_liveness = time.monotonic()

    def _pass(self, eof_set: set) -> bool:
        """One dispatcher pass: drain the control queue, pump every live
        stripe's run of ready slots in wseq order, flush the payloads that
        completed (coalesced), copy out any view still buffered for an
        incomplete payload, then free the consumed slots: no slot is held
        across passes, so a multi-chunk payload cannot starve its own
        worker of ring capacity."""
        activity = False
        while True:
            try:
                msg = self._result_q.get_nowait()
            except queue.Empty:
                break
            self._route_msg(msg, eof_set)
            activity = True
        ready: List[tuple] = []
        consumed: Dict[int, int] = {}
        self._pump(ready, consumed)
        self._ring_high = max(self._ring_high, self._ring.occupancy())
        if ready:
            self._flush_ready(ready)
        if consumed:
            self._materialize_views()
            for w, cnt in consumed.items():
                for _ in range(cnt):
                    self._ring.free_next(w)
            activity = True
        if self._reap_later and not self._reaping:
            dead = [w for w in self._reap_later if w not in eof_set]
            self._reap_later = []
            if dead:
                self._reap_dead_workers(dead, eof_set)
                activity = True
        for w in list(self._pending_eof):
            if self._ring.stripe_depth(w) == 0 and not self._holdback[w]:
                self._pending_eof.discard(w)
                eof_set.add(w)
                activity = True
        return activity or bool(ready)

    def _route_msg(self, msg, eof_set: set) -> None:
        """Sort one control-queue message: an EOF resolves now (clean) or
        marks the worker for reaping (premature); chunk and fallback
        messages wait in the worker's holdback for their wseq turn."""
        kind = msg[0]
        if kind == _KIND_NUDGE:
            return  # the pump reads the ring directly
        if kind == _KIND_EOF:
            widx = msg[1]
            if self._closed or widx in self._dead:
                # clean shutdown: final once the stripe drains
                self._pending_eof.add(widx)
                if widx in self._dead:
                    self._pending_eof.discard(widx)
                    eof_set.add(widx)
            elif self._reaping:
                self._reap_extra.append(widx)
            else:
                # workers EOF only after close()'s sentinel: an EOF before it
                # means the worker loop died with payloads unaccounted, which
                # is handled as an unclean death, at the pass's end, so that
                # payloads completed in this pass flush first
                self._reap_later.append(widx)
            return
        widx, wseq = msg[1], msg[3]
        if widx in self._dead:
            return
        self._holdback[widx][wseq] = msg

    def _pump(self, ready: List[tuple], consumed: Dict[int, int]) -> None:
        """Apply each worker's available chunks strictly in wseq order,
        merging its stripe with its held-back queue messages; stop at the
        first missing sequence (in flight on the other channel)."""
        for w in range(self.workers):
            if w in self._dead:
                continue
            budget = self._ring.stripe_slots + len(self._holdback[w]) + 1
            while budget > 0:
                budget -= 1
                exp = self._expected[w]
                hb = self._holdback[w].pop(exp, None)
                if hb is not None:
                    self._apply_queue_msg(hb, ready)
                    self._expected[w] = exp + 1
                    continue
                peeked = self._ring.peek(w, consumed.get(w, 0))
                if peeked is None:
                    break
                hdr, seq = peeked
                if int(hdr[ring_mod._S_WSEQ]) != exp:
                    break  # the missing wseq is in flight on the queue
                self._consume_ring_chunk(w, hdr, seq, ready)
                consumed[w] = consumed.get(w, 0) + 1
                self._expected[w] = exp + 1

    def _consume_ring_chunk(self, w: int, hdr: np.ndarray, seq: int, ready: List[tuple]) -> None:
        """Decode a slot's header and sidecar; the image stays a view."""
        t0 = time.perf_counter()
        pid = int(hdr[ring_mod._S_PIDX])
        if pid not in self._pending:
            # a late chunk of a payload a reap already re-ingested: the
            # slot still counts as consumed and the pass frees it
            self.counters["ringDiscarded"] += 1
            return
        # the tenant index rides the slot header across processes; submit
        # recorded a non-default one already, under _cv, before the worker
        # could publish, so this fills only a pid no other thread touches
        tidx = int(hdr[ring_mod._S_TENANT])
        if tidx and pid not in self._tenant_of:
            self._tenant_of[pid] = tidx
        per = int(hdr[ring_mod._S_PER])
        fused = self._ring.image(w, seq, self._n_shards * self._wire_rows * per).reshape(
            self._n_shards, self._wire_rows, per)
        svc_new, name_new, pairs_new, arch, rec = ring_mod.unpack_aux(
            self._ring.aux(w, seq, int(hdr[ring_mod._S_AUX_LEN])))
        self._apply_chunk(
            w, pid, fused, int(hdr[ring_mod._S_NSPANS]), int(hdr[ring_mod._S_NDUR]),
            int(hdr[ring_mod._S_NERR]), int(hdr[ring_mod._S_DROPPED]),
            svc_new, name_new, pairs_new, arch,
            (int(hdr[ring_mod._S_TS_MIN]), int(hdr[ring_mod._S_TS_MAX])), rec,
            int(hdr[ring_mod._S_PARSE_NS]) / 1e9, int(hdr[ring_mod._S_PACK_NS]) / 1e9,
            int(hdr[ring_mod._S_ROUTE_NS]) / 1e9, True, time.perf_counter() - t0, ready)

    def _apply_queue_msg(self, msg, ready: List[tuple]) -> None:
        if msg[0] == _KIND_FALLBACK:
            _, widx, pid, _wseq = msg
            payload = self._pending.get(pid)
            if payload is None:
                return  # a reap already re-ingested it
            self._buffered.pop(pid, None)
            self._drop_cslot(pid)  # the slow path's retry: the timeline is abandoned
            self._fallback(payload)
            self.counters["fallbacks"] += 1
            if 0 <= widx < len(self._wstats):
                self._wstats[widx]["fallbacks"] += 1
            self._finish(pid)
            return
        (_, widx, pid, _wseq, fused, n_spans, n_dur, n_err, dropped,
         svc_new, name_new, pairs_new, arch, ts_range, rec, parse_s, pack_s, route_s) = msg
        if pid not in self._pending:
            return
        self._apply_chunk(widx, pid, fused, n_spans, n_dur, n_err, dropped,
                          svc_new, name_new, pairs_new, arch, ts_range, rec,
                          parse_s, pack_s, route_s, False, 0.0, ready)

    def _apply_chunk(self, widx, pid, fused, n_spans, n_dur, n_err, dropped,
                     svc_new, name_new, pairs_new, arch, ts_range, rec,
                     parse_s, pack_s, route_s, is_view, consume_s, ready) -> None:
        """Replay the chunk's vocab journal into the global vocab and buffer
        the chunk until its payload's last chunk arrives. ``consume_s`` is
        the time the slot's decode took, billed to the payload's
        ``mp_record``."""
        t0 = time.perf_counter()
        store = self.store
        vocab = store.vocab
        m = self._maps[widx]
        cs = self._cslots.get(pid, -1) if self._cp_ledger is not None else -1
        if svc_new or name_new or pairs_new:
            tv0 = time.perf_counter()
            with store._intern_lock:
                m.svc = _IdMaps._append(m.svc, [vocab.services.intern(s) for s in svc_new])
                m.name = _IdMaps._append(m.name, [vocab.span_names.intern(s) for s in name_new])
                m.key = _IdMaps._append(
                    m.key, [vocab.key_id(int(m.svc[sl]), int(m.name[nl])) for sl, nl in pairs_new])
            tv1 = time.perf_counter()
            obs.record("mp_vocab_replay", tv1 - tv0)
            self.stage_us["vocabReplay"] += int((tv1 - tv0) * 1e6 + 0.5)
            if cs >= 0:
                self._cp_ledger.stamp(cs, _critpath.SEG_VOCAB_REPLAY, int(tv0 * 1e9),
                                      int(tv1 * 1e9), pid)
        # the workers' stage walls, relayed (histogram only: the time was
        # spent in another process, not under this thread's request)
        if parse_s > 0.0:
            obs.record_relayed("parse", parse_s)
        if pack_s > 0.0:
            obs.record_relayed("pack", pack_s)
        if route_s > 0.0:
            obs.record_relayed("route", route_s)
        ws = self._wstats[widx]
        ws["chunks"] += 1
        ws["spans"] += n_spans
        for stage, sec in (("parse", parse_s), ("pack", pack_s), ("route", route_s)):
            us = int(sec * 1e6 + 0.5)
            ws[stage + "Us"] += us
            self.stage_us[stage] += us
        if dropped >= 0:
            ws["payloads"] += 1
        if fused is not None:
            if rec is not None:
                # remap the record's svc/rsvc/name/key lanes to global ids
                # now (the journal above covers every id this chunk uses);
                # the append waits for the payload's flush
                rec = list(rec)
                rec[7] = m.svc[rec[7]]
                rec[8] = m.svc[rec[8]]
                rec[9] = m.name[rec[9]]
                rec[10] = m.key[rec[10]]
                rec = tuple(rec)
            self._buffered.setdefault(pid, []).append(
                [fused, n_spans, n_dur, n_err, ts_range, arch, rec, is_view, widx,
                 consume_s + time.perf_counter() - t0])
        # dropped == -1 marks a continuation chunk; the payload applies as a
        # whole once its last chunk is in
        if dropped >= 0:
            ready.append((pid, dropped))

    def _materialize_views(self) -> None:
        """Chunks still buffered for an incomplete payload at the end of a
        pass are copied out of their slots, so every consumed slot can be
        freed and a payload never pins its worker's stripe."""
        for pid, entries in self._buffered.items():
            for e in entries:
                if e[7]:
                    t0 = time.perf_counter()
                    e[0] = np.array(e[0])
                    e[7] = False
                    tc1 = time.perf_counter()
                    obs.record("mp_shm_copy", tc1 - t0)
                    cs = self._cslots.get(pid, -1) if self._cp_ledger is not None else -1
                    if cs >= 0:
                        self._cp_ledger.stamp(cs, _critpath.SEG_SHM_COPY, int(t0 * 1e9),
                                              int(tc1 * 1e9), pid)

    # -- coalesced flush --------------------------------------------------

    def _flush_ready(self, ready: List[tuple]) -> None:
        """Flush the payloads completed this pass: their chunks are packed
        into groups of up to ``coalesce_max`` chunks (bounded by the lane
        cap), and each group takes one ``ingest_fused_multi``, whose step
        carries the WAL append and the sampling verdicts. Until this runs a
        payload has changed nothing, which is what makes worker death
        recoverable. A payload is acked after the group holding its last
        chunk and, when several groups share one ``wal.batched()`` block,
        after that block."""
        store = self.store
        plans: Dict[int, dict] = {}
        flat: List[tuple] = []
        for pid, dropped in ready:
            entries = self._buffered.pop(pid, [])
            plans[pid] = {"dropped": dropped, "left": len(entries),
                          "spans": sum(e[1] for e in entries),
                          "consume_s": sum(e[9] for e in entries), "flush_s": 0.0}
            flat.extend((e, pid) for e in entries)
        cap = store.agg.lane_cap
        groups: List[List[tuple]] = []
        cur: List[tuple] = []
        lanes = 0
        for e, pid in flat:
            per = int(e[0].shape[-1])
            if cur and (len(cur) >= self.coalesce_max or lanes + per > cap):
                groups.append(cur)
                cur, lanes = [], 0
            cur.append((e, pid))
            lanes += per
        if cur:
            groups.append(cur)
        wal = getattr(store, "wal", None)
        if wal is not None and len(groups) > 1:
            # one WAL block for the pass: the per-record flush (and fsync)
            # waits for the block's end, and so does every group's ack
            done: List[int] = []
            with wal.batched():
                for g in groups:
                    done.extend(self._flush_group(g, plans))
            self._ack_done(done, plans)
        else:
            for g in groups:
                self._ack_done(self._flush_group(g, plans), plans)
        # payloads with no device chunk (every span sampled away, or empty)
        empty = [pid for pid, p in plans.items() if p["left"] == 0 and not p.get("acked")]
        if empty:
            self._ack_done(empty, plans)

    def _flush_group(self, group: List[tuple], plans: Dict[int, dict]) -> List[int]:
        """One coalesced group -> one gather, one device step, one WAL
        record. Returns the payloads whose last chunk it held."""
        store = self.store
        led = self._cp_ledger
        t_g0 = time.perf_counter()
        pairs = []
        if led is not None:
            seen: Set[int] = set()
            for _, pid in group:
                if pid not in seen:
                    seen.add(pid)
                    pairs.append((self._cslots.get(pid, -1), pid))
            traced = [(s, p) for s, p in pairs if s >= 0]
            # arm the thread-local, so the WAL's append and fsync stamps
            # land in these payloads' timelines (the WAL rides the step)
            if len(traced) == 1:
                _critpath.set_active(led, traced[0][0], traced[0][1])
            elif traced:
                _critpath.set_active_group(led, traced)
        n_spans = n_dur = n_err = 0
        lo = hi = None
        parts = []
        for e, pid in group:
            fused, c_spans, c_dur, c_err, ts_range, arch, rec, is_view, widx, _ = e
            if arch:
                self._archive(arch)
            if rec is not None and getattr(store, "_disk", None) is not None:
                # the sampling gate: the sketches below see every span, the
                # disk keeps the verdict-kept ones; gated here, at flush
                # time, so the verdicts see the synchronous path's tables
                sampler = store.agg.sampler
                if sampler is not None:
                    rec = sampler.gate_record(rec)
                if rec is not None:
                    store.disk_append_record(rec)
            if self.shadow is not None:
                # the tap may keep its argument: never a live ring-slot view
                self.shadow.offer_fused(np.array(fused) if is_view else fused)
            m = self._maps[widx]
            parts.append((fused, m.svc, m.key))
            n_spans += c_spans
            n_dur += c_dur
            n_err += c_err
            if c_spans > 0:
                lo = ts_range[0] if lo is None else min(lo, ts_range[0])
                hi = ts_range[1] if hi is None else max(hi, ts_range[1])
        if len(group) == 1:
            ts = group[0][0][4]  # the chunk's own range, bit for bit
        else:
            ts = (lo, hi) if lo is not None else (0, 0)
        # an armed feed.latency site sleeps here, where a slow device feed
        # stalls the dispatcher (backpressure tests fill the queues with it);
        # the group's tenant is passed, as this thread has no request context
        faults.resource_point("feed.latency",
                              tenant=self._tenant_name(group[0][1]) if group else "default")
        tf0 = time.perf_counter()
        try:
            store.agg.ingest_fused_multi(parts, n_spans=n_spans, n_dur=n_dur, n_err=n_err,
                                         ts_range=ts, pad_to_multiple=store._pad)
        finally:
            if led is not None:
                _critpath.clear_active()
        tf1 = time.perf_counter()
        obs.record("mp_device_feed", tf1 - tf0)
        for s, p in pairs:
            if s >= 0:
                led.stamp(s, _critpath.SEG_DEVICE_FEED, int(tf0 * 1e9), int(tf1 * 1e9), p)
        self.stage_us["deviceFeed"] += int((tf1 - tf0) * 1e6 + 0.5)
        self.counters["groups"] += 1
        if len(group) > 1:
            self.counters["coalescedBatches"] += 1
            self.counters["coalescedChunks"] += len(group)
        # the group's wall is billed to its chunks by span weight, so
        # mp_record stays a per-payload handling time
        g_wall = time.perf_counter() - t_g0
        g_spans = sum(e[1] for e, _ in group) or len(group)
        done = []
        for e, pid in group:
            p = plans[pid]
            p["flush_s"] += g_wall * (e[1] or 1) / g_spans
            p["left"] -= 1
            if p["left"] == 0:
                done.append(pid)
        self.stage_us["flush"] += int(g_wall * 1e6 + 0.5)
        return done

    def _ack_done(self, pids: List[int], plans: Dict[int, dict]) -> None:
        """Ack payloads whose last chunk is durable: counters, metrics and
        the in-flight release."""
        for pid in pids:
            p = plans[pid]
            if p.get("acked"):
                continue
            p["acked"] = True
            total, dropped = p["spans"], p["dropped"]
            obs.record("mp_record", p["consume_s"] + p["flush_s"])
            self.counters["accepted"] += total
            self.counters["sampleDropped"] += max(dropped, 0)
            if self.metrics is not None:
                self.metrics.increment_spans(total + max(dropped, 0))
                if dropped > 0:
                    self.metrics.increment_spans_dropped(dropped)
            cs = self._cslots.get(pid, -1) if self._cp_ledger is not None else -1
            if cs >= 0:
                self._cp_ledger.ack(cs, pid)  # durable: the WAL append and the feed are done
            # per-tenant acked accounting and the retained-spans charge:
            # span counts are known only after the parse, so here, at ack
            tname = self._tenant_name(pid)
            row = self._tenant_acked.setdefault(tname, {"payloads": 0, "spans": 0})
            row["payloads"] += 1
            row["spans"] += total
            sink = self.tenant_sink
            if sink is not None and total:
                try:
                    sink(tname, total)
                except Exception:  # accounting must never fail an ack
                    logger.exception("tenant_sink failed")
            self._finish(pid)

    # -- worker death -----------------------------------------------------

    def _check_liveness(self, eof_set: set) -> None:
        """A worker that died uncleanly (a crash in the native parser, an
        OOM kill) never sends EOF; without this its payloads would pin
        _inflight and drain() would wait forever."""
        dead = [w for w, p in enumerate(self._procs) if not p.is_alive() and w not in eof_set]
        if dead:
            self._reap_dead_workers(dead, eof_set)

    def _reap_dead_workers(self, dead: List[int], eof_set: set) -> None:
        """A worker died without EOF: recover everything and keep serving on
        the survivors. Chunks apply only at a payload's last chunk, so a
        half-processed payload changed nothing: its buffered chunks are
        dropped, the stripe is reclaimed (the pid-guarded reset handles a
        SIGKILL mid-write), and the payload, with everything queued behind
        it, re-ingests on the slow path."""
        self._reaping = True
        refed = 0
        try:
            # mark dead under _cv first: submit() registers under the same
            # lock, so no new payload targets these workers and every
            # registered one is visible to the scan below
            with self._cv:
                self._dead.update(dead)
            # timed gets, not get_nowait(): a queue put goes through a
            # feeder thread, so a result already shipped can be in the pipe
            # but not yet visible
            while True:
                try:
                    msg = self._result_q.get(timeout=0.25)
                except queue.Empty:
                    break
                self._route_msg(msg, eof_set)
            # apply and flush everything already produced: completed
            # payloads leave _pending before the re-ingest scan
            ready: List[tuple] = []
            consumed: Dict[int, int] = {}
            self._pump(ready, consumed)
            if ready:
                self._flush_ready(ready)
            self._materialize_views()
            for w, cnt in consumed.items():
                for _ in range(cnt):
                    self._ring.free_next(w)
            if self._reap_extra:
                with self._cv:
                    self._dead.update(self._reap_extra)
                dead = dead + [w for w in self._reap_extra if w not in dead]
                self._reap_extra = []
            for w in dead:
                eof_set.add(w)
                self._pending_eof.discard(w)
                self._maps[w] = None  # free the dead worker's id tables
                self._holdback[w].clear()
                rec = self._ring.reclaim_stripe(w, self._procs[w].pid or -1)
                self.counters["ringDiscarded"] += rec["discarded"]
                self.counters["ringTorn"] += rec["torn"]
                # empty its queue so the feeder thread cannot block shutdown;
                # the payloads re-ingest through the _assigned scan
                while True:
                    try:
                        self._work_qs[w].get(timeout=0.25)
                    except queue.Empty:
                        break
                with self._cv:
                    owned = [p for p, a in self._assigned.items() if a == w]
                for pid in owned:
                    self._buffered.pop(pid, None)
                    payload = self._pending.get(pid)
                    if payload is None:
                        continue
                    # the dead worker's slots would stay open: recycle them
                    self._drop_cslot(pid)
                    self._fallback(payload)
                    self.counters["fallbacks"] += 1
                    self._finish(pid)
                    refed += 1
        finally:
            self._reaping = False
        logger.warning("mp-ingest worker(s) %s died uncleanly; %d payload(s) re-ingested on "
                       "the slow path, the pool continues on %d", dead, refed,
                       self.workers - len(self._dead))

    # -- shared helpers ----------------------------------------------------

    def _drop_cslot(self, pid: int) -> None:
        """Abandon a payload's timeline (the fallback and reap paths): its
        partial stamps would decompose misleadingly, so the slot recycles."""
        if self._cp_ledger is None:
            return
        with self._cv:
            cs = self._cslots.pop(pid, -1)
        if cs >= 0:
            self._cp_ledger.abandon(cs)

    def _finish(self, pid: int) -> None:
        with self._cv:
            self._pending.pop(pid, None)
            self._cslots.pop(pid, None)
            self._tenant_of.pop(pid, None)
            w = self._assigned.pop(pid, None)
            if w is not None and self._qdepth[w] > 0:
                self._qdepth[w] -= 1
            self._inflight -= 1
            if self._inflight == 0:
                self._cv.notify_all()

    def _archive(self, slices: List[bytes]) -> None:
        """Decode a chunk's 1/N sample slices into the host archive, gated
        by the sampling verdicts like every retention surface."""
        from zipkin_tpu_torch.tpu.store import decode_raw_spans

        spans = decode_raw_spans(slices)
        if not spans:
            return
        sampler = self.store.agg.sampler
        if sampler is not None:
            from zipkin_tpu_torch.tpu.columnar import pack_spans

            with self.store._intern_lock:
                cols = pack_spans(spans, self.store.vocab, 1)
            keep = sampler.verdict_cols(cols)[: len(spans)]
            spans = [s for s, k in zip(spans, keep) if k]
        if spans:
            self.store._archive.accept(spans).execute()

    def _fallback(self, payload: bytes) -> None:
        """Payloads the native parser refuses, or that a dead worker owned,
        take the object path with the boundary sampler. An undecodable one
        is counted and dropped: after a 202 it cannot be answered 400."""
        from zipkin_tpu_torch.model import codec

        try:
            spans = codec.decode_spans(payload)
        except Exception:
            logger.warning("mp-ingest: undecodable payload dropped")
            if self.metrics is not None:
                self.metrics.increment_messages_dropped()
            return
        n_all = len(spans)
        if self._sampler is not None:
            spans = [s for s in spans if self._sampler.test(s)]
        self.store.accept(spans).execute()
        if self.metrics is not None:
            self.metrics.increment_spans(n_all)
            if n_all - len(spans):
                self.metrics.increment_spans_dropped(n_all - len(spans))

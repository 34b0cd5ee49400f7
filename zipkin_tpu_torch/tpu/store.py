"""TorchStorage: the storage SPI over the aggregation tier on the card
(port of the object path of ``zipkin_tpu/tpu/store.py:TpuStorage``).

It implements the same SPI as the in-memory store, so a server or a
collector uses either one, and serves the aggregate reads (dependencies,
latency percentiles, trace cardinalities) from the device sketches of a
:class:`~zipkin_tpu_torch.parallel.aggregator.TorchAggregator`:

- **device**: latency histograms and t-digests per (service, spanName),
  HLL trace cardinality per service, dependency links over the retained
  span ring, and the time tier's current buckets;
- **host archive**: a bounded :class:`InMemoryStorage` keeps the raw spans
  for exact trace reads and search; past its eviction horizon the
  aggregates stay answerable from the device;
- **disk archive** (``archive_dir``, :mod:`zipkin_tpu_torch.tpu.archive`):
  every ingested span's raw bytes behind a trace-id index, bounded by a
  byte budget, so trace reads, search and names answer for every span the
  budget holds, across restarts (a ``vocab.json`` sidecar keeps the ids
  of the archived columns);
- **host time tier**: sealed time buckets (:class:`TimeTier`) answer
  windowed reads over any ``[endTs - lookback, endTs]`` range.

Each aggregate read is one device read (one packed transfer) memoized by
the aggregator's write version.

Two write paths: the object path (:meth:`TorchStorage.accept`, decoded
Span objects, each encoded once as JSON v2 for the disk archive) and the
line-rate path (:meth:`TorchStorage.ingest_json_fast`, JSON v2 or proto3
bytes through the native parser, which interns in C; the disk archive takes
the payload's raw slices, and without one a trace-affine 1/N sample is
decoded into the host archive).

The line-rate path's two halves, :meth:`TorchStorage._fast_parse` and
:meth:`TorchStorage._fast_dispatch`, are also driven apart by the threaded
feeder (:mod:`zipkin_tpu_torch.tpu.feeder`); the multi-process tier
(:mod:`zipkin_tpu_torch.tpu.mp_ingest`) parses in worker processes and
feeds coalesced groups through :meth:`TorchAggregator.ingest_fused_multi`
and :meth:`TorchStorage.disk_append_record`. An attached tier (the
``mp_ingester`` attribute, which the server sets) adds its gauges to
:meth:`TorchStorage.ingest_counters`.

The observability plane (:mod:`zipkin_tpu_torch.obs`): the flight
recorder's ``parse``, ``pack``, ``archive_write``, ``query_fresh`` and
``query_cached`` stages are stamped where the reference stamps them; the
dependencies, quantiles, cardinalities and overview reads run under a
:class:`~zipkin_tpu_torch.obs.querytrace.QueryObservatory` trace with the
cache-probe, link-resolve and serialize segments; an attached ``shadow``
(:class:`~zipkin_tpu_torch.obs.shadow.HostShadow`) is offered every batch
of the line-rate path, and ``ingest_counters()`` carries the device
observatory's totals, the ``accuracy`` gauges and the query plane's.

The epoch-published read mirror (:mod:`zipkin_tpu_torch.tpu.mirror`): the
four aggregate reads serve first from the last published epoch without
taking the aggregator lock, within ``staleness_ms`` (per request) or the
mirror's bound; :meth:`TorchStorage.publish_mirror` cuts an epoch (the
server's windows ticker calls it, the resume adapter at boot), and
:meth:`TorchStorage.attach_mirror_segment` also serializes each epoch into
a shared-memory segment that reader processes serve from
(:mod:`zipkin_tpu_torch.serving`). Every closure the mirror keeps reaches
the store through a weak proxy, so the mirror makes no cycle.

A serve from the mirror memoizes its shaped answer (the API rows built
from the epoch's arrays) per mirror generation, key, shaping arguments and
vocab size, as a reader process's ``SegmentView`` does: concurrent readers
of one epoch shape it once, and a new generation or :meth:`TorchStorage.clear`
drops the memo (bounded at ``_SHAPE_MEMO_MAX`` entries).

Brownout read modes: with an ``overload`` controller attached (the server
attaches one by default), B1/B2 (``cache_first``) serve a version-stale
cached read or mirror epoch within the controller's ``max_stale_ms``, and B3
(``cache_only``) serves any cached answer; a cold key still computes, and
the first normal-mode read drops the stale entries. Stale serves count as
``readCacheStaleServes``. Tenant-prefixed demand keys are refused and
counted, as the reference refuses them. :meth:`TorchStorage.get_traces` reads every id
through one ``views()`` of the disk archive (the reference takes one per
id, which sorts the live segment again for each). Durable boot (snapshot
restore, WAL replay) is the resume adapter's,
:class:`zipkin_tpu_torch.storage.tpu.TorchStorage`; this class carries its
hooks (:meth:`on_restored_leaves`, :meth:`apply_sctl`, ``restore_stats``).
"""

from __future__ import annotations

import json
import logging
import os
import tempfile
import threading
import time
import weakref
import zlib
from typing import List, Optional, Sequence, Tuple

import numpy as np

from zipkin_tpu_torch import native, obs, readpack
from zipkin_tpu_torch.internal.hex import epoch_minutes, normalize_trace_id
from zipkin_tpu_torch.internal.span_node import merge_trace
from zipkin_tpu_torch.model.span import DependencyLink, Span
from zipkin_tpu_torch.obs import querytrace
from zipkin_tpu_torch.obs.device import OBSERVATORY
from zipkin_tpu_torch.ops import hll, ttmerge
from zipkin_tpu_torch.parallel.aggregator import TorchAggregator
from zipkin_tpu_torch.sampling import RATE_ONE, HostSampler, RateController
from zipkin_tpu_torch.storage.memory import InMemoryStorage
from zipkin_tpu_torch.storage.spi import (
    AutocompleteTags,
    FastIngestError,
    QueryRequest,
    ServiceAndSpanNames,
    SpanConsumer,
    SpanStore,
    StorageComponent,
    group_by_trace_id,
    trace_id_key,
)
from zipkin_tpu_torch.tpu.archive import SpanArchive, parsed_record
from zipkin_tpu_torch.tpu.columnar import Vocab, pack_parsed, pack_spans, sample_slices
from zipkin_tpu_torch.tpu.mirror import ReadMirror
from zipkin_tpu_torch.tpu.state import AggConfig
from zipkin_tpu_torch.tpu.timetier import TimeTier
from zipkin_tpu_torch.utils.call import Call
from zipkin_tpu_torch.utils.component import CheckResult

logger = logging.getLogger(__name__)

# the largest device batch before the state's own bounds: the reference's
# default transport cap, kept so that both stores cut a POST into the same
# chunks (digest flushes and rollups then fall at the same lanes)
MAX_DEVICE_BATCH = 65536
# dependency answers may be this stale under ingest: the reference's
# dependency table is an offline batch job, hours stale by design
DEPS_MAX_STALE_MS = 5000.0
# the dashboard's default quantile list (the server's q default): the
# mirror pins these reads, so the first post-boot refresh is lock-free
DEFAULT_QS = (0.5, 0.9, 0.99)
# returned by _mirror_bound when the request opted out of the mirror
# (staleness_ms <= 0): force the fresh lock-path read
_MIRROR_FRESH = object()
# shaped mirror answers kept for one generation (the reader's _MEMO_MAX)
_SHAPE_MEMO_MAX = 256


def _decode_raw_span(raw: bytes) -> Span:
    """Decode one archived raw span slice: a JSON object starts with '{',
    a proto3 Span message with a field tag byte (port of
    ``zipkin_tpu/tpu/store.py:68``)."""
    from zipkin_tpu_torch.model import json_v2, proto3

    if raw[:1] == b"{":
        return json_v2.decode_one_span(raw)
    return proto3.decode_span(raw)


def decode_raw_spans(slices) -> List[Span]:
    """The spans of raw span slices, skipping a slice the strict codec
    rejects (a number past float64 raises OverflowError): the device batch
    still carries that span, as in the reference."""
    spans = []
    for raw in slices:
        try:
            spans.append(_decode_raw_span(raw))
        except Exception:
            continue
    return spans


class TorchStorage(
    StorageComponent, SpanConsumer, SpanStore, ServiceAndSpanNames, AutocompleteTags
):
    def __init__(
        self,
        *,
        config: Optional[AggConfig] = None,
        device=None,
        mesh=None,
        strict_trace_id: bool = True,
        search_enabled: bool = True,
        autocomplete_keys: Sequence[str] = (),
        archive_max_span_count: int = 500_000,
        pad_to_multiple: int = 1024,
        fast_archive_sample: int = 64,
        max_device_batch: int = MAX_DEVICE_BATCH,
        deps_max_stale_ms: float = DEPS_MAX_STALE_MS,
        archive_dir: Optional[str] = None,
        archive_max_bytes: int = 2 << 30,
        archive_segment_bytes: int = 64 << 20,
        sampling_budget: float = 0.0,
        sampling_interval_s: float = 5.0,
        sampling_min_rate: int = 256,
        sampling_tail_quantile: float = 0.99,
        sampling_rare_min: Optional[int] = None,
    ) -> None:
        """``device``: where the aggregator's state lives — the card unless
        the caller names another (``"cpu"`` runs the plain path); ``mesh``
        (:func:`zipkin_tpu_torch.parallel.mesh.make_mesh`): the shards'
        devices, in its place; neither is every visible card, a shard each.
        ``fast_archive_sample``: the line-rate path archives 1 trace in N
        at full fidelity (0: none). ``max_device_batch``: the largest
        device batch before the state's own bounds. ``deps_max_stale_ms``:
        how stale a cached dependency answer may be served under ingest
        (0: always fresh). ``archive_dir``: the disk archive's directory
        (None: none), holding at most ``archive_max_bytes`` in segments of
        ``archive_segment_bytes``; the time tier's sealed segments persist
        under its ``timetier/``."""
        self.config = config or AggConfig()
        # the archive index packs svc and rsvc ids into 16 bits each;
        # AggConfig refuses max_services past columnar.MAX_WIRE_SERVICES,
        # the same bound, so no config can truncate them
        self.strict_trace_id = strict_trace_id
        self.search_enabled = search_enabled
        self.autocomplete_keys = tuple(autocomplete_keys)
        self.vocab = Vocab(max_services=self.config.max_services, max_keys=self.config.max_keys)
        self.agg = TorchAggregator(self.config, device=device, mesh=mesh)
        # tail sampling gates retention (the RAM archive keeps the kept
        # spans) while the device sketches see every span
        self.sampler = None
        self.sampling_controller = None
        if self.config.sampling:
            self.sampler = HostSampler(
                self.config.max_services,
                self.config.max_keys,
                rare_min=(self.config.sample_rare_min if sampling_rare_min is None
                          else sampling_rare_min),
            )
            self.agg.sampler = self.sampler
            if sampling_budget > 0:
                self.sampling_controller = RateController(
                    self,
                    budget_spans_per_sec=sampling_budget,
                    interval_s=sampling_interval_s,
                    min_rate=sampling_min_rate,
                    tail_quantile=sampling_tail_quantile,
                )
        self._archive = InMemoryStorage(
            max_span_count=archive_max_span_count,
            strict_trace_id=strict_trace_id,
            search_enabled=search_enabled,
            autocomplete_keys=autocomplete_keys,
        )
        self._pad = pad_to_multiple
        # the lane counts capture_steps captured at (clear captures them again)
        self._captured_lanes: List[int] = []
        # largest device batch after padding: the digest pending buffer and
        # the rollup segment bound it (the port's pending append does not
        # clamp, so no chunk past this may reach the device); rounded down
        # to a pad multiple
        bound = min(self.config.digest_buffer, self.config.rollup_segment, max_device_batch)
        self.max_batch = (bound // pad_to_multiple) * pad_to_multiple
        if self.max_batch <= 0:
            raise ValueError(
                f"digest_buffer ({self.config.digest_buffer}) must be >= "
                f"pad_to_multiple ({pad_to_multiple})"
            )
        # every interning pass holds this, so ids are assigned in one order:
        # the C tables of the fast path and the Python vocab of the object
        # path both assign ids sequentially
        self._intern_lock = threading.RLock()
        self._nvocab = None  # the C tables, made at the first fast ingest
        # the fast path archives a trace-affine 1 in N sample (0: none)
        self._fast_archive_every = fast_archive_sample
        # estimates past this are bias-dominated (see hll.envelope_max)
        self._hll_envelope_max = hll.envelope_max(self.config.hll_precision)
        self._hll_envelope_exceeded = 0  # reads that saw such a row
        self._hll_beyond_envelope_rows = 0  # rows beyond, at the last read
        # device reads memoized until the next query-visible write (the
        # aggregator's write_version): key -> (value, born monotonic)
        self._read_cache: dict = {}
        self._read_cache_version = -1
        self._read_cache_lock = threading.Lock()
        self._read_cache_age_ms = 0.0
        self._read_cache_age_max_ms = 0.0
        # the overload controller (runtime/overload.py), set by the server:
        # its read mode lets B1/B2 serve a version-stale cached answer within
        # its staleness bound (cache first) and B3 any cached answer (cache
        # only); those serves are counted
        self.overload = None
        self._read_cache_stale_serves = 0
        # cached dependency answers by window: (value, version, born
        # monotonic), served up to this stale (0: always fresh)
        self._deps_max_stale_ms = float(deps_max_stale_ms)
        self._deps_cache: dict = {}
        self._closed = False
        # the query plane: per-query traces folded at tick cadence, and the
        # aggregator lock's contention ledger, found through self.agg at
        # read time (clear() replaces the aggregator)
        self.querytrace = querytrace.QueryObservatory()
        store = weakref.ref(self)  # no cycle through the store's own plane
        self.querytrace.lock_provider = lambda: getattr(getattr(store(), "agg", None), "lock", None)
        self._query_obs_enabled: Optional[bool] = None
        # the epoch-published read mirror: one publisher (the server's
        # windows ticker, the resume adapter at boot) takes the aggregator
        # lock once an epoch and republishes every demanded read; reads then
        # serve lock-free with a staleness age. Its closures reach the store
        # through this proxy, never a strong reference (no cycle)
        self._weak = weakref.proxy(self)
        self.mirror = ReadMirror(lambda: getattr(store(), "agg", None))
        self._seed_mirror()
        # the publisher into the shared-memory segment reader processes
        # serve from, when one is attached (attach_mirror_segment)
        self._segment_publisher = None
        self._demand_unparsed = 0
        # shaped answers of mirror serves: (generation, {memo key: (raw
        # value, shaped)}), swapped whole when the generation moves
        self._shape_memo: Tuple[int, dict] = (-1, {})
        self._shape_memo_hits = 0
        # the accuracy plane, attached by the server: the host shadow the
        # ingest paths offer their batches to, and its estimator
        self.shadow = None
        self.accuracy = None
        # boot restore figures (port of zipkin_tpu/tpu/store.py:184-195):
        # zeros on a cold boot, set by the resume adapter, and folded into
        # ingest_counters(); restoreFallbacks and generationsQuarantined
        # count the snapshot generations the last boot passed over
        self.restore_stats = {
            "restoreMs": 0.0,
            "walReplayBatches": 0,
            "walReplayMs": 0.0,
            "restoreFallbacks": 0,
            "generationsQuarantined": 0,
        }
        # the at-rest scrubber (runtime/scrub.py), which the resume adapter
        # installs; its counters join ingest_counters()
        self.scrubber = None
        # the multi-process ingest tier (tpu/mp_ingest.py) when one feeds
        # this store: its gauges join ingest_counters(), and the resume
        # adapter drains and closes it on close() if the server did not
        self.mp_ingester = None
        # the disk archive (port of zipkin_tpu/tpu/store.py:198-226): every
        # ingested span's raw bytes behind a trace-id index, so trace reads
        # answer for every acked id the byte budget holds
        self._disk = None
        self._archive_vocab_path = None
        self._archive_vocab_persisted = (0, 0)
        if archive_dir:
            self._disk = SpanArchive(archive_dir, max_bytes=archive_max_bytes,
                                     segment_bytes=archive_segment_bytes)
            self._archive_vocab_path = os.path.join(archive_dir, "vocab.json")
        # ids seen as a local service, and the remote services of each: they
        # answer the name reads without a segment scan (remote names intern
        # into the same table, and only local ones list)
        self._remote_by_svc: dict = {}
        self._local_svc_ids: set = set()
        self._names_count = 0  # entries in the two maps, which only grow
        self._names_lock = threading.Lock()
        # serializes the vocab sidecar's writes, so an older snapshot of the
        # vocab never replaces a newer one
        self._persist_lock = threading.Lock()
        self.timetier = None
        if self.config.timetier_enabled:
            self.timetier = TimeTier(
                self.config,
                directory=os.path.join(archive_dir, "timetier") if archive_dir else None)
        # the archived columns hold vocab ids: an archive-only restart takes
        # them back from the sidecar; a snapshot restore (the resume
        # adapter) then replaces the vocab with the same id stream, and WAL
        # replay re-adds the tail
        self._load_archive_vocab()

    # zt-lint: disable=ZT04 — runs once from __init__, before any other
    # thread holds a reference to the store; _persist_archive_vocab's
    # lock protects later concurrent writers, not construction
    def _load_archive_vocab(self) -> None:
        """Take the vocab and the name maps from the sidecar (port of
        ``zipkin_tpu/tpu/store.py:350-413``); runs once from ``__init__``.
        A sidecar whose crc32 does not match is quarantined and the boot
        goes on as without one."""
        path = self._archive_vocab_path
        if path is None or not os.path.exists(path):
            return
        if len(self.vocab.services) > 1 or self.vocab.num_keys > 1:
            return  # a live vocab wins
        try:
            with open(path) as f:
                meta = json.load(f)
        except (OSError, ValueError):
            logger.warning("archive vocab sidecar unreadable; search over recovered segments "
                           "will miss pre-restart spans")
            return
        want_crc = meta.pop("crc32", None)
        if want_crc is not None:
            got = zlib.crc32(json.dumps(meta, sort_keys=True, separators=(",", ":")).encode())
            if got != int(want_crc):
                logger.warning(
                    "archive vocab sidecar digest mismatch (crc32 %08x != recorded %08x): bit "
                    "rot; quarantining. Search over recovered segments will miss pre-restart "
                    "spans", got, int(want_crc))
                try:
                    os.replace(path, path + ".quarantine")
                except OSError:
                    pass
                return
        v = self.vocab
        v.services._names = list(meta["services"])
        v.services._ids = {n: i for i, n in enumerate(meta["services"]) if i}
        v.span_names._names = list(meta["span_names"])
        v.span_names._ids = {n: i for i, n in enumerate(meta["span_names"]) if i}
        v._key_list = [tuple(k) for k in meta["keys"]]
        v._keys = {tuple(k): i for i, k in enumerate(meta["keys"]) if i}
        with self._names_lock:
            self._local_svc_ids = set(meta.get("local_svc_ids", ()))
            self._remote_by_svc = {int(k): set(vv) for k, vv in meta.get("remote_by_svc", {}).items()}
            self._names_count = len(self._local_svc_ids) + sum(map(len, self._remote_by_svc.values()))
        self._archive_vocab_persisted = self._sidecar_state()

    def _sidecar_state(self) -> Tuple[int, int]:
        """(vocab entries, name-map entries): the sidecar is stale when
        either grew since its last write."""
        v = self.vocab
        with self._names_lock:
            names = self._names_count
        return len(v._key_list) + len(v.services._names) + len(v.span_names._names), names

    def _persist_archive_vocab(self) -> None:
        """Write the vocab sidecar when the vocab or the name maps grew
        since the last write (port of ``zipkin_tpu/tpu/store.py:415-472``,
        which writes only when the vocab grew, so remote-service pairs and
        local ids first seen later were lost at the next archive-only boot):
        a snapshot under the intern lock, then an atomic replace under the
        persist lock, with a crc32 over its canonical payload."""
        if self._archive_vocab_path is None:
            return
        with self._intern_lock:
            if self._sidecar_state() == self._archive_vocab_persisted:
                return  # the common case: no write, no wait on a writer
        v = self.vocab
        with self._persist_lock:
            with self._intern_lock:
                size = self._sidecar_state()
                if size == self._archive_vocab_persisted:
                    return
                with self._names_lock:
                    meta = {
                        "services": list(v.services._names),
                        "span_names": list(v.span_names._names),
                        "keys": [list(k) for k in v._key_list],
                        "local_svc_ids": sorted(self._local_svc_ids),
                        "remote_by_svc": {str(k): sorted(vv) for k, vv in self._remote_by_svc.items()},
                    }
                self._archive_vocab_persisted = size
            meta["crc32"] = zlib.crc32(json.dumps(meta, sort_keys=True, separators=(",", ":")).encode())
            fd, tmp = tempfile.mkstemp(dir=os.path.dirname(self._archive_vocab_path),
                                       suffix=".json.tmp")
            with os.fdopen(fd, "w") as f:
                f.write(json.dumps(meta))  # json.dump's bytes in one write
            os.replace(tmp, self._archive_vocab_path)

    # -- sampling tier hooks ---------------------------------------------

    def on_restored_leaves(self, leaves: dict) -> None:
        """Snapshot-restore callback (port of ``zipkin_tpu/tpu/store.py:476-485``):
        seed the sampling tier's host tables from the restored leaves.
        ``leaves`` maps leaf names to numpy arrays with the leading shard
        axis; the tables are replicated across shards, so shard 0's copy
        seeds them."""
        if self.sampler is None or "s_rate" not in leaves:
            return
        self.sampler.restore_tables(leaves["s_rate"][0], leaves["s_tail"][0], leaves["s_link"][0])

    def apply_sctl(self, delta: dict) -> None:
        """WAL-replay callback: apply one replayed controller publish to the
        host tables at its point of the batch stream."""
        if self.sampler is not None:
            self.sampler.apply_sctl(delta)

    def install_sampler(self) -> None:
        """(Re-)arm the sampling gate: push the host tables to the device
        leaves and attach the sampler to the ingest path. No-op when the
        tier is off."""
        if self.sampler is None:
            return
        self.agg.set_sampler_tables(self.sampler.rate, self.sampler.tail, self.sampler.link)
        self.agg.sampler = self.sampler

    def sampler_rates(self) -> dict:
        """{service: keep fraction} from the published rate table; empty
        when the sampling tier is off."""
        sampler = self.agg.sampler
        if sampler is None:
            return {}
        out = {}
        for name in self.vocab.services.names:
            sid = self.vocab.services.get(name)
            if sid:
                out[name] = float(sampler.rate[sid]) / RATE_ONE
        return out

    # -- SPI factories ---------------------------------------------------

    def span_consumer(self) -> SpanConsumer:
        return self

    def span_store(self) -> SpanStore:
        return self

    def service_and_span_names(self) -> ServiceAndSpanNames:
        return self

    def autocomplete_tags(self) -> AutocompleteTags:
        return self._archive

    # -- write path ------------------------------------------------------

    def accept(self, spans: Sequence[Span]) -> Call[None]:
        def run() -> None:
            # chunks of at most max_batch spans, each one device batch; with
            # sampling on the archive keeps the verdict-kept spans while the
            # device ingests the whole chunk
            for lo in range(0, len(spans), self.max_batch):
                chunk = spans[lo : lo + self.max_batch]
                t0 = time.perf_counter()
                with self._intern_lock:
                    cols = pack_spans(chunk, self.vocab, self._pad)
                obs.record("pack", time.perf_counter() - t0)
                kept = chunk
                if self.agg.sampler is not None:
                    keep = self.agg.sampler.verdict_cols(cols)[: len(chunk)]
                    kept = [s for s, k in zip(chunk, keep) if k]
                if kept:
                    t0 = time.perf_counter()
                    self._archive.accept(kept).execute()
                    if self._disk is not None:
                        self._disk_append_spans(kept)
                    obs.record("archive_write", time.perf_counter() - t0)
                self.agg.ingest(cols)

        return Call.of(run)

    def _disk_append_spans(self, spans: Sequence[Span]) -> None:
        """The object path's disk append (port of
        ``zipkin_tpu/tpu/store.py:552-603``): each span encoded once as JSON
        v2, so the disk archive is complete whichever path ingested it. The
        intern lock covers only the vocab pass; encoding and the write run
        outside it."""
        from zipkin_tpu_torch.model import json_v2

        n = len(spans)
        parts: List[bytes] = []
        off = np.zeros(n, np.uint32)
        ln = np.zeros(n, np.uint32)
        lanes = np.zeros((n, 4), np.uint32)  # tl0 tl1 th0 th1
        svc = np.zeros(n, np.uint32)
        rsvc = np.zeros(n, np.uint32)
        name = np.zeros(n, np.uint32)
        key = np.zeros(n, np.uint32)
        ts_min = np.zeros(n, np.uint32)
        dur = np.zeros(n, np.uint64)
        err = np.zeros(n, bool)
        pos = 0
        for i, s in enumerate(spans):
            enc = json_v2.encode_span(s)
            parts.append(enc)
            off[i] = pos
            ln[i] = len(enc)
            pos += len(enc)
            full = int(normalize_trace_id(s.trace_id), 16)
            lo64, hi64 = full & ((1 << 64) - 1), full >> 64
            lanes[i] = (lo64 & 0xFFFFFFFF, lo64 >> 32, hi64 & 0xFFFFFFFF, hi64 >> 32)
            ts_min[i] = (s.timestamp or 0) // 60_000_000
            dur[i] = s.duration or 0
            err[i] = "error" in (s.tags or {})
        with self._intern_lock:
            for i, s in enumerate(spans):
                sid = self.vocab.services.intern(s.local_service_name)
                rid = self.vocab.services.intern(s.remote_service_name)
                nid = self.vocab.span_names.intern(s.name)
                svc[i], rsvc[i], name[i] = sid, rid, nid
                key[i] = self.vocab.key_id(sid, nid)
        self._track_remotes(svc, rsvc)
        self._disk.append_batch(b"".join(parts), off, ln, lanes[:, 0], lanes[:, 1], lanes[:, 2],
                                lanes[:, 3], svc, rsvc, name, key, ts_min, dur, err)
        self._persist_archive_vocab()

    def ingest_json_fast(self, data: bytes, sampler=None):
        """Line-rate ingest (port of ``zipkin_tpu/tpu/store.py:605``): JSON
        v2 or proto3 ``ListOfSpans`` bytes to the device aggregates through
        the native columnar parser, with no Span objects. The parser records
        each span's byte extent: the disk archive, when there is one, takes
        every span's raw slice, so trace reads and search answer for every
        span; without it a trace-affine 1/N sample is decoded into the host
        archive and they answer for that sample.

        ``sampler`` (a ``CollectorSampler``) drops spans at the boundary
        before anything else sees them. Returns (accepted, sample_dropped),
        or None when the native path cannot take this payload (the caller
        falls back to the object path). A ``ValueError`` comes only from the
        parse, before anything is stored; a failure after it raises
        :class:`FastIngestError`, which the caller must not fall back on."""
        work = self._fast_parse(data, sampler)
        if work is None:
            return None
        accepted, dropped, chunks = work
        try:
            for parsed, cols in chunks:
                self._fast_dispatch(parsed, cols)
        except Exception as e:
            raise FastIngestError(accepted + dropped, f"fast ingest failed after the parse: {e}") from e
        return accepted, dropped

    def _fast_parse(self, data: bytes, sampler=None):
        """Host half of the fast path: native parse + intern, boundary
        sample, chunk and pack, all under the intern lock (the C tables
        are not thread-safe). Returns (accepted, dropped, [(parsed, cols),
        ...]) or None for a payload the parser cannot take."""
        if not native.available():
            return None
        with self._intern_lock:
            if self._nvocab is None:
                self._nvocab = native.NativeVocab(self.vocab)
            t0 = time.perf_counter()
            self._nvocab.ensure_synced()
            parsed = native.parse_spans(data, nvocab=self._nvocab)
            if parsed is None:
                return None
            self._nvocab.sync()
            obs.record("parse", time.perf_counter() - t0)
            n = parsed.n
            dropped = 0
            if sampler is not None and sampler.rate < 1.0 and n:
                keep = native.sampler_keep(parsed, n, sampler._boundary)
                dropped = int(n - keep.sum())
                if dropped:
                    parsed = parsed.select(np.nonzero(keep)[0])
                    n = parsed.n
            if n == 0:
                return 0, dropped, []
            chunks = []
            t0 = time.perf_counter()
            for lo in range(0, n, self.max_batch):
                sub = parsed if n <= self.max_batch else parsed.select(slice(lo, lo + self.max_batch))
                chunks.append((sub, pack_parsed(sub, self.vocab, self._pad)))
            obs.record("pack", time.perf_counter() - t0)
        return n, dropped, chunks

    def _fast_dispatch(self, parsed, cols) -> None:
        """Device half of the fast path: the archive, then the device step.
        With the disk archive on, the payload's raw slices go to disk and
        the host archive's sample is skipped, unless autocomplete keys are
        set (their values come from the host archive only). With the
        sampling tier armed, both archives see only the verdict-kept spans
        (the batch's lanes are the parse's lanes, so one verdict gates
        both) while the device ingests the whole batch, so the sketches
        stay unbiased. An attached shadow is offered the whole batch too."""
        retained = parsed
        if self.agg.sampler is not None:
            keep = self.agg.sampler.verdict_cols(cols)[: parsed.n]
            if not keep.all():
                retained = parsed.select(np.nonzero(keep)[0])
        t0 = time.perf_counter()
        if self._disk is not None:
            rec = parsed_record(retained)
            if rec is not None:
                self.disk_append_record(rec)
            if self.autocomplete_keys:
                self._archive_fast_sample(retained)
        else:
            self._archive_fast_sample(retained)
        obs.record("archive_write", time.perf_counter() - t0)
        if self.shadow is not None:
            # the ground-truth tap: the batch the device sketches see, an
            # O(1) append
            self.shadow.offer_cols(cols)
        self.agg.ingest(cols)

    def disk_append_record(self, rec: tuple) -> None:
        """Append one ``archive.parsed_record`` tuple, its ids in this
        store's vocab, to the disk archive and persist the vocab sidecar if
        the vocab or the name maps grew. The line-rate path passes its own
        chunks; the multi-process tier's dispatcher passes records the
        workers parsed, their worker-local ids already remapped to global
        ones."""
        self._track_remotes(rec[7], rec[8])
        self._disk.append_batch(*rec)
        self._persist_archive_vocab()

    def _track_remotes(self, svc: np.ndarray, rsvc: np.ndarray) -> None:
        pairs = np.unique(svc.astype(np.uint64) << np.uint64(32) | rsvc.astype(np.uint64))
        with self._names_lock:
            for p in pairs.tolist():
                s, r = p >> 32, p & 0xFFFFFFFF
                if s:
                    self._local_svc_ids.add(int(s))
                if s and r:
                    self._remote_by_svc.setdefault(int(s), set()).add(int(r))
            self._names_count = len(self._local_svc_ids) + sum(map(len, self._remote_by_svc.values()))

    def _archive_fast_sample(self, parsed) -> None:
        """Archive a trace-affine 1/N sample of a fast batch at full
        fidelity by decoding each sampled span's own slice of the payload
        (its extent recorded by the parser)."""
        spans = decode_raw_spans(sample_slices(parsed, self._fast_archive_every))
        if spans:
            self._archive.accept(spans).execute()

    def step_lanes(self) -> List[int]:
        """The lane counts a shard's coalesced step pads to: the
        :func:`~zipkin_tpu_torch.tpu.ingest.lane_bucket` ladder from the pad
        multiple to the aggregator's lane cap (a power-of-two payload of at
        least the pad multiple lands on it too)."""
        cap = self.agg.lane_cap
        out, b = [], self._pad
        while b < cap:
            out.append(b)
            b *= 2
        return out + [cap]

    def capture_steps(self, lane_counts: Optional[Sequence[int]] = None) -> int:
        """Capture the aggregator's step graphs, every variant at each of
        ``lane_counts`` (default :meth:`step_lanes`), touching no state: a
        server does this at boot, so no capture lands in a serving window.
        Returns the graphs captured (0 on the CPU)."""
        lanes = list(self.step_lanes() if lane_counts is None else lane_counts)
        made = self.agg.capture_steps(lanes)
        self._captured_lanes = sorted(set(self._captured_lanes) | set(lanes))
        return made

    def warm(self, data: bytes) -> None:
        """Run every ingest-path program once on a real payload (the payload
        is ingested: serving and benchmark warm-up only)."""
        work = self._fast_parse(data)
        if work is not None:
            if work[2]:
                self.agg.warm_programs(work[2][0][1])
            return
        # a payload the fast parser cannot take warms through the object path
        from zipkin_tpu_torch.model import codec

        spans = codec.decode_spans(data)
        self._archive.accept(spans).execute()
        with self._intern_lock:
            cols = pack_spans(spans[: self.max_batch], self.vocab, self._pad)
        self.agg.warm_programs(cols)

    # -- raw trace reads: the disk archive and the host archive ------------

    def _disk_trace_spans(self, trace_id: str, views=None) -> List[Span]:
        """Every archived span of ``trace_id`` under the store's strictness:
        exact low-64 match, and with strict trace ids the high lanes and
        the decoded id too. Pass ``views`` (one ``views()`` of the archive)
        when reading many traces: each call without it sorts the live
        segment again."""
        normalized = normalize_trace_id(trace_id)
        full = int(normalized, 16)
        lo, hi = full & ((1 << 64) - 1), full >> 64
        slices = self._disk.fetch_trace_raw(lo & 0xFFFFFFFF, lo >> 32, hi & 0xFFFFFFFF, hi >> 32,
                                            strict=self.strict_trace_id, views=views)
        spans = []
        for raw in slices:
            try:
                s = _decode_raw_span(raw)
            except Exception:
                continue  # bytes that rotted under a read's retained fd
            if self.strict_trace_id and normalize_trace_id(s.trace_id) != normalized:
                continue
            spans.append(s)
        return spans

    def _trace(self, trace_id: str, views=None) -> List[Span]:
        spans = self._disk_trace_spans(trace_id, views)
        spans += self._archive.get_trace(trace_id).execute()
        return merge_trace(spans)

    def get_trace(self, trace_id: str) -> Call[List[Span]]:
        if self._disk is None:
            return self._archive.get_trace(trace_id)
        return Call.of(lambda: self._trace(trace_id))

    def get_traces(self, trace_ids: Sequence[str]) -> Call[List[List[Span]]]:
        if self._disk is None:
            return self._archive.get_traces(trace_ids)

        def run() -> List[List[Span]]:
            views = self._disk.views()
            out, seen = [], set()
            for tid in trace_ids:
                key = trace_id_key(tid, self.strict_trace_id)
                if key in seen:
                    continue
                seen.add(key)
                spans = self._trace(tid, views)
                if spans:
                    out.append(spans)
            return out

        return Call.of(run)

    def get_traces_query(self, request: QueryRequest) -> Call[List[List[Span]]]:
        if self._disk is None:
            return self._archive.get_traces_query(request)
        return Call.of(lambda: self._disk_query(request) if self.search_enabled else [])

    def _disk_query(self, request: QueryRequest) -> List[List[Span]]:
        """getTraces over the disk archive (port of
        ``zipkin_tpu/tpu/store.py:892-999``): vectorized candidate masks on
        the indexed columns (service, span name, remote service, duration,
        window), then the candidate traces decoded and held to the exact
        ``QueryRequest.test``, so annotationQuery and every other clause
        not indexed are exact by post-filter. Candidates come newest
        segment first and decoding stops once ``limit`` traces pass; when
        the post-filter starves the limit the scan widens once."""
        svc_id = rsvc_id = name_id = None
        if request.service_name:
            svc_id = self.vocab.services.get(request.service_name.lower())
            if svc_id is None:
                return []
        if request.remote_service_name:
            rsvc_id = self.vocab.services.get(request.remote_service_name.lower())
            if rsvc_id is None:
                return []
        if request.span_name:
            name_id = self.vocab.span_names.get(request.span_name.lower())
            if name_id is None:
                return []
        lo_min = epoch_minutes(request.end_ts - request.lookback)
        hi_min = epoch_minutes(request.end_ts)

        def fetch(cand_limit: int) -> Tuple[List[List[Span]], bool]:
            # one views() for the whole query: taking one sorts the live segment
            views = self._disk.views()
            cands = self._disk.candidate_trace_ids(
                ts_lo_min=lo_min, ts_hi_min=hi_min, svc_id=svc_id, rsvc_id=rsvc_id,
                name_id=name_id, min_dur=request.min_duration, max_dur=request.max_duration,
                limit=cand_limit, views=views)
            # the host archive's matches first: its spans of the same traces
            # and traces only it holds
            ram: dict = {}
            for trace in self._archive.get_traces_query(request).execute():
                ram.setdefault(trace_id_key(trace[0].trace_id, self.strict_trace_id), []).extend(trace)
            out, seen_keys = [], set()
            for id64, _ in cands:
                if len(out) >= request.limit:
                    break
                spans = []
                for r in self._disk.fetch_trace_raw(id64 & 0xFFFFFFFF, id64 >> 32, 0, 0,
                                                    strict=False, views=views):
                    try:
                        spans.append(_decode_raw_span(r))
                    except Exception:
                        continue  # bytes that rotted under a read's retained fd
                for group in group_by_trace_id(spans, self.strict_trace_id):
                    key = trace_id_key(group[0].trace_id, self.strict_trace_id)
                    if key in seen_keys:
                        continue
                    seen_keys.add(key)
                    merged = merge_trace(group + ram.pop(key, []))
                    if request.test(merged):
                        out.append(merged)
            # traces the host archive matched and the walk above did not
            # reach may have spans on disk too: a trace returned is complete
            for spans in ram.values():
                merged = merge_trace(spans + self._disk_trace_spans(spans[0].trace_id, views))
                if request.test(merged):
                    out.append(merged)
            out.sort(key=lambda t: max((s.timestamp or 0) for s in t), reverse=True)
            return out[: request.limit], len(cands) >= cand_limit

        results, capped = fetch(request.limit * 4 + 16)
        if capped and len(results) < request.limit:
            results, _ = fetch((request.limit * 4 + 16) * 8)
        return results

    def get_service_names(self) -> Call[List[str]]:
        if self._disk is None:
            return self._archive.get_service_names()

        def run() -> List[str]:
            if not self.search_enabled:
                return []
            # the ids seen as a local service, with no retention cutoff
            with self._names_lock:
                ids = list(self._local_svc_ids)
            return sorted(n for n in {self.vocab.services.lookup(s) for s in ids} if n)

        return Call.of(run)

    def get_remote_service_names(self, service_name: str) -> Call[List[str]]:
        if self._disk is None:
            return self._archive.get_remote_service_names(service_name)

        def run() -> List[str]:
            if not self.search_enabled:
                return []
            sid = self.vocab.services.get(service_name.lower())
            with self._names_lock:
                rids = list(self._remote_by_svc.get(sid or -1, ()))
            names = {self.vocab.services.lookup(r) for r in rids}
            names |= set(self._archive.get_remote_service_names(service_name).execute())
            return sorted(n for n in names if n)

        return Call.of(run)

    def get_span_names(self, service_name: str) -> Call[List[str]]:
        if self._disk is None:
            return self._archive.get_span_names(service_name)

        def run() -> List[str]:
            if not self.search_enabled:
                return []
            sid = self.vocab.services.get(service_name.lower())
            if sid is None:
                return []
            with self.vocab._lock:
                pairs = list(self.vocab._key_list)
            return sorted(n for n in {self.vocab.span_names.lookup(nid) for s, nid in pairs if s == sid}
                          if n)

        return Call.of(run)

    def get_keys(self) -> Call[List[str]]:
        return self._archive.get_keys()

    def get_values(self, key: str) -> Call[List[str]]:
        return self._archive.get_values(key)

    # -- aggregate reads: device ----------------------------------------

    def _cached_read(self, key: str, compute):
        """Memoize a device read until the next query-visible state change:
        the aggregator bumps write_version on a step and a rollup, not on a
        digest flush (which changes no answer). The whole cache drops when
        the version moves, so keys holding windows cannot pile up. A hit
        is the ``query_cached`` stage, a miss ``query_fresh``; the probe is
        a traced query's cache-probe segment.

        Brownout read modes (``zipkin_tpu/tpu/store.py:1066-1126``): entries
        carry the version they were computed at. Under ``cache_first`` a
        version-stale entry younger than the controller's ``max_stale_ms``
        serves; under ``cache_only`` any entry serves; a cold key still
        computes, and the first normal-mode read drops every stale entry."""
        t0 = time.perf_counter()
        t0_ns = time.perf_counter_ns()
        version = self.agg.write_version
        ctl = self.overload
        mode = ctl.read_mode() if ctl is not None else "normal"
        with self._read_cache_lock:
            if mode == "normal" and self._read_cache_version != version:
                self._read_cache.clear()
                self._read_cache_version = version
            hit = self._read_cache.get(key)
            if hit is not None:
                value, born, born_version = hit
                age_ms = (time.monotonic() - born) * 1000.0
                fresh = born_version == version
                if fresh or mode == "cache_only" or (
                        mode == "cache_first" and age_ms <= ctl.max_stale_ms):
                    if not fresh:
                        self._read_cache_stale_serves += 1
                    self._read_cache_age_ms = age_ms
                    self._read_cache_age_max_ms = max(self._read_cache_age_max_ms, age_ms)
                    obs.record("query_cached", time.perf_counter() - t0)
                    querytrace.stamp_active(querytrace.QSEG_CACHE_PROBE, t0_ns,
                                            time.perf_counter_ns())
                    return value
        # the probe ends where compute() begins: the rest of a miss belongs
        # to the dispatch, device-wall, transfer and unpack segments
        querytrace.stamp_active(querytrace.QSEG_CACHE_PROBE, t0_ns, time.perf_counter_ns())
        value = compute()
        obs.record("query_fresh", time.perf_counter() - t0)
        with self._read_cache_lock:
            if mode != "normal" or self._read_cache_version == version:
                self._read_cache[key] = (value, time.monotonic(), version)
        return value

    def invalidate_read_cache(self) -> None:
        """Drop memoized device reads and cached dependency answers (the
        aggregator's link context stays)."""
        with self._read_cache_lock:
            self._read_cache.clear()
            self._deps_cache.clear()

    # -- epoch-published read mirror (port of zipkin_tpu/tpu/store.py:1136-1340)

    def _seed_mirror(self) -> None:
        """Pin the dashboard's default reads into the mirror's demand
        registry, so the first publish (boot, before the ticker starts)
        carries them; the keys are ``_cached_read``'s."""
        w = self._weak
        qs = DEFAULT_QS
        qkey = ",".join(f"{q:.6g}" for q in qs)
        self.mirror.register(f"overview:{qkey}", lambda: w.agg.sketch_overview(qs), pinned=True)
        self.mirror.register("card", lambda: w.agg.cardinalities(), pinned=True)
        self.mirror.register(f"quant:digest:{qkey}", lambda: w.agg.quantiles(qs, source="digest"),
                             pinned=True)

    def publish_mirror(self, force: bool = False, paced: bool = False) -> bool:
        """One mirror epoch (:meth:`ReadMirror.publish`): the windows ticker
        calls it each tick (``paced=True``, the duty-cycle cap), the resume
        adapter at boot. Reader-process demand drains first, so a key a
        reader missed is carried by this very epoch."""
        pub = self._segment_publisher
        if pub is not None:
            for key in pub.drain_demand():
                self.mirror_register_key(key)
        return self.mirror.publish(force=force, paced=paced)

    def attach_mirror_segment(self, segment) -> None:
        """Serialize every mirror epoch into ``segment``
        (:class:`~zipkin_tpu_torch.serving.segment.MirrorSegment`) after the
        snapshot swap, outside the aggregator lock. Call before the boot
        publish, so readers that attach after a crash-resume serve the
        restored epoch."""
        from zipkin_tpu_torch.serving.publisher import SegmentPublisher

        pub = SegmentPublisher(segment)
        self._segment_publisher = pub
        w = self._weak

        def sink(snap) -> None:
            tt = w.timetier
            pub.publish_snapshot(
                snap,
                vocab=w.vocab,
                max_stale_ms=w.mirror.max_stale_ms,
                deps_max_stale_ms=w._deps_max_stale_ms,
                time_bucket_minutes=w.config.time_bucket_minutes,
                global_hll_row=w.config.global_hll_row,
                tt_sealed_through=tt.sealed_through if tt is not None else None,
                counters=w.ingest_counters(),
                mirror_generation=w.mirror.gen,
            )

        self.mirror.segment_sink = sink
        # an idle tick re-stamps the segment's epoch when it is still current:
        # cut at the aggregator's live write version
        self.mirror.segment_restamp = lambda snap: pub.restamp(w.agg.write_version)

    def mirror_register_key(self, key: str) -> bool:
        """Parse a reader-demanded key back into its compute and register it
        (unpinned, expiring). The grammar is the closed set of keys the
        store mints; anything else, tenant-prefixed keys included, is
        refused and counted, never guessed at."""
        w = self._weak
        try:
            if key == "card":
                return self.mirror.register(key, lambda: w.agg.cardinalities())
            if key.startswith("overview:"):
                qs = tuple(float(x) for x in key.split(":", 1)[1].split(",") if x)
                if qs:
                    return self.mirror.register(key, lambda: w.agg.sketch_overview(qs))
            if key.startswith("quant:w:"):
                _, _, lo, hi, qstr = key.split(":", 4)
                lo_min, hi_min = int(lo), int(hi)
                qs = tuple(float(x) for x in qstr.split(",") if x)
                if qs:
                    return self.mirror.register(
                        key, lambda: w.agg.quantiles(qs, ts_lo_min=lo_min, ts_hi_min=hi_min))
            elif key.startswith("quant:"):
                _, src, qstr = key.split(":", 2)
                qs = tuple(float(x) for x in qstr.split(",") if x)
                if src in ("digest", "hist") and qs:
                    return self.mirror.register(key, lambda: w.agg.quantiles(qs, source=src))
            if key.startswith("deps:"):
                _, lo, hi = key.split(":")
                lo_min, hi_min = int(lo), int(hi)
                return self.mirror.register(key, lambda: w._dependency_links(lo_min, hi_min))
            if key.startswith("ttq:") and self.timetier is not None:
                _, lo, hi = key.split(":")
                lo_ep, hi_ep = int(lo), int(hi)
                return self.mirror.register(key, lambda: w.timetier.window(w.agg, lo_ep, hi_ep))
        except (ValueError, TypeError):
            pass
        self._demand_unparsed += 1
        return False

    def _mirror_bound(self, staleness_ms: Optional[float], default_ms: float):
        """The effective bound of a mirror serve, the request's bound folded
        with the brownout read mode: ms the answer may be stale, None for any
        age (B3, cache only), or ``_MIRROR_FRESH`` when the request opted out
        (``staleness_ms <= 0``). Under B1/B2 (cache first) the controller's
        bound can only loosen the request's."""
        if staleness_ms is not None and staleness_ms <= 0:
            return _MIRROR_FRESH
        bound = float(staleness_ms) if staleness_ms is not None else float(default_ms)
        ctl = self.overload
        mode = ctl.read_mode() if ctl is not None else "normal"
        if mode == "cache_first":
            bound = max(bound, float(ctl.max_stale_ms))
        elif mode == "cache_only":
            return None
        return bound

    def _mirror_serve(self, key: str, bound_ms, allow_stale: bool = True):  # zt-mirror-served: the whole point — a mirror serve must never acquire the aggregator lock (ZT10)
        """Serve ``key`` from the published epoch without the aggregator
        lock: a seqlock snapshot read and a staleness check against the
        live write version, stamped as ``query_mirror`` and the traced
        query's mirror-serve segment. None on a miss."""
        mirror = self.mirror
        if not mirror.enabled:
            return None
        t0 = time.perf_counter()
        t0_ns = time.perf_counter_ns()
        hit = mirror.serve(key, bound_ms, self.agg.write_version, allow_stale)
        if hit is None:
            return None
        obs.record("query_mirror", time.perf_counter() - t0)
        querytrace.stamp_active(querytrace.QSEG_MIRROR_SERVE, t0_ns, time.perf_counter_ns())
        return hit

    def _mirror_allow_stale(self, staleness_ms) -> bool:
        """May this request see a version-stale epoch? Yes when the caller
        opted in (a positive ``staleness_ms``), a brownout read mode is in
        force, or the aggregator lock is held by another thread right now (a
        non-blocking probe, which is no acquisition); otherwise an exact
        read is cheap and a default request stays exact."""
        if staleness_ms is not None:
            return True
        ctl = self.overload
        if ctl is not None and ctl.read_mode() != "normal":
            return True
        probe = getattr(self.agg.lock, "would_block", None)
        return bool(probe is not None and probe())

    def _mirror_read(self, key: str, compute, staleness_ms=None, shape=None, shape_key=()):
        """Mirror first: serve from the published epoch when the age
        allows, else register ``compute`` for the next epoch and read
        through the versioned cache (where the aggregator lock is).
        ``compute`` must reach the store weakly (``self._weak``): the
        registry keeps it. With ``shape`` the answer is ``shape(value)``,
        memoized on a mirror serve per generation, key and ``shape_key``."""
        bound = self._mirror_bound(staleness_ms, self.mirror.max_stale_ms)
        if bound is not _MIRROR_FRESH:
            gen = self.mirror.gen
            hit = self._mirror_serve(key, bound, self._mirror_allow_stale(staleness_ms))
            if hit is not None:
                if shape is None:
                    return hit[0]
                return self._shaped(gen, key, shape_key, hit[0], shape)
            self.mirror.register(key, compute)
        value = self._cached_read(key, compute)
        return value if shape is None else shape(value)

    def _shaped(self, gen: int, key: str, shape_key: tuple, raw, shape):
        """``shape(raw)`` for a mirror-served ``raw``, memoized for the
        generation ``gen``: the shaping's Python holds the GIL, which
        concurrent serves of one epoch would otherwise repeat. The key
        carries the vocab's size (a name interned since shapes differently)
        and the entry its raw value, checked by identity."""
        memo_gen, memo = self._shape_memo
        if memo_gen != gen:
            memo = {}
            self._shape_memo = (gen, memo)  # one reference: a racing serve keeps its own
        mkey = (key, shape_key, len(self.vocab.services._names), len(self.vocab._key_list))
        ent = memo.get(mkey)
        if ent is not None and ent[0] is raw:
            self._shape_memo_hits += 1
            return ent[1]
        out = shape(raw)
        if len(memo) < _SHAPE_MEMO_MAX:
            memo[mkey] = (raw, out)
        return out

    # -- time-disaggregated sketch tier ----------------------------------

    def tt_seal(self, limit: Optional[int] = None) -> int:
        """Seal every finished device time bucket into the host time tier
        (a ticker calls this); returns the segments sealed, 0 when the tier
        is off or nothing is due."""
        if self.timetier is None:
            return 0
        return self.timetier.seal_up_to(self.agg, limit=limit)

    def _tt_epochs(self, end_ts: int, lookback: Optional[int]):
        """The bucket-epoch range of a windowed read: every (endTs,
        lookback) whose ends fall in the same buckets maps to one range,
        and so to one cache key."""
        g = self.config.time_bucket_minutes
        lb = lookback if lookback is not None else end_ts
        lo_ep = max(0, epoch_minutes(end_ts - lb) // g)
        hi_ep = max(0, epoch_minutes(end_ts) // g)
        return lo_ep, hi_ep

    def _tt_window(self, lo_ep: int, hi_ep: int, staleness_ms=None):
        """The merged window answer of all three windowed reads, mirror
        first (one ``ttq:`` key an epoch range); a range past
        ``sealed_through`` makes one device read of the unsealed buckets,
        a sealed-only range none."""
        w = self._weak
        return self._mirror_read(
            f"ttq:{lo_ep}:{hi_ep}",
            # w.agg is read at call time: clear() replaces it
            lambda: w.timetier.window(w.agg, lo_ep, hi_ep),
            staleness_ms,
        )

    def _tt_dependency_links(self, ans) -> List[DependencyLink]:
        t0_ns = time.perf_counter_ns()
        dense_c = np.asarray(ans.calls)
        dense_e = np.asarray(ans.errs)
        out: List[DependencyLink] = []
        for p, c in zip(*np.nonzero(dense_c)):
            parent = self.vocab.services.lookup(int(p))
            child = self.vocab.services.lookup(int(c))
            if not parent or not child:
                continue
            out.append(DependencyLink(parent=parent, child=child,
                                      call_count=int(dense_c[p, c]),
                                      error_count=int(dense_e[p, c])))
        querytrace.stamp_active(querytrace.QSEG_LINK_RESOLVE, t0_ns, time.perf_counter_ns())
        return out

    # -- dependencies ----------------------------------------------------

    def get_dependencies(
        self, end_ts: int, lookback: int, staleness_ms: Optional[float] = None,
    ) -> Call[List[DependencyLink]]:
        """Mirror first, within ``staleness_ms`` (None: the dependency
        bound ``_deps_max_stale_ms``; <= 0: a fresh read), then the
        bounded-stale answer cache. Set ``_deps_max_stale_ms`` to 0 for
        answers that are never stale."""
        def run() -> List[DependencyLink]:
            qt = self.querytrace.begin("dependencies")
            try:
                return self._get_dependencies(end_ts, lookback, staleness_ms)
            finally:
                self.querytrace.finish(qt)

        return Call.of(run)

    def _get_dependencies(self, end_ts: int, lookback: int,
                          staleness_ms: Optional[float] = None) -> List[DependencyLink]:
        tt = self.timetier
        if tt is not None:
            lo_ep, hi_ep = self._tt_epochs(end_ts, lookback)
            if lo_ep <= tt.sealed_through:
                # part of the window is sealed: merge the covering segments
                # on the host (exact per-bucket edge counts) instead of
                # linking the span ring
                return self._tt_dependency_links(self._tt_window(lo_ep, hi_ep, staleness_ms))
        lo_min = epoch_minutes(end_ts - lookback)
        hi_min = epoch_minutes(end_ts)
        # mirror first: the epoch carries the resolved link list, so a hit
        # touches neither the aggregator lock nor the answer cache; the
        # dependency bound, not the mirror's, is the default
        bound = self._mirror_bound(staleness_ms, self._deps_max_stale_ms)
        if bound is not _MIRROR_FRESH:
            mkey = f"deps:{lo_min}:{hi_min}"
            hit = self._mirror_serve(mkey, bound)
            if hit is not None:
                return hit[0]
            w = self._weak
            self.mirror.register(mkey, lambda: w._dependency_links(lo_min, hi_min))
        fresh = self.agg.write_version
        now = time.monotonic()
        t0 = time.perf_counter()
        t0_ns = time.perf_counter_ns()
        with self._read_cache_lock:
            hit = self._deps_cache.get((lo_min, hi_min))
            if hit is not None:
                value, version, t = hit
                age_ms = (now - t) * 1000.0
                if version == fresh or age_ms < self._deps_max_stale_ms:
                    self._read_cache_age_ms = age_ms
                    self._read_cache_age_max_ms = max(self._read_cache_age_max_ms, age_ms)
                    obs.record("query_cached", time.perf_counter() - t0)
                    querytrace.stamp_active(querytrace.QSEG_CACHE_PROBE, t0_ns,
                                            time.perf_counter_ns())
                    return value
        querytrace.stamp_active(querytrace.QSEG_CACHE_PROBE, t0_ns, time.perf_counter_ns())
        value = self._dependency_links(lo_min, hi_min, fetch=self._cached_read)
        with self._read_cache_lock:
            self._deps_cache[(lo_min, hi_min)] = (value, fresh, now)
            # prune by age so windows that move with endTs cannot pile up
            for k in [k for k, (_, _, t) in self._deps_cache.items()
                      if (now - t) * 1000.0 >= self._deps_max_stale_ms and k != (lo_min, hi_min)]:
                del self._deps_cache[k]
        return value

    def _dependency_links(self, lo_min: int, hi_min: int, fetch=None) -> List[DependencyLink]:
        """The edge read and its resolution into links. ``fetch`` is the
        read seam: the query path memoizes through ``_cached_read``; the
        mirror's publisher (already inside its one lock hold) reads the
        aggregator directly, so a publish fills no read cache."""
        if fetch is None:
            def fetch(_key, compute):
                return compute()
        # the edges are compacted on the device: [E] vectors, not [S, S]
        idx, calls, errors = fetch(
            f"edges:{lo_min}:{hi_min}", lambda: self.agg.dependency_edges(lo_min, hi_min))
        s = self.config.max_services
        live = calls > 0
        if bool(live.all()) and len(calls) < s * s:
            # every compaction slot is taken: the graph may have more edges
            # than the compaction holds, so read the dense matrices instead
            # of dropping any
            logger.debug("dependency edge compaction full (%d); using dense pull", len(calls))
            dense_c, dense_e = fetch(
                f"depmat:{lo_min}:{hi_min}", lambda: self.agg.dependency_matrices(lo_min, hi_min))
            p_idx, c_idx = np.nonzero(dense_c)
            idx, calls, errors = p_idx * s + c_idx, dense_c[p_idx, c_idx], dense_e[p_idx, c_idx]
            live = calls > 0
        t0_ns = time.perf_counter_ns()
        out: List[DependencyLink] = []
        for flat, n_calls, n_errs in zip(idx[live], calls[live], errors[live]):
            parent = self.vocab.services.lookup(int(flat) // s)
            child = self.vocab.services.lookup(int(flat) % s)
            if not parent or not child:
                continue
            out.append(DependencyLink(parent=parent, child=child,
                                      call_count=int(n_calls), error_count=int(n_errs)))
        querytrace.stamp_active(querytrace.QSEG_LINK_RESOLVE, t0_ns, time.perf_counter_ns())
        return out

    # -- latency percentiles and cardinalities -----------------------------

    def latency_quantiles(
        self,
        qs: Sequence[float],
        service_name: Optional[str] = None,
        span_name: Optional[str] = None,
        use_digest: bool = True,
        end_ts: Optional[int] = None,
        lookback: Optional[int] = None,
        staleness_ms: Optional[float] = None,
    ) -> List[dict]:
        """Latency percentile rows per (service, spanName):
        ``{serviceName, spanName, count, quantiles: {q: µs}}``.

        With ``end_ts``/``lookback`` (epoch ms, as in the query API) the
        rows come from the time tier when its sealer has reached the window
        (per-bucket digests merged over the covering segments), else from
        the time-sliced histograms (``use_digest=False`` forces these).
        ``staleness_ms`` tunes the mirror-first serve: None accepts the
        mirror's bound, a positive value sets it for this request, and
        <= 0 forces a fresh lock-path read."""
        qt = self.querytrace.begin("quantiles")
        try:
            return self._latency_quantiles(qs, service_name, span_name, use_digest, end_ts,
                                           lookback, staleness_ms)
        finally:
            self.querytrace.finish(qt)

    def _latency_quantiles(self, qs, service_name, span_name, use_digest, end_ts, lookback,
                           staleness_ms=None):
        w = self._weak

        def shape(value):
            return self._quantile_rows(qs, value[0], value[1], service_name, span_name)

        if end_ts is None and lookback is not None:
            end_ts = int(time.time() * 1000)  # endTs defaults to now
        qkey = ",".join(f"{q:.6g}" for q in qs)
        if end_ts is not None:
            tt = self.timetier
            lo_ep, hi_ep = self._tt_epochs(end_ts, lookback) if tt is not None else (0, -1)
            if use_digest and tt is not None and lo_ep <= tt.sealed_through:
                ans = self._tt_window(lo_ep, hi_ep, staleness_ms)
                source_q = ttmerge.digest_quantile(ans.digest, qs)
                counts = ttmerge.digest_total(ans.digest)
            else:
                lb = lookback if lookback is not None else end_ts
                lo_min = epoch_minutes(end_ts - lb)
                hi_min = epoch_minutes(end_ts)
                return self._mirror_read(
                    f"quant:w:{lo_min}:{hi_min}:{qkey}",
                    lambda: w.agg.quantiles(qs, ts_lo_min=lo_min, ts_hi_min=hi_min),
                    staleness_ms, shape=shape, shape_key=(service_name, span_name))
            return self._quantile_rows(qs, source_q, counts, service_name, span_name)
        src = "digest" if use_digest else "hist"
        return self._mirror_read(
            f"quant:{src}:{qkey}", lambda: w.agg.quantiles(qs, source=src), staleness_ms,
            shape=shape, shape_key=(service_name, span_name))

    def _quantile_rows(self, qs, source_q: np.ndarray, counts: np.ndarray,
                       service_name: Optional[str], span_name: Optional[str]) -> List[dict]:
        """Shape ([K, Q] quantiles, [K] counts) into API rows over the key
        vocab, keys with no count left out (a traced query's serialize
        segment)."""
        t0_ns = time.perf_counter_ns()
        try:
            return self._quantile_rows_inner(qs, source_q, counts, service_name, span_name)
        finally:
            querytrace.stamp_active(querytrace.QSEG_SERIALIZE, t0_ns, time.perf_counter_ns())

    def _quantile_rows_inner(self, qs, source_q, counts, service_name, span_name) -> List[dict]:
        want_svc = self.vocab.services.get(service_name.lower()) if service_name else None
        if service_name and want_svc is None:
            return []
        with self.vocab._lock:
            pairs = np.asarray(self.vocab._key_list, np.int32)  # [num_keys, 2]
        kids = np.arange(1, pairs.shape[0])
        mask = counts[kids] > 0
        if want_svc is not None:
            mask &= pairs[kids, 0] == want_svc
        if span_name:
            want_name = self.vocab.span_names.get(span_name.lower())
            if want_name is None:
                return []
            mask &= pairs[kids, 1] == want_name
        return [
            {
                "serviceName": self.vocab.services.lookup(int(pairs[kid, 0])),
                "spanName": self.vocab.span_names.lookup(int(pairs[kid, 1])),
                "count": int(counts[kid]),
                "quantiles": {float(q): float(source_q[kid, i]) for i, q in enumerate(qs)},
            }
            for kid in kids[mask]
        ]

    def _cardinality_rows(self, est: np.ndarray) -> dict:
        # past envelope_max the estimator's bias outgrows half its 3-sigma
        # noise gate: such a row reads as a lower bound; count it, say so once
        beyond = int((est > self._hll_envelope_max).sum())
        if beyond:
            self._hll_envelope_exceeded += 1
            if not self._hll_beyond_envelope_rows:
                logger.warning(
                    "%d HLL row(s) estimate beyond the p=%d operating envelope (%.3g): "
                    "bias now dominates noise; treat these cardinalities as lower bounds",
                    beyond, self.config.hll_precision, self._hll_envelope_max)
        self._hll_beyond_envelope_rows = beyond
        out = {"_global": float(est[self.config.global_hll_row])}
        for name in self.vocab.services.names:
            sid = self.vocab.services.get(name)
            if sid:
                out[name] = float(est[sid])
        return out

    def trace_cardinalities(
        self, staleness_ms: Optional[float] = None,
        end_ts: Optional[int] = None, lookback: Optional[int] = None,
    ) -> dict:
        """Estimated distinct traces: ``{"_global": n, service: n, ...}``;
        with ``end_ts``/``lookback`` (epoch ms) over the time tier's
        covering buckets, else over all time; mirror first, within
        ``staleness_ms`` as for :meth:`latency_quantiles`."""
        qt = self.querytrace.begin("cardinalities")
        try:
            if end_ts is None and lookback is not None:
                end_ts = int(time.time() * 1000)
            if end_ts is not None and self.timetier is not None:
                ans = self._tt_window(*self._tt_epochs(end_ts, lookback), staleness_ms)
                return self._cardinality_rows(ttmerge.hll_estimate(ans.hll))
            w = self._weak
            return self._mirror_read("card", lambda: w.agg.cardinalities(), staleness_ms,
                                     shape=self._cardinality_rows)
        finally:
            self.querytrace.finish(qt)

    def sketch_overview(
        self, qs: Sequence[float], service_name: Optional[str] = None,
        span_name: Optional[str] = None, staleness_ms: Optional[float] = None,
    ) -> dict:
        """The sketch page from one device read: ``{"percentiles": rows,
        "cardinalities": dict, "counters": ingest_counters()}``; the packed
        triple mirror first (the rows and the live counters are shaped per
        request)."""
        qt = self.querytrace.begin("overview")
        try:
            qkey = ",".join(f"{q:.6g}" for q in qs)
            w = self._weak

            def shape(value):
                source_q, counts, est = value
                return (self._quantile_rows(qs, source_q, counts, service_name, span_name),
                        self._cardinality_rows(est))

            rows, cards = self._mirror_read(
                f"overview:{qkey}", lambda: w.agg.sketch_overview(qs), staleness_ms,
                shape=shape, shape_key=(service_name, span_name))
            return {"percentiles": rows, "cardinalities": cards, "counters": self.ingest_counters()}
        finally:
            self.querytrace.finish(qt)

    def ingest_counters(self) -> dict:
        """The store's and the aggregator's own counters (host counters are
        exact and do not wrap, unlike the device's u32 counters), the device
        observatory's process-wide totals, the accuracy plane's gauges and
        the query plane's aggregates (its nested ``queryLock`` and
        ``querySegments`` tables are skipped by flat consumers)."""
        agg = self.agg
        dev_totals = OBSERVATORY.totals()
        return {
            **agg.host_counters,
            # hostTransfers / reads ~ 1 is the one-transfer rule
            "hostTransfers": agg.read_stats["host_transfers"],
            "rolledOnlyReads": agg.read_stats["rolled_only_reads"],
            "ctxReads": agg.read_stats["ctx_reads"],
            # process-wide bytes through the readpack chokepoint
            "hostTransferBytes": readpack.transfer_bytes(),
            "deviceProgramCalls": dev_totals["calls"],
            "deviceCompiles": dev_totals["compiles"],
            "deviceRecompiles": dev_totals["recompiles"],
            # lanes the next fresh link read must merge, ctx advances, and
            # the wall of the last one
            "ctxDeltaLanes": agg._lanes_since_rollup,
            "ctxAdvances": agg.ctx_stats["ctx_advances"],
            "ctxMaintenanceMs": agg.ctx_stats["ctx_maintenance_ms"],
            "hllEnvelopeExceeded": self._hll_envelope_exceeded,
            "hllBeyondEnvelopeRows": self._hll_beyond_envelope_rows,
            "serviceVocabOverflow": self.vocab.services.overflow,
            "keyVocabOverflow": self.vocab._overflow,
            # the fast path interns in C; what C rejects never reaches the
            # Python journal, so it is counted apart
            "nativeVocabOverflow": self._nvocab.overflow if self._nvocab is not None else 0,
            **(self.sampling_controller.counters() if self.sampling_controller is not None else {}),
            "readCacheServeAgeMs": round(self._read_cache_age_ms, 3),
            "readCacheServeAgeMaxMs": round(self._read_cache_age_max_ms, 3),
            "readCacheEntries": len(self._read_cache),
            # version-stale answers served under the brownout read modes
            "readCacheStaleServes": self._read_cache_stale_serves,
            # the mirror's publish and serve ledger, staleness at serve
            # (mirrorServeAgeMs backs the query_mirror_staleness SLO)
            **self.mirror.counters(),
            # the segment reader processes serve from: publishes, overflows,
            # demand traffic and the worst live reader's age
            # (readerServeAgeMs backs the reader_staleness SLO)
            "mirrorSegmentSinkErrors": self.mirror.segment_sink_errors,
            "readerDemandUnparsed": self._demand_unparsed,
            **(self._segment_publisher.counters() if self._segment_publisher is not None else {}),
            **(self.timetier.export_counters() if self.timetier is not None else {}),
            **self.restore_stats,
            # what the disk archive holds, dropped, skipped and quarantined
            **(self._disk.counters() if self._disk is not None else {}),
            # what the scrubber verified and pulled from service
            **(self.scrubber.counters() if self.scrubber is not None else {}),
            # the multi-process tier's gauges, when one feeds this store
            **(self.mp_ingester.stats() if self.mp_ingester is not None else {}),
            # relative-error gauges and the shadow's occupancy, when the
            # accuracy plane is attached
            **(self.accuracy.export_counters() if self.accuracy is not None else {}),
            **self.querytrace.counters(),
        }

    def set_query_observatory(self, on: bool) -> None:
        """Turn per-query tracing and the lock ledger on or off together;
        remembered, so :meth:`clear`'s new aggregator (and its new lock)
        gets the same setting."""
        self._query_obs_enabled = bool(on)
        self.querytrace.enabled = bool(on)
        self.agg.lock.set_enabled(on)

    # -- lifecycle -------------------------------------------------------

    def check(self) -> CheckResult:
        try:
            self.agg.block_until_ready()  # the probe: the device answers
            return CheckResult.OK
        except Exception as e:  # pragma: no cover - device failure path
            return CheckResult.failed(e)

    def close(self) -> None:
        self._closed = True
        if self.scrubber is not None:
            self.scrubber.stop()
        if self.sampling_controller is not None:
            self.sampling_controller.stop()
        if self._disk is not None:
            self._disk.close()  # seals the live segment
        self._archive.close()

    def clear(self) -> None:
        """Drop the host archive and reset the device state, on the same
        mesh; the disk archive stays, as in the reference."""
        self._archive.clear()
        self.agg.graphs.drop()  # the new aggregator's leaves are new tensors
        self.agg = TorchAggregator(self.config, mesh=self.agg.mesh)
        if self._captured_lanes:
            self.agg.capture_steps(self._captured_lanes)
        # sealed segments were cut from the old aggregator's buckets
        if self.timetier is not None:
            self.timetier.clear()
        # the new aggregator's write versions start again from 0, so a read
        # cached at version v would serve the new state's version v; the
        # published epoch was cut against versions that no longer compare
        # (its demand keys stay: the next publish refills)
        self.invalidate_read_cache()
        with self._read_cache_lock:
            self._read_cache_version = -1
        self._shape_memo = (-1, {})
        self.mirror.reset()
        # the swap replaced the instrumented lock: drop what was stitched
        # against the old aggregator and reapply the configured setting
        self.querytrace.reset()
        if self._query_obs_enabled is not None:
            self.set_query_observatory(self._query_obs_enabled)

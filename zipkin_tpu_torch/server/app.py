"""The HTTP server: the Zipkin v2 API, the collector's HTTP transport, the
sketch reads, health and metrics (the port's copy of
``zipkin_tpu/server/app.py``, on the standard library's
``http.server.ThreadingHTTPServer`` instead of aiohttp).

Routes and status codes follow the reference:

- ``POST /api/v2/spans``, ``POST /api/v1/spans``: gzip (by its magic, with
  a 256 MiB inflation cap -> 413), Content-Type -> encoding, else sniffed;
  malformed -> 400, throttle shed -> 503,
  admission shed or a full multi-process tier -> 429 with ``Retry-After``,
  ``X-Retry-After-Ms`` and, for a shed, ``X-Shed-Scope`` (``tenant`` or
  ``global``) and ``X-Shed-Tenant``; accepted -> 202;
- ``GET /api/v2/{traces,trace/{id},traceMany,services,spans,remoteServices,
  dependencies,autocompleteKeys,autocompleteValues}``;
- ``GET /api/v2/tpu/{percentiles,cardinalities,counters,overview}`` when the
  storage serves sketch reads, and ``POST /api/v2/tpu/snapshot`` (200
  ``{"snapshot": dir}``, 409 without a checkpoint dir, 501 on a store that
  cannot snapshot);
- ``GET /zipkin``, ``/zipkin/`` and ``/zipkin/static/{name}`` (the built-in
  UI, :mod:`zipkin_tpu_torch.server.ui`, with the reference's
  ``Content-Security-Policy``; an unknown asset is 404) and ``GET
  /config.json`` (the UI's settings, the reference's body);
- ``GET /health``, ``/info`` and ``/metrics`` (the reference's
  ``counter.zipkin_collector.<name>.<transport>`` taxonomy, with the boot's
  restore figures, the scrubber's and archive's quarantine tallies, the
  multi-process tier's pool and acked-span accounting, the query plane's,
  the accuracy plane's, each stage's quantiles and each SLO's verdict as
  gauges);
- ``GET /api/v2/tpu/statusz`` (the observability plane's debug page: the
  flight recorder's stage table, its slow-event ring and its own cost, the
  sampler, durability, windows, SLO, accuracy, device, workers, critpath,
  queries, mirror, serving, overload and incidents sections) and ``GET
  /prometheus`` (the exposition format: the collector's counters, the
  store's flat gauges with the ``critpath``, ``mirror``, ``segment`` and
  ``reader`` families, the stage latency histogram with exemplars, and the
  worker, critical-path segment, query-lock, query-segment, accuracy, SLO,
  ``zipkin_tpu_overload_*`` and ``{tenant=}`` families).

Admission (:mod:`zipkin_tpu_torch.runtime.overload`, on by default as in
the reference, ``TPU_OVERLOAD``): the brownout ladder B0-B3 folds the
windowed signals each tick and gates the collector (value-class admission),
the store's reads (cache first, cache only) and the self-spans; each
transition is an incident. Per-tenant budgets (``TPU_TENANT*``) shed a
flooding tenant alone, by ``X-Tenant-Id``, which the handler puts into
``CURRENT_TENANT`` on the request's thread before the collector runs.
``X-Request-Timeout-Ms`` is a deadline (``TPU_DEADLINES``): a request whose
budget is spent before its dispatch answers 504 with ``X-Deadline-Expired:
1``, counted as ``deadlineExpired``; a malformed or absent header means no
deadline.

The four aggregate routes take ``staleness_ms`` (400 when it is not a
number), passed on only to a store with a read mirror: the bound of a
mirror serve, <= 0 for a fresh read. With ``TPU_MIRROR_SEGMENT_BYTES`` the
resume adapter also publishes each epoch into a shared-memory segment that
``python -m zipkin_tpu_torch.serving`` serves from (statusz's ``serving``
section names it).

With ``TPU_MP_WORKERS`` > 0, the line-rate path on and the device store,
the server builds the multi-process ingest tier
(:mod:`zipkin_tpu_torch.tpu.mp_ingest`): POSTed JSON v2 and proto3 payloads
go to its parse workers and are answered 202 on hand-off.

Each request runs on its own thread. The observability plane's ticker
(``TPU_OBS_WINDOWS``, every ``TPU_OBS_TICK_S``) takes the windowed deltas
and, in the reference's order, rolls up the accuracy plane, stitches the
tier's critical-path ledger, folds the query traces, seals the store's time
tier, publishes a read-mirror epoch (paced), evaluates the SLOs and steps
the overload ladder. ``seal_interval_s`` is the seal's period: on the
ticker the seal runs at the first tick at least that long after the last,
and with the windows off a thread of its own seals every
``seal_interval_s`` (0: no seal on either). A POST's body read is the
critical path's wire anchor (``critpath.WIRE_T0_NS``). With a checkpoint dir another
thread snapshots the store every ``TPU_SNAPSHOT_INTERVAL_S``; the store's
own scrubber thread re-verifies its files every ``TPU_SCRUB_INTERVAL_S``.
``SELF_TRACING_ENABLED`` traces each request into the store, and
``TPU_OBS_SELFSPANS`` publishes over-budget stages as spans.
``stop()`` answers new requests 503, waits for those in flight (the
reference's ``runner.cleanup()``), drains and closes the multi-process tier
within the same limit, stops the scrubber, and takes a final snapshot after
the listener and both tickers have stopped.

The wire collectors beside HTTP, from the reference's environment:
``COLLECTOR_SCRIBE_ENABLED`` starts the scribe server
(:mod:`zipkin_tpu_torch.collector.scribe`, ``COLLECTOR_SCRIBE_PORT``) and
``COLLECTOR_GRPC_ENABLED`` the ``SpanService/Report`` server
(:mod:`zipkin_tpu_torch.server.grpc`, ``COLLECTOR_GRPC_PORT``), both on
one asyncio loop on a thread of its own (``zipkin-transports``) that
``start()`` runs only when one of them is on. Port 0 binds a free port,
read back from ``scribe_port`` and ``grpc_port``. The gRPC collector
shares the HTTP one's sampler, line-rate path, fan-out tier, shadow and
admission; the scribe collector takes the object path with the sampler and
the shadow and, as in the reference, no admission. ``grpc`` is imported
only when gRPC is asked for, and without it ``start()`` refuses. ``stop()``
stops scribe, then gRPC, before the listener's drain, so every frame and
``Report`` answered ``OK`` is in the final snapshot. ``post_hook`` (None on
a normal server; the test kit's failure injection) is consulted by a POST
before its body is read. The routes, the
windows' counter source and the ticker's subscribers reach the server
weakly, so a stopped, dropped server and its
store are freed without the cycle collector.
"""

from __future__ import annotations

import asyncio
import contextvars
import json
import logging
import threading
import time
import weakref
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple
from urllib.parse import parse_qs, unquote, urlsplit

import zipkin_tpu_torch
from zipkin_tpu_torch import obs
from zipkin_tpu_torch.obs import critpath
from zipkin_tpu_torch.collector.core import Collector, CollectorSampler, InMemoryCollectorMetrics
from zipkin_tpu_torch.internal.hex import normalize_trace_id
from zipkin_tpu_torch.model import json_v2
from zipkin_tpu_torch.model.codec import Encoding
from zipkin_tpu_torch.runtime.tenant import CURRENT_TENANT, TENANT_HEADER, normalize_tenant
from zipkin_tpu_torch.server.config import ServerConfig
from zipkin_tpu_torch.storage.memory import InMemoryStorage
from zipkin_tpu_torch.storage.spi import QueryRequest, StorageComponent
from zipkin_tpu_torch.storage.throttle import RejectedExecutionError, ThrottledStorage
from zipkin_tpu_torch.tpu.mp_ingest import IngestBackpressure

logger = logging.getLogger(__name__)

JSON = "application/json"
MAX_BODY = 64 * 1024 * 1024  # compressed request bytes, as the reference's client_max_size
DRAIN_TIMEOUT_S = 30.0  # how long stop() waits for the requests in flight
# the built-in UI's policy (zipkin_tpu/server/app.py:549-557): span fields
# are attacker-controlled and the app renders them, so only same-origin
# scripts run; inline styles stay allowed for the app's positioned bars
UI_CSP = (
    "default-src 'self'; script-src 'self'; style-src 'self' "
    "'unsafe-inline'; img-src 'self' data:; object-src 'none'; "
    "base-uri 'none'; frame-ancestors 'none'"
)
# the caller's X-Request-Timeout-Ms deadline (monotonic s; None: none), set
# by the handler on the request's thread at its earliest instant
REQUEST_DEADLINE: contextvars.ContextVar = contextvars.ContextVar(
    "zipkin_tpu_torch_deadline", default=None)
# gauges of ingest_counters() that /metrics publishes as gauge.zipkin_tpu.<name>
_METRIC_GAUGES = (
    "ctxDeltaLanes", "ctxAdvances", "ctxMaintenanceMs",
    "readCacheServeAgeMs", "readCacheServeAgeMaxMs", "readCacheEntries",
)
_SAMPLER_GAUGES = ("sampledKept", "sampledDropped", "budgetUtilization",
                   "samplerPublishes", "samplerPressure")
# the durability plane: what the scrubber verified and what it and the
# archive pulled from service (zipkin_tpu/server/app.py:1288-1298)
_DURABILITY_GAUGES = ("scrubBytes", "scrubPasses", "scrubCorruptDetected",
                      "segmentsQuarantined", "spansQuarantined",
                      "archiveSegmentsQuarantined", "archiveSpansQuarantined")
# the multi-process tier: pool health, queue posture and the acked-span
# accounting that shows no loss (zipkin_tpu/server/app.py:1212-1219)
_MP_GAUGES = ("mpWorkers", "mpWorkersAlive", "mpQueueDepth", "mpInflight",
              "mpAccepted", "mpSampleDropped", "mpFallbacks", "mpRejected")
# the critical-path stitcher: timeline accounting and the Little's-law
# gauges behind the queue-saturation SLO (zipkin_tpu/server/app.py:1223-1227)
_CRITPATH_GAUGES = ("critpathTimelines", "critpathSkipped", "critpathAbandoned",
                    "critpathReclaimed", "critpathDegraded", "critpathTruncated",
                    "critpathLambdaCps", "critpathLittleL", "critpathWorkerOccupancy",
                    "critpathQueueSaturation", "critpathConservationP50Milli")
# the query plane: stitched query walls and the aggregator lock's ledger
# (zipkin_tpu/server/app.py:1252-1268; the cache-age gauges are above)
_QUERY_GAUGES = ("queryTraces", "queryWallP50Us", "queryWallP99Us", "queryWallMaxUs",
                 "queryConservationP50Milli", "queryLockAcquisitions", "queryLockContended",
                 "queryLockReentries", "queryLockWaiters", "queryLockWaitersHighWater",
                 "queryLockWaitP50Us", "queryLockWaitP99Us", "queryLockWaitMaxUs",
                 "queryLockHoldP50Us", "queryLockHoldP99Us", "queryLockHoldMaxUs")
# the read mirror's cadence, serves and staleness, and scale-out serving's
# segment ledger and reader rollup (zipkin_tpu/server/app.py:1240-1270)
_MIRROR_GAUGES = ("mirrorGeneration", "mirrorPublishes", "mirrorPublishSkips",
                  "mirrorPublishBackoffs", "mirrorPublishMs", "mirrorServes",
                  "mirrorStaleServes", "mirrorMisses", "mirrorServeAgeMs", "mirrorServeAgeMaxMs")
_SERVING_GAUGES = ("segmentGeneration", "segmentPublishes", "segmentPublishErrors",
                   "segmentOverflows", "segmentSkippedKeys", "segmentPayloadBytes",
                   "segmentSerializeMs", "mirrorSegmentSinkErrors", "readerRespawns",
                   "readerDemandRequests", "readerDemandOverflow", "readerDemandUnparsed",
                   "readerServeAgeMs", "readerGenerationLagMax")


class _HTTPServer(ThreadingHTTPServer):
    daemon_threads = True  # a request in flight does not hold the process up
    request_queue_size = 128  # the listen backlog aiohttp uses, not socketserver's 5


class PayloadTooLarge(ValueError):
    """The request body, or its inflated form, is past its cap."""


class BadLength(ValueError):
    """A Content-Length or chunk size that is negative or not a number."""


class RawBody:
    """A route's answer sent as it is: bytes, their type and extra headers."""

    __slots__ = ("body", "ctype", "headers")

    def __init__(self, body: bytes, ctype: str, headers: Optional[Dict[str, str]] = None) -> None:
        self.body, self.ctype, self.headers = body, ctype, headers


class HttpError(Exception):
    """An error answer: status, plain-text body and extra headers."""

    def __init__(self, status: int, text: str, headers: Optional[Dict[str, str]] = None) -> None:
        super().__init__(text)
        self.status = status
        self.text = text
        self.headers = headers or {}


def _weakly(method):
    """``method`` (bound) behind a weak reference to its object: what the
    server hands to its own routes and ticker must not hold it in a
    cycle. A call after the object is gone answers 503."""
    ref = weakref.WeakMethod(method)

    def call(*args):
        m = ref()
        if m is None:
            raise HttpError(503, "server stopped")
        return m(*args)

    call.__name__ = method.__name__
    return call


def build_storage(config: ServerConfig, device=None) -> StorageComponent:
    """STORAGE_TYPE -> StorageComponent: ``mem`` the in-memory store,
    ``tpu`` the resume adapter :class:`zipkin_tpu_torch.storage.tpu.TorchStorage`,
    over the first ``tpu_devices`` cards, a shard each (``TPU_DEVICES``;
    unset: every visible card), or one shard on ``device`` when the caller
    names it (``TPU_DEVICES`` must then be unset). The adapter restores and
    replays the durable dirs, and starts the sampling controller and the
    scrubber. An archive dir that cannot be used (a read-only cwd under the
    fast path's default) degrades to a store without the disk archive, with
    a warning, as the reference's does; nothing else is caught."""
    common = dict(
        strict_trace_id=config.strict_trace_id,
        search_enabled=config.search_enabled,
        autocomplete_keys=config.autocomplete_keys,
    )
    if config.storage_type == "mem":
        return InMemoryStorage(max_span_count=config.mem_max_spans, **common)
    if config.storage_type == "tpu":
        from zipkin_tpu_torch.storage.tpu import TorchStorage
        from zipkin_tpu_torch.tpu.state import AggConfig

        agg_kwargs = dict(config.tpu_agg)
        if config.tpu_sampling:
            # sampling changes the ingest step, so it is an AggConfig field
            agg_kwargs["sampling"] = True
            agg_kwargs["sample_rare_min"] = config.tpu_sampling_rare_min

        def make(archive_dir):
            return TorchStorage(
                config=AggConfig(**agg_kwargs),
                num_devices=config.tpu_devices,
                device=device,
                max_span_count=config.mem_max_spans,
                checkpoint_dir=config.tpu_checkpoint_dir,
                wal_dir=config.tpu_wal_dir,
                wal_fsync=config.tpu_wal_fsync,
                archive_dir=archive_dir,
                archive_max_bytes=config.tpu_archive_max_bytes,
                archive_segment_bytes=config.tpu_archive_segment_bytes,
                snapshot_keep=config.tpu_snapshot_keep,
                scrub_interval_s=config.tpu_scrub_interval_s,
                scrub_bytes_per_sec=config.tpu_scrub_bytes_per_sec,
                fast_archive_sample=config.tpu_fast_archive_sample,
                max_device_batch=config.tpu_max_device_batch,
                deps_max_stale_ms=config.tpu_deps_max_stale_ms,
                sampling_budget=config.tpu_sampling_budget if config.tpu_sampling else 0.0,
                sampling_interval_s=config.tpu_sampling_interval_s,
                sampling_min_rate=config.tpu_sampling_min_rate,
                sampling_tail_quantile=config.tpu_sampling_tail_quantile,
                mirror_segment_bytes=config.tpu_mirror_segment_bytes,
                mirror_segment_readers=config.tpu_readers,
                **common,
            )

        if config.tpu_archive_dir:
            logger.info("span archive: %s (budget %d bytes)", config.tpu_archive_dir,
                        config.tpu_archive_max_bytes)
            try:
                return make(config.tpu_archive_dir)
            except OSError as e:
                logger.warning("span archive dir %s unusable (%s); serving without the disk "
                               "archive", config.tpu_archive_dir, e)
        return make(None)
    raise ValueError(f"unknown STORAGE_TYPE: {config.storage_type}")


def parse_annotation_query(raw: Optional[str]) -> Dict[str, str]:
    """Parse ``"error and http.method=GET"`` into ``{error: '', http.method:
    'GET'}``: the upstream annotationQuery grammar."""
    out: Dict[str, str] = {}
    if not raw:
        return out
    for token in raw.split(" and "):
        token = token.strip()
        if not token:
            continue
        key, sep, value = token.partition("=")
        out[key] = value if sep else ""
    return out


def _quantile_list(raw: str):
    qs = [float(x) for x in raw.split(",") if x]
    if not qs or any(not (0.0 <= q <= 1.0) for q in qs):
        raise ValueError(f"q out of range: {raw!r}")
    return qs


def _opt_int(query: Dict[str, str], name: str) -> Optional[int]:
    raw = query.get(name)
    return int(raw) if raw is not None else None


class ZipkinServer:
    """Wires storage, collector and routes; owns their lifecycle.

    ``start()`` binds ``config.host:config.port`` (port 0: an ephemeral
    port, read back from ``self.port``) and serves on a thread;
    ``stop()`` shuts the listener down, takes the final snapshot and closes
    the storage. ``device`` is where a store built here lives (the card
    unless named). ``seal_interval_s`` is the time tier's seal period (0:
    no seal): with the windows on, the seal rides their ticker at the first
    tick at least ``seal_interval_s`` after the last seal; with them off
    (``TPU_OBS_WINDOWS=0``) a thread of its own seals every
    ``seal_interval_s``. A device store captures its step graphs here, at
    the lane counts it pads to (``TorchStorage.capture_steps``), so no
    capture lands in a request."""

    MAX_INFLATED = 256 * 1024 * 1024  # decompression-bomb guard

    def __init__(self, config: Optional[ServerConfig] = None, *,
                 storage: Optional[StorageComponent] = None, seal_interval_s: float = 1.0,
                 device=None) -> None:
        self.config = config or ServerConfig()
        self.storage = storage if storage is not None else build_storage(self.config, device)
        core = getattr(self.storage, "delegate", self.storage)
        if hasattr(core, "capture_steps"):
            # every step variant at the lanes the store pads to, before the
            # first request (nothing to capture on the CPU)
            captured = core.capture_steps()
            if captured:
                logger.info("captured %d step graphs at %s lanes a shard", captured,
                            core.step_lanes())
        if self.config.throttle_enabled:
            self.storage = ThrottledStorage(
                self.storage, max_concurrency=self.config.throttle_max_concurrency)
        self.metrics = InMemoryCollectorMetrics()
        sampler = CollectorSampler(self.config.sample_rate)
        http_metrics = self.metrics.for_transport("http")
        self._mp_ingester = self._build_mp_ingester(sampler, http_metrics)
        self.collector = Collector(
            self.storage,
            sampler=sampler,
            metrics=http_metrics,
            fast_ingest=self.config.tpu_fast_ingest,
            mp_ingester=self._mp_ingester,
        )
        self.components = {self.config.storage_type: self.storage}
        self.seal_interval_s = seal_interval_s
        self._last_seal = float("-inf")
        self._build_obs_plane()
        self._build_admission()
        self.port: Optional[int] = None
        self._httpd: Optional[_HTTPServer] = None
        self._threads = []
        self._stopping = threading.Event()
        # requests in flight, and whether stop() turns new ones away
        # (draining) or stopped waiting for them (abandoned)
        self._inflight = 0
        self._idle = threading.Condition()
        self._draining = self._abandoned = False
        w = _weakly
        routes = {
            "/api/v2/traces": self.get_traces,
            "/api/v2/traceMany": self.get_trace_many,
            "/api/v2/services": self.get_services,
            "/api/v2/spans": self.get_span_names,
            "/api/v2/remoteServices": self.get_remote_services,
            "/api/v2/dependencies": self.get_dependencies,
            "/api/v2/autocompleteKeys": self.get_autocomplete_keys,
            "/api/v2/autocompleteValues": self.get_autocomplete_values,
            "/health": self.get_health,
            "/info": self.get_info,
            "/metrics": self.get_metrics,
            "/prometheus": self.get_prometheus,
            "/config.json": self.get_ui_config,
            "/zipkin": self.get_ui,
            "/zipkin/": self.get_ui,
            # the recorder is process-global: served whatever the store
            "/api/v2/tpu/statusz": self.get_tpu_statusz,
        }
        if hasattr(self.storage, "latency_quantiles"):
            routes.update({
                "/api/v2/tpu/percentiles": self.get_tpu_percentiles,
                "/api/v2/tpu/cardinalities": self.get_tpu_cardinalities,
                "/api/v2/tpu/counters": self.get_tpu_counters,
                "/api/v2/tpu/overview": self.get_tpu_overview,
            })
        self.get_routes = {path: w(fn) for path, fn in routes.items()}
        # path -> handler(body, content_type, t0), t0 the perf_counter at
        # which the request's body read began. The snapshot route is served
        # on every store, so one that cannot snapshot answers 501 (the
        # reference serves it only beside the sketch reads: 404 on mem)
        snap, post = w(self.post_tpu_snapshot), w(self.post_spans)
        self.post_routes = {"/api/v2/tpu/snapshot": lambda body, ctype, t0: snap()}
        if self.config.http_collector_enabled:
            self.post_routes.update({
                "/api/v2/spans": lambda body, ctype, t0: post(body, ctype, False, t0),
                "/api/v1/spans": lambda body, ctype, t0: post(body, ctype, True, t0),
            })
        self._snapshots = False  # a periodic snapshot thread runs
        # the scribe and gRPC servers and the loop that hosts them
        self._transport_loop: Optional[asyncio.AbstractEventLoop] = None
        self._transport_thread: Optional[threading.Thread] = None
        self._scribe = self._grpc = None
        self.scribe_port: Optional[int] = None
        self.grpc_port: Optional[int] = None
        # (handler, path) -> True when it answered the POST itself; the
        # test kit's failure injection (None: one attribute read a POST)
        self.post_hook = None

    def _build_mp_ingester(self, sampler, metrics):
        """The multi-process tier for ``TPU_MP_WORKERS`` > 0, over the core
        device store (behind a throttle, its ``delegate``) with the native
        codec and the line-rate path on; otherwise None, with the
        reference's warning. The store then carries the tier as
        ``mp_ingester``: its gauges join ``ingest_counters()``, and the
        resume adapter's ``close()`` drains and closes it if ``stop()`` did
        not."""
        cfg = self.config
        if cfg.tpu_mp_workers <= 0:
            return None
        from zipkin_tpu_torch import native
        from zipkin_tpu_torch.tpu.store import TorchStorage as _CoreStorage

        core = getattr(self.storage, "delegate", self.storage)
        if not (isinstance(core, _CoreStorage) and native.available() and cfg.tpu_fast_ingest):
            logger.warning(
                "TPU_MP_WORKERS=%d ignored: requires STORAGE_TYPE=tpu, the native codec, and "
                "TPU_FAST_INGEST=true (the MP tier is the fast path's scale-out)",
                cfg.tpu_mp_workers)
            return None
        from zipkin_tpu_torch.tpu.mp_ingest import MultiProcessIngester

        ing = MultiProcessIngester(
            core, workers=cfg.tpu_mp_workers, sampler=sampler,
            queue_depth=cfg.tpu_mp_queue_depth, ring_slots=cfg.tpu_mp_ring_slots,
            coalesce_max=cfg.tpu_mp_coalesce_max, metrics=metrics,
            # the critical-path ledger's slots (0: no tracing)
            critpath_slots=cfg.obs_critpath_slots if cfg.obs_critpath_enabled else 0,
            critpath_reclaim_s=cfg.obs_critpath_reclaim_s)
        core.mp_ingester = ing
        return ing

    def _build_obs_plane(self) -> None:
        """The observability plane over this server's store (the reference
        builds it in ``ZipkinServer.__init__``): self-tracing, slow-stage
        self-spans (the slowest critical-path and query timelines ride
        them), the query plane's setting, the read mirror's posture, and
        with the windows on the ticker's subscribers in the reference's
        order (accuracy rollup, critical-path stitch, query stitch,
        time-tier seal, mirror publish, then the SLO watchdog, whose trips
        write incident bundles)."""
        cfg = self.config
        core = getattr(self.storage, "delegate", self.storage)
        self._self_tracer = None
        if cfg.self_tracing_enabled:
            from zipkin_tpu_torch.server.self_tracing import SelfTracer

            self._self_tracer = SelfTracer(
                Collector(self.storage, metrics=self.metrics.for_transport("self")),
                sample_rate=cfg.self_tracing_sample_rate)
        self._obs_emitter = None
        if cfg.obs_selfspans_enabled:
            from zipkin_tpu_torch.obs.selfspans import SelfSpanEmitter

            # over-budget stages become spans of zipkin-tpu-pipeline through
            # the object path: the tracer tracing itself
            self._obs_emitter = SelfSpanEmitter(
                Collector(self.storage, metrics=self.metrics.for_transport("obs")),
                budget_scale=cfg.obs_budget_scale)
            self._obs_emitter.install(obs.RECORDER)
        self._critpath = getattr(self._mp_ingester, "critpath", None)
        if self._critpath is not None and self._obs_emitter is not None:
            self._critpath.emitter = self._obs_emitter
        self._querytrace = getattr(core, "querytrace", None)
        if hasattr(core, "set_query_observatory"):
            core.set_query_observatory(cfg.obs_query_enabled)
        if self._querytrace is not None and self._obs_emitter is not None:
            self._querytrace.emitter = self._obs_emitter
        # the configured posture, before any ticker or route reads the mirror
        self._mirror = getattr(core, "mirror", None)
        if self._mirror is not None:
            self._mirror.enabled = bool(cfg.tpu_read_mirror)
            self._mirror.max_stale_ms = float(cfg.tpu_mirror_max_stale_ms)
        self._obs_windows = self._obs_slo = self._obs_shadow = None
        self._accuracy = self._obs_incidents = None
        self._seal_on_ticker = False
        if not cfg.obs_windows_enabled:
            return
        from zipkin_tpu_torch.obs.windows import WindowedTelemetry

        self._obs_windows = windows = WindowedTelemetry(
            obs.RECORDER, _weakly(self._window_counter_source), tick_s=cfg.obs_windows_tick_s)
        # the ticker's subscribers reach the store weakly: the windows and
        # the watchdog hold each other, a cycle the store must not be in
        core_ref = weakref.ref(core)

        def on_core(fn):
            def tick(_w):
                c = core_ref()
                if c is not None:
                    fn(c)
            return tick
        if cfg.obs_shadow_enabled and hasattr(core, "agg") and hasattr(core, "vocab"):
            from zipkin_tpu_torch.obs.accuracy import AccuracyEstimator
            from zipkin_tpu_torch.obs.shadow import HostShadow

            self._obs_shadow = shadow = HostShadow(
                reservoir_k=cfg.obs_shadow_reservoir_k,
                distinct_k=cfg.obs_shadow_distinct_k,
                link_rate=cfg.obs_shadow_link_rate,
                pending_max=cfg.obs_shadow_pending_max,
                max_services=core.config.max_services,
                # read through core.agg at call time: clear() replaces it;
                # weakly, as core holds the shadow
                sampler_ref=lambda: getattr(getattr(core_ref(), "agg", None), "sampler", None),
                # get, never intern: a read-side plane must not move the ids
                svc_resolver=core.vocab.services.get,
                bucket_minutes=(core.config.time_bucket_minutes
                                if getattr(core, "timetier", None) is not None else 0),
            )
            self._accuracy = accuracy = AccuracyEstimator(
                core, shadow, rollup_s=cfg.obs_shadow_rollup_s)
            core.shadow = shadow
            core.accuracy = accuracy
            self.collector.shadow = shadow
            if self._mp_ingester is not None:
                self._mp_ingester.shadow = shadow
            windows.on_tick(lambda _w: accuracy.maybe_rollup())
        if self._critpath is not None:
            # before the watchdog: the fold feeds wire_to_durable and the
            # saturation gauges it reads
            windows.on_tick(self._critpath.on_tick)
        if self._querytrace is not None and cfg.obs_query_enabled:
            windows.on_tick(self._querytrace.on_tick)
        if getattr(core, "timetier", None) is not None and self.seal_interval_s > 0:
            # one ticker thread touches the card for the seal, as the
            # reference's; the plain seal loop runs only with the windows off
            self._seal_on_ticker = True
            seal_due = weakref.WeakMethod(self._seal_if_due)

            def seal(c):
                m = seal_due()
                if m is not None:
                    m(c)
            windows.on_tick(on_core(seal))
        if self._mirror is not None and self._mirror.enabled:
            # after the seal, so a windowed key's epoch serves sealed
            # segments; paced: the publisher's lock duty cycle stays <= 50%
            windows.on_tick(on_core(lambda c: c.publish_mirror(paced=True)))
        if cfg.obs_slo_enabled:
            from zipkin_tpu_torch.obs.slo import SloWatchdog, default_specs

            self._obs_slo = SloWatchdog(windows, default_specs(
                short_s=cfg.obs_slo_short_s, long_s=cfg.obs_slo_long_s,
                burn_threshold=cfg.obs_slo_burn_threshold))
            if cfg.obs_incident_dir:
                from zipkin_tpu_torch.obs.incidents import IncidentRecorder

                # an SLO trip keeps the volatile planes before they rotate
                self._obs_incidents = IncidentRecorder(
                    cfg.obs_incident_dir, retention=cfg.obs_incident_retention)
                self._wire_incident_sources(core)
                self._obs_slo.on_trip.append(self._obs_incidents.on_slo_trip)

    def _build_admission(self) -> None:
        """The overload controller and the tenant table
        (``zipkin_tpu/server/app.py:383-489``): built without the windows
        too (tests and embedders drive ``evaluate`` themselves); with them,
        the controller steps after the stitchers and the watchdog on each
        tick, reading the gauges that tick folded. It gates the collector,
        the store's read modes and the self-spans; each transition is an
        incident."""
        cfg = self.config
        self._overload = None
        if not cfg.overload_enabled:
            return
        from zipkin_tpu_torch.runtime.overload import OverloadController

        core = getattr(self.storage, "delegate", self.storage)
        rc = getattr(core, "sampling_controller", None)
        ctl = self._overload = OverloadController(
            enter=(cfg.overload_enter_b1, cfg.overload_enter_b2, cfg.overload_enter_b3),
            exit_margin=cfg.overload_exit_margin,
            dwell_ticks=cfg.overload_dwell_ticks,
            max_stale_ms=cfg.overload_max_stale_ms,
            retry_base_s=cfg.overload_retry_base_s,
            # B2's bulk sheds nudge the sampling tier's pressure hook, so a
            # sustained overload lowers sampling rates instead of adding 429s
            rate_controller=rc,
        )
        self.collector.overload = ctl
        if hasattr(core, "overload"):
            core.overload = ctl
        if self._obs_emitter is not None:
            # B1 sheds the self-spans first
            self._obs_emitter.gate = ctl.shed_observability
        if self._obs_windows is not None:
            self._obs_windows.on_tick(ctl.on_tick)
        if self._obs_incidents is not None:
            rec = self._obs_incidents
            rec.add_source("overload", ctl.status)
            ctl.on_transition.append(lambda ev: rec.capture({
                "kind": "overload_transition",
                "name": f"overload-{ev['from']}-to-{ev['to']}", **ev}))
        if not cfg.tenant_enabled:
            return
        from zipkin_tpu_torch.runtime.tenant import TenantAdmission

        # built with a zero budget too (accounting only), so the tenant
        # counters and statusz rows always publish
        retained = None
        if cfg.tenant_retained_spans_per_s > 0:
            from zipkin_tpu_torch.sampling.controller import TenantBudgetTable

            # charged at the dispatcher's ack (span counts are known only
            # after the parse), consulted by admit() before more bytes
            retained = TenantBudgetTable(spans_per_s=cfg.tenant_retained_spans_per_s,
                                         burst_s=cfg.tenant_ingest_burst_s,
                                         max_tenants=cfg.tenant_max)
            if rc is not None:
                rc.tenant_table = retained
        ta = ctl.tenant_admission = TenantAdmission(
            bytes_per_s=cfg.tenant_ingest_bytes_per_s,
            burst_s=cfg.tenant_ingest_burst_s,
            max_tenants=cfg.tenant_max,
            flood_ratio=cfg.tenant_flood_ratio,
            dwell_ticks=cfg.tenant_dwell_ticks,
            retained_table=retained,
        )
        if self._mp_ingester is not None:
            self._mp_ingester.tenant_sink = ta.note_retained
        if self._obs_slo is not None and cfg.tenant_slo_tenants:
            from zipkin_tpu_torch.obs.slo import tenant_specs

            # one shed-ratio spec a TPU_TENANT_SLO entry, over that
            # tenant's own counters
            for t in cfg.tenant_slo_tenants:
                for spec in tenant_specs(t, short_s=cfg.obs_slo_short_s,
                                         long_s=cfg.obs_slo_long_s,
                                         burn_threshold=cfg.obs_slo_burn_threshold):
                    self._obs_slo.add_spec(spec)

    # -- deadlines and backoff guidance -----------------------------------

    def _check_deadline(self) -> None:
        """504 when the caller's ``X-Request-Timeout-Ms`` budget is spent
        (``zipkin_tpu/server/app.py:729-741``), counted on the controller as
        ``deadlineExpired``; called right before a route's dispatch."""
        deadline = REQUEST_DEADLINE.get()
        if deadline is None or time.monotonic() <= deadline:
            return
        if self._overload is not None:
            self._overload.note_deadline_expired()
        raise HttpError(504, "deadline expired before dispatch", {"X-Deadline-Expired": "1"})

    def _backoff_headers(self, exc=None) -> Dict[str, str]:
        """Retry guidance for a 429 (``zipkin_tpu/server/app.py:743-776``):
        ``Retry-After`` in whole seconds (rounded up), ``X-Retry-After-Ms``
        to the ms. A shed's own delay is the one its control computed (a
        tenant's bucket deficit, or the ladder's jittered backoff); a full
        tier's comes from the ladder. ``X-Shed-Scope`` and
        ``X-Shed-Tenant`` say which control refused the payload."""
        delay_s = getattr(exc, "retry_after_s", None)
        scope = getattr(exc, "scope", None)
        tenant = getattr(exc, "tenant", None)
        if delay_s is None:
            if self._overload is None:
                return {}
            delay_s = self._overload.retry_after_s(tenant if scope == "tenant" else None)
        headers = {"Retry-After": str(max(1, int(-(-delay_s // 1)))),
                   "X-Retry-After-Ms": str(int(delay_s * 1000.0))}
        if scope:
            headers["X-Shed-Scope"] = str(scope)
        if tenant:
            headers["X-Shed-Tenant"] = str(tenant)
        return headers

    def _window_counter_source(self) -> dict:
        """What the windowed plane samples each tick: the collector's
        tallies summed over transports (the wire-to-ack SLO's numerators)
        and the store's flat ingest counters."""
        sums = {"messages": 0, "messages_dropped": 0, "spans": 0, "spans_dropped": 0}
        for key, value in self.metrics.snapshot().items():
            _, _, name = key.partition(".")
            if name in sums:
                sums[name] += value
        out = {
            "collectorMessages": sums["messages"],
            "collectorMessagesDropped": sums["messages_dropped"],
            "collectorSpans": sums["spans"],
            "collectorSpansDropped": sums["spans_dropped"],
        }
        if hasattr(self.storage, "ingest_counters"):
            try:
                out.update(self.storage.ingest_counters())
            except Exception:  # a counter source must not stop the tick
                logger.exception("ingest_counters failed in the windows tick")
        # the admission counters, tenantOffered_<slug> / tenantShed_<slug>
        # among them: the tenant shed-ratio SLOs burn against these
        if self._overload is not None:
            try:
                out.update(self._overload.counters())
            except Exception:
                logger.exception("overload counters failed in the windows tick")
        return out

    def _windows_catch_up(self) -> None:
        """Keep the windows and SLOs fresh on a server whose ticker is not
        running (one that was never started)."""
        w = self._obs_windows
        if w is not None and not w.ticker_running:
            w.tick_if_due()

    def _wire_incident_sources(self, core) -> None:
        """What an incident bundle keeps: statusz-like dicts, each built in
        its own try by the recorder."""
        rec = self._obs_incidents
        rec.add_source("slo", self._obs_slo.status)
        rec.add_source("windows", self._obs_windows.status)
        rec.add_source("stages", lambda: {
            st.stage: {"count": st.count, "p50Us": st.p50_us, "p99Us": st.p99_us,
                       "maxUs": st.max_us}
            for st in obs.RECORDER.snapshot().nonzero()
        })
        rec.add_source("slowRing", obs.RECORDER.slow_events)
        if hasattr(core, "ingest_counters"):
            core_ref = weakref.ref(core)
            rec.add_source("counters", lambda: core_ref().ingest_counters())
        if self._querytrace is not None:
            rec.add_source("queries", self._querytrace.waterfall)
        if self._critpath is not None:
            rec.add_source("critpath", self._critpath.waterfall)

    def _close_mp_ingester(self, deadline: float) -> None:
        """Drain the tier until ``deadline`` (monotonic), so every 202 it
        answered is in the store, then close it whatever the drain did: the
        close joins the workers and unlinks the shared segment."""
        ing, self._mp_ingester = self._mp_ingester, None
        if ing is None:
            return
        try:
            ing.drain(timeout=max(0.0, deadline - time.monotonic()))
        except Exception:
            logger.exception("mp-ingest drain failed during stop")
        finally:
            ing.close()
            core = getattr(self.storage, "delegate", self.storage)
            if getattr(core, "mp_ingester", None) is ing:
                core.mp_ingester = None

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "ZipkinServer":
        grpc_server = None
        if self.config.grpc_collector_enabled:
            # before anything binds: a server asked for gRPC never boots
            # without it
            try:
                from zipkin_tpu_torch.server import grpc as grpc_server
            except ImportError as e:
                raise RuntimeError(
                    "COLLECTOR_GRPC_ENABLED is set but the grpc package cannot be imported "
                    f"({e}); install grpc or unset COLLECTOR_GRPC_ENABLED") from e
        self._httpd = _HTTPServer((self.config.host, self.config.port),
                                  _handler_for(weakref.ref(self)))
        self.port = self._httpd.server_address[1]
        self._stopping.clear()
        with self._idle:
            # a restart after stop(): late handler threads of the last run
            # read these under the same lock
            self._draining = self._abandoned = False
        self._threads = [threading.Thread(target=self._httpd.serve_forever, name="zipkin-http",
                                          daemon=True)]
        core = getattr(self.storage, "delegate", self.storage)
        if (getattr(core, "timetier", None) is not None and self.seal_interval_s > 0
                and not self._seal_on_ticker):
            self._threads.append(threading.Thread(target=self._seal_loop, args=(core,),
                                                  name="zipkin-tt-seal", daemon=True))
        self._snapshots = (self.config.tpu_snapshot_interval_s > 0
                           and bool(getattr(core, "checkpoint_dir", None))
                           and hasattr(core, "snapshot"))
        if self._snapshots:
            # periodic snapshots bound the WAL (covered segments are deleted)
            # and the replay after a crash
            self._threads.append(threading.Thread(
                target=self._snapshot_loop, args=(core, self.config.tpu_snapshot_interval_s),
                name="zipkin-snapshot", daemon=True))
        if grpc_server is not None or self.config.scribe_enabled:
            # every listener is bound before the HTTP server answers, so a
            # /health that says UP means the scribe and gRPC ports take
            # connections too
            try:
                self._start_transports(grpc_server)
            except BaseException:
                self._stopping.set()
                self._stop_transports()
                self._httpd.server_close()
                self._httpd = None
                raise
        for t in self._threads:
            t.start()
        if self._obs_windows is not None:
            self._obs_windows.start_ticker()
        logger.info("zipkin-tpu-torch listening on %s:%d", self.config.host, self.port)
        return self

    def _on_transports(self, coro, timeout: float = DRAIN_TIMEOUT_S):
        return asyncio.run_coroutine_threadsafe(coro, self._transport_loop).result(timeout)

    def _start_transports(self, grpc_server) -> None:
        """The transport loop's thread, then the gRPC server and the scribe
        server on it, with their collectors built as the reference's
        (``zipkin_tpu/server/app.py:586-628``)."""
        loop = self._transport_loop = asyncio.new_event_loop()
        t = threading.Thread(target=_run_loop, args=(loop,), name="zipkin-transports",
                             daemon=True)
        t.start()
        self._transport_thread = t
        cfg = self.config
        if grpc_server is not None:
            collector = Collector(
                self.storage, sampler=self.collector.sampler,
                metrics=self.metrics.for_transport("grpc"),
                fast_ingest=cfg.tpu_fast_ingest, mp_ingester=self._mp_ingester,
                shadow=self._obs_shadow)
            # the same admission as HTTP: no transport-shaped hole in the ladder
            collector.overload = self._overload
            self._grpc = grpc_server.GrpcCollectorServer(
                collector, host=cfg.host, port=cfg.grpc_port,
                deadlines=cfg.deadline_propagation_enabled)
            self._on_transports(self._grpc.start())
            self.grpc_port = self._grpc.port
        if cfg.scribe_enabled:
            from zipkin_tpu_torch.collector.scribe import ScribeCollector

            # no overload controller, as the reference builds it: scribe
            # bypasses admission there, and the port keeps that
            collector = Collector(
                self.storage, sampler=self.collector.sampler,
                metrics=self.metrics.for_transport("scribe"), shadow=self._obs_shadow)
            self._scribe = ScribeCollector(collector, host=cfg.host, port=cfg.scribe_port)
            self._on_transports(self._scribe.start())
            self.scribe_port = self._scribe.port
            self.components["scribe"] = self._scribe

    def _stop_transports(self) -> None:
        """Scribe, then gRPC (the reference's order), then the loop; the
        loop's worker threads are joined, so every accept they ran has
        returned."""
        loop = self._transport_loop
        if loop is None:
            return
        for name in ("_scribe", "_grpc"):
            server = getattr(self, name)
            if server is not None:
                try:
                    self._on_transports(server.stop())
                except Exception:
                    logger.exception("stopping the %s collector failed", name[1:])
                setattr(self, name, None)
        self.components.pop("scribe", None)
        loop.call_soon_threadsafe(loop.stop)
        self._transport_thread.join(timeout=DRAIN_TIMEOUT_S)
        self._transport_loop = None

    def _seal_if_due(self, core) -> None:
        """The ticker's seal: at most once a ``seal_interval_s``."""
        now = time.monotonic()
        if now - self._last_seal >= self.seal_interval_s:
            self._last_seal = now
            self._seal(core)

    @staticmethod
    def _seal(core) -> None:
        try:
            core.tt_seal()
        except Exception:  # keep the ticker alive; the next tick retries
            logger.exception("time-tier seal failed")

    def _seal_loop(self, core) -> None:
        """Seal finished time buckets into the host time tier every
        ``seal_interval_s`` until ``stop()`` (with the windows off)."""
        while not self._stopping.wait(self.seal_interval_s):
            self._seal(core)

    def _snapshot_loop(self, core, interval_s: float) -> None:
        while not self._stopping.wait(interval_s):
            try:
                logger.info("periodic snapshot -> %s", core.snapshot())
            except Exception:  # keep the ticker alive; the next tick retries
                logger.exception("periodic snapshot failed; will retry")

    def admit(self) -> bool:
        """A request starts; False once stop() has begun (answer 503)."""
        with self._idle:
            if self._draining:
                return False
            self._inflight += 1
            return True

    def release(self) -> None:
        with self._idle:
            self._inflight -= 1
            self._idle.notify_all()

    def stop(self) -> None:
        if self._obs_windows is not None:
            # first: the ticker reads the store, which the end closes
            self._obs_windows.stop_ticker()
        self._stopping.set()
        # the wire collectors first: what they answered OK lands before
        # the final snapshot
        self._stop_transports()
        with self._idle:
            self._draining = True  # a keep-alive connection's next request gets 503
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        # handler threads are daemons that server_close() does not join:
        # wait for the requests in flight, so each 202 is in the store
        # before the final snapshot
        deadline = time.monotonic() + DRAIN_TIMEOUT_S
        with self._idle:
            while self._inflight and self._idle.wait(max(0.0, deadline - time.monotonic())):
                pass
            if self._inflight:
                # a request that ends from now on answers 503, not 202
                self._abandoned = True
                logger.warning("stop: %d requests still in flight after %.0f s",
                               self._inflight, DRAIN_TIMEOUT_S)
        # the tier's queued payloads were answered 202: they land before the
        # final snapshot, within what is left of the same limit
        self._close_mp_ingester(deadline)
        for t in self._threads:
            t.join(timeout=30)
        self._threads = []
        scrubber = getattr(getattr(self.storage, "delegate", self.storage), "scrubber", None)
        if scrubber is not None:
            scrubber.stop()  # no pass reads the dirs the final snapshot writes
        # before the final snapshot: both store their last queued spans, and
        # the emitter's stop disarms the process-wide recorder's hook
        if self._self_tracer is not None:
            self._self_tracer.stop()
            self._self_tracer = None
        if self._obs_emitter is not None:
            self._obs_emitter.stop()
            # the store's query plane would keep the emitter, and through
            # its collector the store, in a cycle
            if self._querytrace is not None and self._querytrace.emitter is self._obs_emitter:
                self._querytrace.emitter = None
            self._obs_emitter = None
        if self._snapshots:
            # the final snapshot last: the listener and the tickers have
            # stopped and the requests in flight have ended, so every
            # 202-acked span is in the store
            self._snapshots = False
            try:
                self.storage.snapshot()
            except Exception:
                logger.exception("shutdown snapshot failed")
        self.storage.close()

    # -- ingest ------------------------------------------------------------

    def _inflate(self, body: bytes) -> bytes:
        """Inflate a gzip body (by its magic, with or without the header)
        incrementally under ``MAX_INFLATED``; multi-member gzip is valid.

        Unlike the reference, each member may inflate one byte past what is
        left and the body is refused past the cap: a limit of 0 would make
        zlib inflate a later member without bound."""
        if body[:2] != b"\x1f\x8b":
            return body
        chunks, total, remaining = [], 0, body
        while remaining:
            d = zlib.decompressobj(wbits=31)
            out = d.decompress(remaining, self.MAX_INFLATED - total + 1)
            total += len(out)
            if total > self.MAX_INFLATED:
                raise PayloadTooLarge(f"gzip payload inflates past {self.MAX_INFLATED} bytes")
            chunks.append(out)
            remaining = d.unused_data
        return b"".join(chunks)

    # zt-ingest-boundary: HTTP POST /api/v{1,2}/spans is a wire
    # entrypoint — the handler put the X-Tenant-Id identity into
    # CURRENT_TENANT before this runs, and the collector chokepoint runs
    # admission
    def post_spans(self, body: bytes, content_type: str, v1: bool, t0: float):
        # the critical path's wire anchor: the instant http_boundary
        # measures from, in the ledger's ns domain; submit() reads it on
        # this thread
        tok = critpath.WIRE_T0_NS.set(int(t0 * 1e9))
        try:
            return self._post_spans(body, content_type, v1, t0)
        finally:
            critpath.WIRE_T0_NS.reset(tok)

    def _post_spans(self, body: bytes, content_type: str, v1: bool, t0: float):
        try:
            body = self._inflate(body)
        except PayloadTooLarge as e:
            raise HttpError(413, str(e))
        except zlib.error:
            raise HttpError(400, "cannot gunzip body")
        ctype = content_type.split(";")[0].strip()
        encoding: Optional[Encoding] = None
        if ctype == "application/x-protobuf":
            encoding = Encoding.PROTO3
        elif ctype == "application/x-thrift":
            encoding = Encoding.THRIFT
        elif ctype == JSON and v1:
            encoding = Encoding.JSON_V1
        # a budget spent while the body was read is dropped before dispatch
        self._check_deadline()
        try:
            self.collector.accept_spans_bytes(body, encoding)
        except ValueError as e:
            raise HttpError(400, str(e))
        except RejectedExecutionError as e:
            # the storage throttle shed the write: the sender backs off
            raise HttpError(503, str(e))
        except IngestBackpressure as e:
            # admission shed it, every parse worker's queue is full, or an
            # allocation failed: 429, retryable and distinct from the
            # throttle's 503, with backoff guidance scoped to whichever
            # control refused it
            raise HttpError(429, str(e), self._backoff_headers(e))
        # body read -> collector hand-off done; the 202 follows
        obs.record("http_boundary", time.perf_counter() - t0)
        return 202, None

    # -- query -------------------------------------------------------------

    def _query_request(self, q: Dict[str, str]) -> QueryRequest:
        def opt_int(name: str) -> Optional[int]:
            raw = q.get(name)
            return int(raw) if raw else None  # a blank parameter is absent

        return QueryRequest(
            end_ts=opt_int("endTs") or int(time.time() * 1000),
            lookback=opt_int("lookback") or self.config.default_lookback,
            limit=opt_int("limit") or self.config.query_limit,
            service_name=q.get("serviceName"),
            remote_service_name=q.get("remoteServiceName"),
            span_name=q.get("spanName"),
            annotation_query=parse_annotation_query(q.get("annotationQuery")),
            min_duration=opt_int("minDuration"),
            max_duration=opt_int("maxDuration"),
        )

    def get_traces(self, q):
        try:
            request = self._query_request(q)
        except ValueError as e:
            raise HttpError(400, str(e))
        self._check_deadline()
        traces = self.storage.span_store().get_traces_query(request).execute()
        return 200, [[json_v2.span_to_dict(s) for s in t] for t in traces]

    def get_trace(self, raw_id: str):
        try:
            normalize_trace_id(raw_id)
        except ValueError as e:
            raise HttpError(400, str(e))
        self._check_deadline()
        spans = self.storage.span_store().get_trace(raw_id).execute()
        if not spans:
            raise HttpError(404, f"trace {raw_id} not found")
        return 200, [json_v2.span_to_dict(s) for s in spans]

    def get_trace_many(self, q):
        ids = [x for x in q.get("traceIds", "").split(",") if x]
        if not ids:
            raise HttpError(400, "traceIds parameter is required")
        self._check_deadline()
        traces = self.storage.traces().get_traces(ids).execute()
        return 200, [[json_v2.span_to_dict(s) for s in t] for t in traces]

    def get_services(self, q):
        return 200, self.storage.service_and_span_names().get_service_names().execute()

    def get_span_names(self, q):
        names = self.storage.service_and_span_names()
        return 200, names.get_span_names(q.get("serviceName", "")).execute()

    def get_remote_services(self, q):
        names = self.storage.service_and_span_names()
        return 200, names.get_remote_service_names(q.get("serviceName", "")).execute()

    @staticmethod
    def _staleness_param(q) -> Optional[float]:
        """A request's mirror staleness bound in ms (<= 0: a fresh read;
        absent: the server's); ValueError on garbage, answered 400."""
        raw = q.get("staleness_ms")
        return float(raw) if raw is not None else None

    def get_dependencies(self, q):
        if not q.get("endTs"):
            raise HttpError(400, "endTs parameter is required")
        try:
            end_ts = int(q["endTs"])
            lookback = int(q.get("lookback") or self.config.default_lookback)
            staleness = self._staleness_param(q)
        except ValueError as e:
            raise HttpError(400, str(e))
        self._check_deadline()
        # the bound goes only to a store with a mirror: the in-memory
        # store's SPI signature stays the reference's
        kwargs = ({"staleness_ms": staleness}
                  if staleness is not None and self._mirror is not None else {})
        links = self.storage.span_store().get_dependencies(end_ts, lookback, **kwargs).execute()
        return 200, [json_v2.link_to_dict(x) for x in links]

    def get_autocomplete_keys(self, q):
        return 200, self.storage.autocomplete_tags().get_keys().execute()

    def get_autocomplete_values(self, q):
        key = q.get("key")
        if not key:
            raise HttpError(400, "key parameter is required")
        return 200, self.storage.autocomplete_tags().get_values(key).execute()

    # -- sketch reads (the device store's extensions, under /api/v2/tpu/) --

    def get_tpu_percentiles(self, q):
        try:
            qs = _quantile_list(q.get("q", "0.5,0.9,0.99"))
            end_ts, lookback = _opt_int(q, "endTs"), _opt_int(q, "lookback")
            staleness = self._staleness_param(q)
        except ValueError as e:
            raise HttpError(400, str(e))
        self._check_deadline()
        return 200, self.storage.latency_quantiles(
            qs, q.get("serviceName"), q.get("spanName"), q.get("sketch", "digest") == "digest",
            end_ts, lookback, staleness)

    def get_tpu_cardinalities(self, q):
        try:
            staleness = self._staleness_param(q)
            end_ts, lookback = _opt_int(q, "endTs"), _opt_int(q, "lookback")
        except ValueError as e:
            raise HttpError(400, str(e))
        return 200, self.storage.trace_cardinalities(staleness, end_ts, lookback)

    def get_tpu_counters(self, q):
        return 200, self.storage.ingest_counters()

    def post_tpu_snapshot(self):
        """Persist the device state now (``zipkin_tpu/server/app.py:1102-1108``)."""
        if not hasattr(self.storage, "snapshot"):
            raise HttpError(501, "storage does not snapshot")
        path = self.storage.snapshot()
        if path is None:
            raise HttpError(409, "no checkpoint_dir configured")
        return 200, {"snapshot": path}

    def get_tpu_overview(self, q):
        """Percentiles, cardinalities and counters from one device read."""
        if not hasattr(self.storage, "sketch_overview"):
            raise HttpError(501, "storage does not serve sketch_overview")
        try:
            qs = _quantile_list(q.get("q", "0.5,0.9,0.99"))
            staleness = self._staleness_param(q)
        except ValueError as e:
            raise HttpError(400, str(e))
        self._check_deadline()
        return 200, self.storage.sketch_overview(qs, q.get("serviceName"), q.get("spanName"),
                                                 staleness)

    # -- ops ---------------------------------------------------------------

    # -- the built-in UI (zipkin_tpu/server/app.py:543-578,1547-1557) -----

    def get_ui(self, q):
        from zipkin_tpu_torch.server.ui import index_page

        return 200, RawBody(index_page().encode(), "text/html; charset=utf-8",
                            {"Content-Security-Policy": UI_CSP})

    def get_ui_asset(self, name: str):
        from zipkin_tpu_torch.server.ui import asset

        found = asset(name)
        if found is None:
            raise HttpError(404, "no such asset")
        body, ctype = found
        return 200, RawBody(body, ctype, {"Content-Security-Policy": UI_CSP})

    def get_ui_config(self, q):
        cfg = self.config
        return 200, {
            "environment": "",
            "queryLimit": cfg.query_limit,
            "defaultLookback": cfg.default_lookback,
            "searchEnabled": cfg.search_enabled,
            "autocompleteKeys": list(cfg.autocomplete_keys),
            "dependency": {"enabled": True},
        }

    def get_health(self, q):
        results, up = {}, True
        for name, component in self.components.items():
            result = component.check()
            results[name] = {"status": "UP" if result.ok else "DOWN",
                             **({"error": str(result.error)} if result.error else {})}
            up &= result.ok
        return (200 if up else 503), {"status": "UP" if up else "DOWN", "zipkin": results}

    def get_info(self, q):
        return 200, {"zipkin": {"version": zipkin_tpu_torch.__version__, "flavor": "tpu"}}

    def get_metrics(self, q):
        """Actuator-style counters, the reference's names:
        ``counter.zipkin_collector.spans.http`` and so on, plus the store's
        gauges as ``gauge.zipkin_tpu.<name>``."""
        out = {}
        for key, value in self.metrics.snapshot().items():
            transport, _, name = key.partition(".")
            out[f"counter.zipkin_collector.{name}.{transport}"] = value
        # what the last boot's restore and replay cost
        for name, value in (getattr(self.storage, "restore_stats", None) or {}).items():
            out[f"gauge.zipkin_tpu.{name}"] = value
        if hasattr(self.storage, "ingest_counters"):
            counters = self.storage.ingest_counters()
            names = _METRIC_GAUGES
            if getattr(self.storage, "sampler", None) is not None:
                names += _SAMPLER_GAUGES
                for svc, rate in sorted(self.storage.sampler_rates().items()):
                    out[f"gauge.zipkin_tpu.samplerRate.{svc}"] = rate
            for name in (names + _DURABILITY_GAUGES + _MP_GAUGES + _CRITPATH_GAUGES
                         + _QUERY_GAUGES + _MIRROR_GAUGES + _SERVING_GAUGES):
                if name in counters:
                    out[f"gauge.zipkin_tpu.{name}"] = counters[name]
        # the accuracy plane's gauges and the shadow's occupancy
        if self._accuracy is not None:
            for name, value in sorted(self._accuracy.export_counters().items()):
                out[f"gauge.zipkin_tpu.{name}"] = value
        for st in obs.RECORDER.snapshot().nonzero():
            out[f"gauge.zipkin_tpu.stage.{st.stage}.p50Us"] = st.p50_us
            out[f"gauge.zipkin_tpu.stage.{st.stage}.p99Us"] = st.p99_us
            out[f"gauge.zipkin_tpu.stage.{st.stage}.maxUs"] = st.max_us
        if self._obs_slo is not None:
            self._windows_catch_up()
            for v in self._obs_slo.verdicts():
                base = f"gauge.zipkin_tpu.slo.{v['name']}"
                out[f"{base}.alert"] = int(v["alert"])
                for wname, wv in v["windows"].items():
                    out[f"{base}.burn.{wname}"] = wv["burn"]
        # the ladder's level and load index, admission tallies by class and
        # tenant, deadline drops
        if self._overload is not None:
            for name, value in self._overload.counters().items():
                out[f"gauge.zipkin_tpu.{name}"] = value
        return 200, out

    def get_prometheus(self, q):
        """The exposition format (``zipkin_tpu/server/app.py:1325-1407``):
        the collector's counters by transport, the store's flat gauges, the
        worker, query-lock and query-segment families, the sampler's rates,
        the stage latency histogram, the accuracy and the SLO families."""
        lines: List[str] = []
        by_name: Dict[str, List[Tuple[str, float]]] = {}
        for key, value in sorted(self.metrics.snapshot().items()):
            transport, _, name = key.partition(".")
            by_name.setdefault(name, []).append((transport, value))
        for name, rows in sorted(by_name.items()):
            fam = _prom_name(f"zipkin_collector_{name}_total")
            lines.append(f"# HELP {fam} Collector {name.replace('_', ' ')} by transport.")
            lines.append(f"# TYPE {fam} counter")
            for transport, value in rows:
                lines.append(f'{fam}{{transport="{_prom_label(transport)}"}} {value}')
        if hasattr(self.storage, "ingest_counters"):
            counters = self.storage.ingest_counters()
            for name, value in sorted(counters.items()):
                if isinstance(value, bool) or not isinstance(value, (int, float)):
                    continue  # nested tables ride statusz or their own families
                fam = _prom_name(f"zipkin_tpu_{_snake(name)}")
                lines.append(f"# HELP {fam} Device-tier gauge {name}.")
                lines.append(f"# TYPE {fam} gauge")
                lines.append(f"{fam} {value}")
            lines.extend(_prom_mp_workers(counters.get("mpWorkerTable")))
            lines.extend(_prom_critpath(counters.get("critpathSegments")))
            lines.extend(_prom_query_lock(counters.get("queryLock")))
            lines.extend(_prom_query_segments(counters.get("querySegments")))
        if getattr(self.storage, "sampler", None) is not None:
            rates = self.storage.sampler_rates()
            if rates:
                lines.append("# HELP zipkin_tpu_sampler_rate Live per-service keep "
                             "probability (1.0 = keep everything).")
                lines.append("# TYPE zipkin_tpu_sampler_rate gauge")
                for svc, rate in sorted(rates.items()):
                    lines.append(f'zipkin_tpu_sampler_rate{{service="{_prom_label(svc)}"}} {rate}')
        lines.extend(_prom_stage_histograms(obs.RECORDER.snapshot(), obs.RECORDER.slow_events()))
        if self._accuracy is not None:
            lines.extend(_prom_accuracy(self._accuracy.status()))
        if self._obs_slo is not None:
            self._windows_catch_up()
            lines.extend(_prom_slo(self._obs_slo.verdicts()))
        if self._overload is not None:
            status = self._overload.status()
            lines.extend(_prom_overload(status))
            lines.extend(_prom_tenants(status))
        return 200, "\n".join(lines) + "\n"

    def get_tpu_statusz(self, q):
        """The observability plane's debug page
        (``zipkin_tpu/server/app.py:1408-1511``)."""
        from zipkin_tpu_torch.obs.device import OBSERVATORY, timeline_summary

        rec = obs.RECORDER
        snap = rec.snapshot()
        stages = {}
        for st in snap.stages():
            budget = rec.budget_us(st.stage)
            stages[st.stage] = {
                "count": st.count, "p50Us": st.p50_us, "p99Us": st.p99_us,
                "maxUs": st.max_us, "sumUs": st.sum_us,
                "budgetUs": int(budget) if budget != float("inf") else -1,
            }
        body = {
            "stages": stages,
            "slow": rec.slow_events(),
            "recorder": {
                "enabled": rec.enabled,
                "budgetScale": rec.budget_scale,
                "writerThreads": snap.locals_seen,
                "generation": snap.generation,
                "overheadNsPerRecord": rec.measure_overhead(),
                "selfSpans": self._obs_emitter is not None,
                "selfSpansEmitted": self._obs_emitter.emitted if self._obs_emitter else 0,
            },
        }
        if getattr(self.storage, "sampler", None) is not None and hasattr(self.storage, "ingest_counters"):
            counters = self.storage.ingest_counters()
            body["sampler"] = {name: counters[name] for name in _SAMPLER_GAUGES if name in counters}
        durability = self._durability_status()
        if durability:
            body["durability"] = durability
        if self._obs_windows is not None:
            self._windows_catch_up()
            body["windows"] = self._obs_windows.status()
        if self._obs_slo is not None:
            body["slo"] = self._obs_slo.status()
        if self._accuracy is not None:
            body["accuracy"] = self._accuracy.status()
        body["device"] = OBSERVATORY.status()
        # the port's own: the card's idle share over the newest ingest steps
        # and the host spans it waited in
        body["device"]["timeline"] = timeline_summary()
        core = getattr(self.storage, "delegate", self.storage)
        ing = getattr(core, "mp_ingester", None)
        if ing is not None:
            stats = ing.stats()
            if "mpWorkerTable" in stats:
                body["workers"] = stats["mpWorkerTable"]
            # wire-to-durable percentiles, queue wait against service, the
            # Little's-law gauges and the slowest chunk's timeline
            cp = getattr(ing, "critpath", None)
            if cp is not None:
                body["critpath"] = cp.waterfall()
        if self._querytrace is not None:
            body["queries"] = self._querytrace.waterfall()
        if self._mirror is not None:
            body["mirror"] = self._mirror.status()
        # the segment's name is here for TPU_MIRROR_SEGMENT of
        # python -m zipkin_tpu_torch.serving
        seg = getattr(core, "mirror_segment", None)
        if seg is not None:
            body["serving"] = seg.status()
        # the ladder, the live signal fold, admission and the transitions
        if self._overload is not None:
            body["overload"] = self._overload.status()
        if self._obs_incidents is not None:
            body["incidents"] = self._obs_incidents.counters()
        return 200, body

    def _durability_status(self) -> Optional[dict]:
        """The durability section: retained snapshot generations
        (quarantined ones included), the WAL's coverage window, the boot's
        restore fallbacks and the scrubber's last pass."""
        core = getattr(self.storage, "delegate", self.storage)
        ckpt = getattr(core, "checkpoint_dir", None)
        scrubber = getattr(core, "scrubber", None)
        wal = getattr(core, "wal", None)
        if not ckpt and scrubber is None and wal is None:
            return None
        out: dict = {}
        if ckpt:
            from zipkin_tpu_torch.tpu import snapshot as snap_mod

            out["generations"] = snap_mod.generation_status(ckpt)
            out["walCoverage"] = {"floor": snap_mod.retained_coverage(ckpt),
                                  "head": int(getattr(core.agg, "wal_seq", 0))}
        restore = getattr(core, "restore_stats", None)
        if restore:
            out["restore"] = {name: restore[name] for name in (
                "restoreFallbacks", "generationsQuarantined", "walReplayBatches", "restoreMs")
                if name in restore}
        if scrubber is not None:
            out["scrub"] = scrubber.status()
        return out


def _handler_for(server_ref):
    """The request handler class of a server, reached through
    ``server_ref`` (a weak reference): a class is freed only by the cycle
    collector, so a strong one would keep a stopped server alive. Each
    request holds the server for its own duration; one that arrives after
    the server is gone answers 503."""
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        server_version = "zipkin-tpu-torch"

        def log_message(self, fmt, *args):  # requests are not logged
            pass

        def _send(self, status: int, body: bytes = b"", ctype: str = "text/plain; charset=utf-8",
                  headers: Optional[Dict[str, str]] = None):
            self._status = status  # what self-tracing tags the request with
            self.send_response(status)
            for name, value in (headers or {}).items():
                self.send_header(name, value)
            if body:
                self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            if body:
                self.wfile.write(body)

        def _answer(self, fn, *args):
            try:
                status, body = fn(*args)
            except HttpError as e:
                self._send(e.status, e.text.encode(), headers=e.headers)
                return
            except Exception as e:  # the request fails, the server keeps serving
                logger.exception("%s %s failed", self.command, self.path)
                self._send(500, f"{type(e).__name__}: {e}".encode())
                return
            with self._server._idle:
                late = self._server._abandoned
            if late:
                # stop() snapshotted without this request: the sender retries
                self._send(503, b"server stopped")
                self.close_connection = True
                return
            if body is None:
                self._send(status)
            elif isinstance(body, RawBody):
                self._send(status, body.body, body.ctype, body.headers)
            elif isinstance(body, str):  # the exposition format
                self._send(status, body.encode(), "text/plain; version=0.0.4; charset=utf-8")
            else:
                self._send(status, json.dumps(body).encode(), "application/json; charset=utf-8")

        def _read_body(self) -> bytes:
            """The request body; a length that is negative or not a number
            raises BadLength, one past MAX_BODY PayloadTooLarge, before
            anything past the headers is read."""
            if "chunked" in self.headers.get("Transfer-Encoding", "").lower():
                parts, total = [], 0
                while True:
                    raw = self.rfile.readline(1024).split(b";")[0].strip() or b"0"
                    # int(raw, 16) alone would take "-1", "+5" or "1_0"
                    if raw.strip(b"0123456789abcdefABCDEF"):
                        raise BadLength(f"malformed chunk size {raw[:32]!r}")
                    size = int(raw, 16)
                    if size == 0:
                        while self.rfile.readline() not in (b"\r\n", b"\n", b""):
                            pass  # trailers
                        return b"".join(parts)
                    total += size
                    if total > MAX_BODY:
                        raise PayloadTooLarge(f"request body past {MAX_BODY} bytes")
                    parts.append(self.rfile.read(size))
                    self.rfile.readline()
            raw = (self.headers.get("Content-Length") or "0").strip()
            if not (raw.isascii() and raw.isdigit()):
                raise BadLength(f"malformed Content-Length {raw[:32]!r}")
            length = int(raw)
            if length > MAX_BODY:
                raise PayloadTooLarge(f"request body past {MAX_BODY} bytes")
            return self.rfile.read(length)

        def _gated(self, method) -> None:
            # the caller's deadline, stamped at the earliest instant (a
            # malformed header means none), and its tenant: both set on this
            # request's thread for the collector and reset after, since a
            # kept-alive connection serves its next request on this thread
            deadline = None
            raw = self.headers.get("X-Request-Timeout-Ms")
            if raw:
                try:
                    deadline = time.monotonic() + max(0.0, float(raw)) / 1000.0
                except ValueError:
                    pass
            self._server = server_ref()
            if self._server is None or not self._server.admit():
                self._server = None
                self._send(503, b"server stopping")
                self.close_connection = True
                return
            if not self._server.config.deadline_propagation_enabled:
                deadline = None
            d_tok = REQUEST_DEADLINE.set(deadline)
            t_tok = CURRENT_TENANT.set(normalize_tenant(self.headers.get(TENANT_HEADER)))
            try:
                tracer = self._server._self_tracer
                if tracer is None:
                    method()
                    return
                self._status = 500

                def handle() -> int:
                    method()
                    return self._status

                tracer.trace(self.command, urlsplit(self.path).path, self.headers, handle)
            finally:
                CURRENT_TENANT.reset(t_tok)
                REQUEST_DEADLINE.reset(d_tok)
                self._server.release()
                self._server = None  # a kept-alive connection holds no server between requests

        def do_GET(self):
            self._gated(self._get)

        def do_POST(self):
            self._gated(self._post)

        def _get(self):
            url = urlsplit(self.path)
            # the first value of a repeated parameter, as aiohttp's query.get
            query = {k: v[0] for k, v in parse_qs(url.query, keep_blank_values=True).items()}
            fn = self._server.get_routes.get(url.path)
            if fn is not None:
                self._answer(fn, query)
            elif url.path.startswith("/api/v2/trace/") and url.path.count("/") == 4:
                self._answer(self._server.get_trace, unquote(url.path[len("/api/v2/trace/"):]))
            elif url.path.startswith("/zipkin/static/") and url.path.count("/") == 3:
                self._answer(self._server.get_ui_asset, unquote(url.path[len("/zipkin/static/"):]))
            else:
                self._send(404, b"404: Not Found")

        def _post(self):
            path = urlsplit(self.path).path
            route = self._server.post_routes.get(path)
            if route is None:
                self._send(405 if path in self._server.get_routes else 404)
                self.close_connection = True
                return
            hook = self._server.post_hook
            if hook is not None and hook(self, path):
                return
            t0 = time.perf_counter()
            try:
                body = self._read_body()
            except (PayloadTooLarge, BadLength) as e:
                # the rest of the body is left unread: the connection closes
                self._send(413 if isinstance(e, PayloadTooLarge) else 400, str(e).encode())
                self.close_connection = True
                return
            self._answer(route, body, self.headers.get("Content-Type", ""), t0)

    return Handler


# -- the exposition format (zipkin_tpu/server/app.py:1560-1954) ------------


def _snake(name: str) -> str:
    out = []
    for ch in name:
        if ch.isupper():
            out.append("_")
            out.append(ch.lower())
        else:
            out.append(ch)
    return "".join(out)


def _prom_name(name: str) -> str:
    """Sanitize to the Prometheus metric-name charset ``[a-zA-Z0-9_:]``,
    mapping every other rune (dots included) to ``_`` — real scrapers
    reject the exposition otherwise."""
    out = "".join(
        ch if (ch.isascii() and (ch.isalnum() or ch in "_:")) else "_"
        for ch in name
    )
    if not out or out[0].isdigit():
        out = "_" + out
    return out


def _prom_label(value) -> str:
    """Escape a label value per the exposition format."""
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace("\n", "\\n")
        .replace('"', '\\"')
    )


def _prom_stage_histograms(snap, slow_events=None) -> List[str]:
    """Flight-recorder stage latencies as one native histogram family.

    Log2-µs buckets become cumulative ``le`` bounds in seconds (the
    exact inclusive bucket bound, ``(2^b - 1)/1e6``); only non-empty
    buckets are emitted — cumulative series stay valid when sparse.

    When the slow-event ring is passed, bucket lines carry OpenMetrics
    exemplars pointing at the self-span trace id of an over-budget
    observation that landed in that bucket — a burning latency SLO
    links straight to a retrievable pipeline trace. Exemplar syntax
    (``# {trace_id="..."} <seconds>``) is an OpenMetrics extension that
    classic text-format parsers treat as a comment, so the exposition
    stays valid for both.
    """
    stats = snap.nonzero()
    if not stats:
        return []
    # newest exemplar per (stage, bucket): the ring is oldest-first and
    # only self-span-enriched events carry a trace id worth linking
    by_bucket: Dict[Tuple[str, int], Tuple[str, float]] = {}
    for ev in slow_events or ():
        trace_id = ev.get("traceId")
        if not trace_id:
            continue
        dur_us = int(ev.get("durUs", 0))
        by_bucket[(ev["stage"], max(dur_us, 0).bit_length())] = (
            trace_id, dur_us / 1e6,
        )
    fam = "zipkin_tpu_stage_latency_seconds"
    lines = [
        f"# HELP {fam} Pipeline stage latency (log2 microsecond buckets).",
        f"# TYPE {fam} histogram",
    ]
    for st in stats:
        cum = 0
        for b, count in enumerate(st.buckets[:-1]):
            if not count:
                continue
            cum += count
            le = obs.bucket_le_us(b) / 1e6
            line = f'{fam}_bucket{{stage="{st.stage}",le="{le}"}} {cum}'
            ex = by_bucket.get((st.stage, b))
            if ex is not None:
                line += f' # {{trace_id="{_prom_label(ex[0])}"}} {ex[1]}'
            lines.append(line)
        lines.append(f'{fam}_bucket{{stage="{st.stage}",le="+Inf"}} {st.count}')
        lines.append(f'{fam}_sum{{stage="{st.stage}"}} {st.sum_us / 1e6}')
        lines.append(f'{fam}_count{{stage="{st.stage}"}} {st.count}')
    return lines


def _prom_accuracy(status) -> List[str]:
    """Per-service digest-error families from the accuracy observatory.
    The scalar gauges (worst-service, HLL, recall, retention bias) ride
    the flat ``zipkin_tpu_accuracy_*`` render in ``get_prometheus``;
    only the service-labelled detail needs its own exposition."""
    rows = status.get("services") or []
    if not rows:
        return []
    lines: List[str] = []
    fields = (
        ("p50RelErr", "p50_relerr", "digest p50 relative error"),
        ("p99RelErr", "p99_relerr", "digest p99 relative error"),
        ("p99Bound", "p99_bound", "stated p99 confidence bound"),
    )
    for field, suffix, help_text in fields:
        fam = f"zipkin_tpu_accuracy_service_{suffix}"
        lines.append(
            f"# HELP {fam} Per-service {help_text} (device vs shadow)."
        )
        lines.append(f"# TYPE {fam} gauge")
        for row in rows:
            lines.append(
                f'{fam}{{service="{_prom_label(row["service"])}"}} '
                f'{row[field]}'
            )
    return lines


def _prom_mp_workers(table) -> List[str]:
    """Fan-out tier per-worker attribution as labelled counter families
    (``worker="<widx>"``). The nested ``mpWorkerTable`` is skipped by the
    flat-gauge loop; this is its exposition-format rendering."""
    if not table:
        return []
    lines: List[str] = []
    fields = (
        ("chunks", "chunks dispatched"),
        ("spans", "spans parsed"),
        ("payloads", "payloads completed"),
        ("parseUs", "parse wall microseconds"),
        ("packUs", "pack wall microseconds"),
        ("routeUs", "route wall microseconds"),
        ("fallbacks", "inline-fallback payloads"),
    )
    for field, help_text in fields:
        fam = _prom_name(f"zipkin_tpu_mp_worker_{_snake(field)}_total")
        lines.append(f"# HELP {fam} Ingest worker {help_text}.")
        lines.append(f"# TYPE {fam} counter")
        for row in table:
            lines.append(
                f'{fam}{{worker="{_prom_label(row["widx"])}"}} {row[field]}'
            )
    # instantaneous queue posture: depth is live
    # occupancy, high-water the worst since boot — gauges, not counters
    gauges = (
        ("queueDepth", "live bounded-queue depth (payloads in flight)"),
        ("queueHighWater", "bounded-queue depth high-water mark"),
    )
    for field, help_text in gauges:
        fam = _prom_name(f"zipkin_tpu_mp_worker_{_snake(field)}")
        lines.append(f"# HELP {fam} Ingest worker {help_text}.")
        lines.append(f"# TYPE {fam} gauge")
        for row in table:
            lines.append(
                f'{fam}{{worker="{_prom_label(row["widx"])}"}} '
                f'{row.get(field, 0)}'
            )
    return lines


def _prom_critpath(segments) -> List[str]:
    """The critical-path segment families (``zipkin_tpu/server/app.py:1716-1740``):
    the scalar ``zipkin_tpu_critpath_*`` gauges ride the flat render, the
    per-segment table needs segment and kind labels."""
    if not segments:
        return []
    lines: List[str] = []
    fields = (
        ("count", "folded occurrences", "counter", "_total"),
        ("sumUs", "cumulative wall microseconds", "counter", "_total"),
        ("maxUs", "worst single occurrence microseconds", "gauge", ""),
    )
    for field, help_text, typ, suffix in fields:
        fam = _prom_name(f"zipkin_tpu_critpath_segment_{_snake(field)}{suffix}")
        lines.append(f"# HELP {fam} Critical-path segment {help_text}.")
        lines.append(f"# TYPE {fam} {typ}")
        for seg, row in sorted(segments.items()):
            lines.append(f'{fam}{{segment="{_prom_label(seg)}",'
                         f'kind="{_prom_label(row["kind"])}"}} {row[field]}')
    return lines


def _prom_query_lock(table) -> List[str]:
    """Aggregator-lock contention ledger : native wait/hold
    histogram families plus per-label holder attribution. The scalar
    ``zipkin_tpu_query_lock_*`` gauges (acquisitions, waiters,
    high-water, p50/p99) ride the flat render; the histograms and the
    holder table need their own families."""
    if not table:
        return []
    lines: List[str] = []
    hists = (
        ("wait", table.get("waitHist"), table.get("waitSumUs", 0),
         "time a thread waited to acquire the aggregator lock"),
        ("hold", table.get("holdHist"), table.get("holdSumUs", 0),
         "time an outermost acquire held the aggregator lock"),
    )
    for which, hist, sum_us, help_text in hists:
        if not hist or not sum(hist):
            continue
        fam = f"zipkin_tpu_query_lock_{which}_seconds"
        lines.append(f"# HELP {fam} Lock ledger: {help_text}.")
        lines.append(f"# TYPE {fam} histogram")
        total = sum(hist)
        cum = 0
        for b, count in enumerate(hist[:-1]):
            if not count:
                continue
            cum += count
            le = obs.bucket_le_us(b) / 1e6
            lines.append(f'{fam}_bucket{{le="{le}"}} {cum}')
        lines.append(f'{fam}_bucket{{le="+Inf"}} {total}')
        lines.append(f'{fam}_sum {sum_us / 1e6}')
        lines.append(f'{fam}_count {total}')
    holders = table.get("holders") or {}
    if holders:
        count_fam = "zipkin_tpu_query_lock_holds_total"
        sum_fam = "zipkin_tpu_query_lock_hold_sum_us_total"
        lines.append(
            f"# HELP {count_fam} Outermost lock holds by holder label."
        )
        lines.append(f"# TYPE {count_fam} counter")
        for label, row in sorted(holders.items()):
            lines.append(
                f'{count_fam}{{holder="{_prom_label(label)}"}} '
                f'{row["count"]}'
            )
        lines.append(
            f"# HELP {sum_fam} Cumulative hold microseconds by holder "
            "label."
        )
        lines.append(f"# TYPE {sum_fam} counter")
        for label, row in sorted(holders.items()):
            lines.append(
                f'{sum_fam}{{holder="{_prom_label(label)}"}} '
                f'{row["holdSumUs"]}'
            )
    return lines


def _prom_query_segments(segments) -> List[str]:
    """Per-segment query critical-path aggregates, with segment and kind
    labels."""
    if not segments:
        return []
    lines: List[str] = []
    fields = (
        ("count", "folded occurrences", "counter", "_total"),
        ("sumUs", "cumulative wall microseconds", "counter", "_total"),
        ("maxUs", "worst single occurrence microseconds", "gauge", ""),
    )
    for field, help_text, typ, suffix in fields:
        fam = _prom_name(f"zipkin_tpu_query_segment_{_snake(field)}{suffix}")
        lines.append(f"# HELP {fam} Query critical-path segment "
                     f"{help_text}.")
        lines.append(f"# TYPE {fam} {typ}")
        for seg, row in sorted(segments.items()):
            lines.append(
                f'{fam}{{segment="{_prom_label(seg)}",'
                f'kind="{_prom_label(row["kind"])}"}} {row[field]}'
            )
    return lines


def _prom_overload(status) -> List[str]:
    """Overload control plane families. Scalars carry the
    ladder posture; the per-signal family shows WHICH bottleneck is
    driving the load index (it is a MAX fold, so exactly one signal is
    the story at any instant)."""
    lines: List[str] = []
    gauges = (
        ("level", status["level"],
         "Brownout ladder level (0=B0 normal .. 3=B3 essential-only)"),
        ("load_index", status["loadIndex"],
         "EMA-smoothed load index (max-folded signal pressure)"),
        ("raw_load_index", status["rawLoadIndex"],
         "Unsmoothed load index from the latest tick"),
        ("bulk_admit_p", status["bulkAdmitP"],
         "Bulk-class ingest admit probability (1.0 outside B2)"),
    )
    for suffix, value, help_text in gauges:
        fam = f"zipkin_tpu_overload_{suffix}"
        lines.append(f"# HELP {fam} {help_text}.")
        lines.append(f"# TYPE {fam} gauge")
        lines.append(f"{fam} {value}")
    signals = status.get("signals") or {}
    if signals:
        fam = "zipkin_tpu_overload_signal"
        lines.append(
            f"# HELP {fam} Per-signal pressure ratio "
            "(value over design limit; 1.0 = at the limit)."
        )
        lines.append(f"# TYPE {fam} gauge")
        for name, value in sorted(signals.items()):
            lines.append(
                f'{fam}{{signal="{_prom_label(name)}"}} {value}'
            )
    counters = status.get("counters") or {}
    counter_fields = (
        ("admitted", "admitted_total", "payloads admitted"),
        ("admittedEssential", "admitted_essential_total",
         "error-class payloads admitted under brownout"),
        ("shedBulk", "shed_bulk_total", "bulk-class payloads shed"),
        ("shedTotal", "shed_total", "payloads shed"),
        ("deadlineExpired", "deadline_expired_total",
         "requests dropped already past their deadline"),
        ("transitions", "transitions_total", "ladder level transitions"),
    )
    for field, suffix, help_text in counter_fields:
        if field not in counters:
            continue
        fam = f"zipkin_tpu_overload_{suffix}"
        lines.append(f"# HELP {fam} Overload controller: {help_text}.")
        lines.append(f"# TYPE {fam} counter")
        lines.append(f"{fam} {counters[field]}")
    return lines


def _prom_tenants(status) -> List[str]:
    """Per-tenant admission families: every family carries a
    ``{tenant=}`` label, so one flooding tenant's shed curve is
    separable from everyone else's flat zero on the same graph. The
    label values come from ``normalize_tenant``'s bounded alphabet, so
    they are prometheus-label-safe by construction; the row count is
    bounded by the admission table's LRU cap."""
    tenants = (status or {}).get("tenants")
    if not tenants:
        return []
    lines: List[str] = []
    table = tenants.get("tenants") or {}
    scalars = (
        ("table_size", len(table),
         "Live tenants in the bounded admission table", "gauge"),
        ("evictions_total", tenants.get("evictions", 0),
         "Tenant rows LRU-evicted from the admission table", "counter"),
    )
    for suffix, value, help_text, typ in scalars:
        fam = f"zipkin_tpu_tenant_{suffix}"
        lines.append(f"# HELP {fam} {help_text}.")
        lines.append(f"# TYPE {fam} {typ}")
        lines.append(f"{fam} {value}")
    fields = (
        ("level", "level",
         "Per-tenant brownout level (0=admit .. 3=essential-only)",
         "gauge"),
        ("pressure", "pressure",
         "Per-tenant demand pressure EMA (offered rate over budget)",
         "gauge"),
        ("offered", "offered_total", "payloads offered", "counter"),
        ("admitted", "admitted_total", "payloads admitted", "counter"),
        ("shed", "shed_total", "payloads shed (scope=tenant)", "counter"),
        ("retainedSpans", "retained_spans_total",
         "spans retained past sampling", "counter"),
    )
    for field, suffix, help_text, typ in fields:
        fam = f"zipkin_tpu_tenant_{suffix}"
        if typ == "counter":
            lines.append(f"# HELP {fam} Tenant admission: {help_text}.")
        else:
            lines.append(f"# HELP {fam} {help_text}.")
        lines.append(f"# TYPE {fam} {typ}")
        for name, row in sorted(table.items()):
            lines.append(
                f'{fam}{{tenant="{_prom_label(name)}"}} {row[field]}'
            )
    return lines


def _prom_slo(verdicts) -> List[str]:
    """SLO watchdog families: one boolean alert gauge per SLO plus the
    multi-window burn rates it was computed from."""
    if not verdicts:
        return []
    alert_fam = "zipkin_tpu_slo_alert"
    burn_fam = "zipkin_tpu_slo_burn_rate"
    lines = [
        f"# HELP {alert_fam} SLO burn-rate alert (1 = burning).",
        f"# TYPE {alert_fam} gauge",
    ]
    for v in verdicts:
        lines.append(
            f'{alert_fam}{{slo="{_prom_label(v["name"])}"}} {int(v["alert"])}'
        )
    lines.append(
        f"# HELP {burn_fam} Error-budget burn rate per evaluation window."
    )
    lines.append(f"# TYPE {burn_fam} gauge")
    for v in verdicts:
        for wname, wv in sorted(v["windows"].items()):
            lines.append(
                f'{burn_fam}{{slo="{_prom_label(v["name"])}",'
                f'window="{_prom_label(wname)}"}} {wv["burn"]}'
            )
    return lines


def _run_loop(loop: asyncio.AbstractEventLoop) -> None:
    """The transport loop's thread: serve until stopped, then join the
    loop's worker threads (the scribe and gRPC accepts) and close it."""
    asyncio.set_event_loop(loop)
    try:
        loop.run_forever()
        loop.run_until_complete(loop.shutdown_default_executor())
    finally:
        loop.close()


def run_server(config: Optional[ServerConfig] = None, stop: Optional[threading.Event] = None) -> None:
    """Serve until ``stop`` is set, then shut down cleanly. A server that
    cannot start closes its store and raises."""
    server = ZipkinServer(config or ServerConfig.from_env())
    try:
        server.start()
    except BaseException:
        server.storage.close()
        raise
    try:
        (stop or threading.Event()).wait()
    finally:
        server.stop()

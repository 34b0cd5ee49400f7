"""The HTTP server: the Zipkin v2 API, the collector's HTTP transport, the
sketch reads, health and metrics (the port's copy of
``zipkin_tpu/server/app.py``, on the standard library's
``http.server.ThreadingHTTPServer`` instead of aiohttp).

Routes and status codes follow the reference:

- ``POST /api/v2/spans``, ``POST /api/v1/spans``: gzip (by its magic, with
  a 256 MiB inflation cap -> 413), Content-Type -> encoding, else sniffed;
  malformed -> 400, throttle shed -> 503, a full multi-process tier -> 429,
  accepted -> 202;
- ``GET /api/v2/{traces,trace/{id},traceMany,services,spans,remoteServices,
  dependencies,autocompleteKeys,autocompleteValues}``;
- ``GET /api/v2/tpu/{percentiles,cardinalities,counters,overview}`` when the
  storage serves sketch reads, and ``POST /api/v2/tpu/snapshot`` (200
  ``{"snapshot": dir}``, 409 without a checkpoint dir, 501 on a store that
  cannot snapshot);
- ``GET /health``, ``/info`` and ``/metrics`` (the reference's
  ``counter.zipkin_collector.<name>.<transport>`` taxonomy, with the boot's
  restore figures, the scrubber's and archive's quarantine tallies and the
  multi-process tier's pool and acked-span accounting as gauges).

With ``TPU_MP_WORKERS`` > 0, the line-rate path on and the device store,
the server builds the multi-process ingest tier
(:mod:`zipkin_tpu_torch.tpu.mp_ingest`): POSTed JSON v2 and proto3 payloads
go to its parse workers and are answered 202 on hand-off.

Each request runs on its own thread; a ticker thread seals the store's
time tier every ``seal_interval_s``, and with a checkpoint dir another
snapshots the store every ``TPU_SNAPSHOT_INTERVAL_S``; the store's own
scrubber thread re-verifies its files every ``TPU_SCRUB_INTERVAL_S``.
``stop()`` answers new requests 503, waits for those in flight (the
reference's ``runner.cleanup()``), drains and closes the multi-process tier
within the same limit, stops the scrubber, and takes a final snapshot after
the listener and both tickers have stopped. Left out, against the
reference: gRPC, scribe, the UI and ``/config.json``, ``/prometheus``,
statusz, deadlines, overload and tenant admission (so a 429 carries no
``Retry-After`` unless its exception does), self-tracing and the
observability plane.
"""

from __future__ import annotations

import json
import logging
import threading
import time
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional
from urllib.parse import parse_qs, unquote, urlsplit

import zipkin_tpu_torch
from zipkin_tpu_torch.collector.core import Collector, CollectorSampler, InMemoryCollectorMetrics
from zipkin_tpu_torch.internal.hex import normalize_trace_id
from zipkin_tpu_torch.model import json_v2
from zipkin_tpu_torch.model.codec import Encoding
from zipkin_tpu_torch.server.config import ServerConfig
from zipkin_tpu_torch.storage.memory import InMemoryStorage
from zipkin_tpu_torch.storage.spi import QueryRequest, StorageComponent
from zipkin_tpu_torch.storage.throttle import RejectedExecutionError, ThrottledStorage
from zipkin_tpu_torch.tpu.mp_ingest import IngestBackpressure

logger = logging.getLogger(__name__)

JSON = "application/json"
MAX_BODY = 64 * 1024 * 1024  # compressed request bytes, as the reference's client_max_size
DRAIN_TIMEOUT_S = 30.0  # how long stop() waits for the requests in flight
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


class _HTTPServer(ThreadingHTTPServer):
    daemon_threads = True  # a request in flight does not hold the process up
    request_queue_size = 128  # the listen backlog aiohttp uses, not socketserver's 5


class PayloadTooLarge(ValueError):
    """The request body, or its inflated form, is past its cap."""


class BadLength(ValueError):
    """A Content-Length or chunk size that is negative or not a number."""


class HttpError(Exception):
    """An error answer: status, plain-text body and extra headers."""

    def __init__(self, status: int, text: str, headers: Optional[Dict[str, str]] = None) -> None:
        super().__init__(text)
        self.status = status
        self.text = text
        self.headers = headers or {}


def build_storage(config: ServerConfig, device=None) -> StorageComponent:
    """STORAGE_TYPE -> StorageComponent: ``mem`` the in-memory store,
    ``tpu`` the resume adapter :class:`zipkin_tpu_torch.storage.tpu.TorchStorage`,
    on the card unless ``device`` names another. The adapter restores and
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
    unless named)."""

    MAX_INFLATED = 256 * 1024 * 1024  # decompression-bomb guard

    def __init__(self, config: Optional[ServerConfig] = None, *,
                 storage: Optional[StorageComponent] = None, seal_interval_s: float = 1.0,
                 device=None) -> None:
        self.config = config or ServerConfig()
        self.storage = storage if storage is not None else build_storage(self.config, device)
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
        self.port: Optional[int] = None
        self._httpd: Optional[_HTTPServer] = None
        self._threads = []
        self._stopping = threading.Event()
        # requests in flight, and whether stop() turns new ones away
        # (draining) or stopped waiting for them (abandoned)
        self._inflight = 0
        self._idle = threading.Condition()
        self._draining = self._abandoned = False
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
        }
        if hasattr(self.storage, "latency_quantiles"):
            routes.update({
                "/api/v2/tpu/percentiles": self.get_tpu_percentiles,
                "/api/v2/tpu/cardinalities": self.get_tpu_cardinalities,
                "/api/v2/tpu/counters": self.get_tpu_counters,
                "/api/v2/tpu/overview": self.get_tpu_overview,
            })
        self.get_routes = routes
        # path -> handler(body, content_type). The snapshot route is served
        # on every store, so one that cannot snapshot answers 501 (the
        # reference serves it only beside the sketch reads: 404 on mem)
        self.post_routes = {"/api/v2/tpu/snapshot": lambda body, ctype: self.post_tpu_snapshot()}
        if self.config.http_collector_enabled:
            self.post_routes.update({
                "/api/v2/spans": lambda body, ctype: self.post_spans(body, ctype, False),
                "/api/v1/spans": lambda body, ctype: self.post_spans(body, ctype, True),
            })
        self._snapshots = False  # a periodic snapshot thread runs

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
            coalesce_max=cfg.tpu_mp_coalesce_max, metrics=metrics)
        core.mp_ingester = ing
        return ing

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
        self._httpd = _HTTPServer((self.config.host, self.config.port), _handler_for(self))
        self.port = self._httpd.server_address[1]
        self._stopping.clear()
        self._draining = self._abandoned = False
        self._threads = [threading.Thread(target=self._httpd.serve_forever, name="zipkin-http",
                                          daemon=True)]
        core = getattr(self.storage, "delegate", self.storage)
        if getattr(core, "timetier", None) is not None and self.seal_interval_s > 0:
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
        for t in self._threads:
            t.start()
        logger.info("zipkin-tpu-torch listening on %s:%d", self.config.host, self.port)
        return self

    def _seal_loop(self, core) -> None:
        """Seal finished time buckets into the host time tier, as the
        reference's ticker does, until ``stop()``."""
        while not self._stopping.wait(self.seal_interval_s):
            try:
                core.tt_seal()
            except Exception:  # keep the ticker alive; the next tick retries
                logger.exception("time-tier seal failed")

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
        self._stopping.set()
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

    def post_spans(self, body: bytes, content_type: str, v1: bool):
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
        try:
            self.collector.accept_spans_bytes(body, encoding)
        except ValueError as e:
            raise HttpError(400, str(e))
        except RejectedExecutionError as e:
            # the storage throttle shed the write: the sender backs off
            raise HttpError(503, str(e))
        except IngestBackpressure as e:
            # every parse worker's queue is full (or an allocation failed):
            # 429, retryable and distinct from the throttle's 503
            delay = e.retry_after_s
            headers = {} if delay is None else {
                "Retry-After": str(max(1, int(-(-delay // 1)))),
                "X-Retry-After-Ms": str(int(delay * 1000.0))}
            raise HttpError(429, str(e), headers)
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
        traces = self.storage.span_store().get_traces_query(request).execute()
        return 200, [[json_v2.span_to_dict(s) for s in t] for t in traces]

    def get_trace(self, raw_id: str):
        try:
            normalize_trace_id(raw_id)
        except ValueError as e:
            raise HttpError(400, str(e))
        spans = self.storage.span_store().get_trace(raw_id).execute()
        if not spans:
            raise HttpError(404, f"trace {raw_id} not found")
        return 200, [json_v2.span_to_dict(s) for s in spans]

    def get_trace_many(self, q):
        ids = [x for x in q.get("traceIds", "").split(",") if x]
        if not ids:
            raise HttpError(400, "traceIds parameter is required")
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

    def get_dependencies(self, q):
        if not q.get("endTs"):
            raise HttpError(400, "endTs parameter is required")
        try:
            end_ts = int(q["endTs"])
            lookback = int(q.get("lookback") or self.config.default_lookback)
        except ValueError as e:
            raise HttpError(400, str(e))
        links = self.storage.span_store().get_dependencies(end_ts, lookback).execute()
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
        except ValueError as e:
            raise HttpError(400, str(e))
        return 200, self.storage.latency_quantiles(
            qs, q.get("serviceName"), q.get("spanName"), q.get("sketch", "digest") == "digest",
            end_ts, lookback)

    def get_tpu_cardinalities(self, q):
        try:
            end_ts, lookback = _opt_int(q, "endTs"), _opt_int(q, "lookback")
        except ValueError as e:
            raise HttpError(400, str(e))
        return 200, self.storage.trace_cardinalities(None, end_ts, lookback)

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
        except ValueError as e:
            raise HttpError(400, str(e))
        return 200, self.storage.sketch_overview(qs, q.get("serviceName"), q.get("spanName"))

    # -- ops ---------------------------------------------------------------

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
            for name in names + _DURABILITY_GAUGES + _MP_GAUGES:
                if name in counters:
                    out[f"gauge.zipkin_tpu.{name}"] = counters[name]
        return 200, out


def _handler_for(server: ZipkinServer):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        server_version = "zipkin-tpu-torch"

        def log_message(self, fmt, *args):  # requests are not logged
            pass

        def _send(self, status: int, body: bytes = b"", ctype: str = "text/plain; charset=utf-8",
                  headers: Optional[Dict[str, str]] = None):
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
            with server._idle:
                late = server._abandoned
            if late:
                # stop() snapshotted without this request: the sender retries
                self._send(503, b"server stopped")
                self.close_connection = True
                return
            if body is None:
                self._send(status)
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
            if not server.admit():
                self._send(503, b"server stopping")
                self.close_connection = True
                return
            try:
                method()
            finally:
                server.release()

        def do_GET(self):
            self._gated(self._get)

        def do_POST(self):
            self._gated(self._post)

        def _get(self):
            url = urlsplit(self.path)
            # the first value of a repeated parameter, as aiohttp's query.get
            query = {k: v[0] for k, v in parse_qs(url.query, keep_blank_values=True).items()}
            fn = server.get_routes.get(url.path)
            if fn is not None:
                self._answer(fn, query)
            elif url.path.startswith("/api/v2/trace/") and url.path.count("/") == 4:
                self._answer(server.get_trace, unquote(url.path[len("/api/v2/trace/"):]))
            else:
                self._send(404, b"404: Not Found")

        def _post(self):
            path = urlsplit(self.path).path
            route = server.post_routes.get(path)
            if route is None:
                self._send(405 if path in server.get_routes else 404)
                self.close_connection = True
                return
            try:
                body = self._read_body()
            except (PayloadTooLarge, BadLength) as e:
                # the rest of the body is left unread: the connection closes
                self._send(413 if isinstance(e, PayloadTooLarge) else 400, str(e).encode())
                self.close_connection = True
                return
            self._answer(route, body, self.headers.get("Content-Type", ""))

    return Handler


def run_server(config: Optional[ServerConfig] = None, stop: Optional[threading.Event] = None) -> None:
    """Serve until ``stop`` is set, then shut down cleanly."""
    server = ZipkinServer(config or ServerConfig.from_env()).start()
    try:
        (stop or threading.Event()).wait()
    finally:
        server.stop()

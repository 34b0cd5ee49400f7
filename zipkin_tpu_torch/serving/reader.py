"""Stateless reader process: the HTTP front end over one SegmentView (the
port of ``zipkin_tpu/serving/reader.py``, on the standard library's
``http.server.ThreadingHTTPServer`` instead of aiohttp).

Each reader maps the mirror segment read-only and serves the four
sketch read endpoints on its own port — the routes and parameters of
`server/app.py` (``/api/v2/dependencies``,
``/api/v2/tpu/percentiles|cardinalities|overview``), plus ``/metrics``
and ``/prometheus`` for the supervisor's reader-labeled aggregation.
Queries never enter the ingest process: every answer comes from the
shared-memory epoch, stamped with its real staleness
(``X-Staleness-Ms``), and anything the epoch cannot answer within
bounds is a 503 with Retry-After — a mirror-key miss (demanded back to
the publisher, carried next tick), an over-bound epoch age, a
requested-fresh read, or a segment torn/unpublished too long. Never a
silent stale answer. Bodies, headers and status codes are the
reference's, byte for byte (``json.dumps`` defaults, as aiohttp's
``json_response``).

A serve is a header-word compare plus a dict hit on the per-generation
memo; each request runs on its own thread, and no serve takes a lock of
any kind (:class:`~zipkin_tpu_torch.serving.shape.SegmentView` swaps its
decoded epoch as one reference).

Spawn entry: :func:`run_reader` (module-level; the import chain is numpy
and the standard library, never torch). SIGTERM ends it with exit code 0.
"""

from __future__ import annotations

import json
import math
import os
import re
import signal
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional
from urllib.parse import parse_qs, urlsplit

from zipkin_tpu_torch.serving.segment import MirrorSegment, SegmentUnavailable
from zipkin_tpu_torch.serving.shape import SegmentMiss, SegmentView, StalenessExceeded

_RETRY_AFTER_S = 1  # one publish tick; misses and swaps resolve by then
_JSON = "application/json; charset=utf-8"
_TEXT = "text/plain; charset=utf-8"

_CAMEL = re.compile(r"(?<!^)(?=[A-Z])")


def _snake(name: str) -> str:
    return _CAMEL.sub("_", name).lower()


class Answer:
    """One response: status, body bytes, content type and extra headers."""

    __slots__ = ("status", "body", "ctype", "headers")

    def __init__(self, status: int, body: bytes, ctype: str,
                 headers: Optional[Dict[str, str]] = None) -> None:
        self.status = status
        self.body = body
        self.ctype = ctype
        self.headers = headers or {}


def _json(body, status: int = 200, headers: Optional[Dict[str, str]] = None) -> Answer:
    return Answer(status, json.dumps(body).encode("utf-8"), _JSON, headers)


def _text(status: int, text: str, headers: Optional[Dict[str, str]] = None) -> Answer:
    return Answer(status, text.encode("utf-8"), _TEXT, headers)


def _unavailable(reason: str, retry_after_s: int = _RETRY_AFTER_S, **headers) -> Answer:
    h = {"Retry-After": str(retry_after_s)}
    h.update({k: str(v) for k, v in headers.items()})
    return _text(503, reason, h)


def _quantile_list(raw: str):
    qs = [float(x) for x in raw.split(",") if x]
    if not qs or any(not (0.0 <= q <= 1.0) for q in qs):
        raise ValueError(f"q out of range: {raw!r}")
    return qs


def _opt_int(query: Dict[str, str], name: str) -> Optional[int]:
    raw = query.get(name)
    return int(raw) if raw is not None else None


class ReaderApp:
    """One reader's handlers; state is the SegmentView alone. Each handler
    takes the request's query (first value of each parameter, blanks
    kept, as aiohttp's ``request.query.get``) and returns an
    :class:`Answer`."""

    def __init__(self, view: SegmentView, port: int = 0,
                 default_lookback: int = 86400000) -> None:
        self.view = view
        self.port = port
        self.default_lookback = default_lookback
        self.started_at = time.monotonic()
        self.routes = {
            "/api/v2/dependencies": self.get_dependencies,
            "/api/v2/tpu/percentiles": self.get_percentiles,
            "/api/v2/tpu/cardinalities": self.get_cardinalities,
            "/api/v2/tpu/overview": self.get_overview,
            "/health": self.get_health,
            "/metrics": self.get_metrics,
            "/prometheus": self.get_prometheus,
        }

    # -- request plumbing --------------------------------------------------

    @staticmethod
    def _staleness_param(query: Dict[str, str]) -> Optional[float]:
        raw = query.get("staleness_ms")
        return float(raw) if raw is not None else None

    def _serve(self, fn, *args) -> Answer:  # zt-reader-process: the 503 contract — miss/over-bound/torn all surface, none serve silently
        """The 503 contract: a miss, an over-bound age and a torn or
        unpublished segment all surface; none serves silently."""
        try:
            body, age_ms = fn(*args)
        except SegmentMiss as e:
            self.view.errors += 1
            return _unavailable(
                f"epoch does not carry {e.key!r} yet"
                + ("; registered for the next publish" if e.registered
                   else "; demand stripe full, retry"),
            )
        except StalenessExceeded as e:
            self.view.errors += 1
            if e.fresh_required:
                return _unavailable(
                    "staleness_ms<=0 demands a fresh read; readers serve "
                    "published epochs only — query the ingest server",
                )
            return _unavailable(
                f"epoch age {e.age_ms:.1f}ms exceeds bound {e.bound_ms:.1f}ms",
                retry_after_s=max(_RETRY_AFTER_S,
                                  int(math.ceil((e.age_ms - e.bound_ms) / 1000.0))),
            )
        except SegmentUnavailable as e:
            self.view.unavailable += 1
            self.view.errors += 1
            return _unavailable(f"segment unavailable: {e.reason}",
                                **{"X-Writer-Alive": int(e.writer_alive)})
        return _json(body, headers={"X-Staleness-Ms": f"{age_ms:.3f}"})

    # -- endpoints ---------------------------------------------------------

    def get_dependencies(self, q: Dict[str, str]) -> Answer:
        raw_end = q.get("endTs")
        if not raw_end:
            return _text(400, "endTs parameter is required")
        try:
            end_ts = int(raw_end)
            lookback = int(q.get("lookback") or self.default_lookback)
            staleness = self._staleness_param(q)
        except ValueError as e:
            return _text(400, str(e))
        return self._serve(self.view.serve_dependencies, end_ts, lookback, staleness,
                           q.get("tenant"))

    def get_percentiles(self, q: Dict[str, str]) -> Answer:
        try:
            qs = _quantile_list(q.get("q", "0.5,0.9,0.99"))
            end_ts, lookback = _opt_int(q, "endTs"), _opt_int(q, "lookback")
            staleness = self._staleness_param(q)
        except ValueError as e:
            return _text(400, str(e))
        return self._serve(self.view.serve_quantiles, qs, q.get("serviceName"),
                           q.get("spanName"), q.get("sketch", "digest") == "digest",
                           end_ts, lookback, staleness, q.get("tenant"))

    def get_cardinalities(self, q: Dict[str, str]) -> Answer:
        try:
            staleness = self._staleness_param(q)
            end_ts, lookback = _opt_int(q, "endTs"), _opt_int(q, "lookback")
        except ValueError as e:
            return _text(400, str(e))
        return self._serve(self.view.serve_cardinalities, staleness, end_ts, lookback,
                           q.get("tenant"))

    def get_overview(self, q: Dict[str, str]) -> Answer:
        try:
            qs = _quantile_list(q.get("q", "0.5,0.9,0.99"))
            staleness = self._staleness_param(q)
        except ValueError as e:
            return _text(400, str(e))
        return self._serve(self.view.serve_overview, qs, q.get("serviceName"),
                           q.get("spanName"), staleness, q.get("tenant"))

    # -- ops ---------------------------------------------------------------

    def get_health(self, q: Dict[str, str]) -> Answer:
        try:
            self.view.refresh()
        except SegmentUnavailable as e:
            return _json({"status": "DOWN", "reason": e.reason}, status=503,
                         headers={"Retry-After": str(_RETRY_AFTER_S)})
        return _json({"status": "UP", "reader": f"r{self.view.reader_idx}",
                      "generation": self.view.counters()["readerGeneration"]})

    def get_metrics(self, q: Dict[str, str]) -> Answer:
        body = dict(self.view.counters())
        body["readerPid"] = os.getpid()
        body["readerPort"] = self.port
        body["readerUptimeS"] = round(time.monotonic() - self.started_at, 3)
        return _json({"reader": body})

    def get_prometheus(self, q: Dict[str, str]) -> Answer:
        label = f'reader="r{self.view.reader_idx}"'
        lines = []
        for name, value in self.view.counters().items():
            if isinstance(value, bool):
                value = int(value)
            if not isinstance(value, (int, float)):
                continue
            lines.append(f"zipkin_tpu_{_snake(name)}{{{label}}} {value}")
        return _text(200, "\n".join(lines) + "\n")

    # -- the listener ------------------------------------------------------

    def make_server(self, host: str = "127.0.0.1", port: Optional[int] = None) -> ThreadingHTTPServer:
        """A bound listener serving this app (port 0: ephemeral, read back
        from ``server_address``); the caller runs ``serve_forever``."""
        return _Listener((host, self.port if port is None else port), handler_for(self.routes))


class _Listener(ThreadingHTTPServer):
    daemon_threads = True
    request_queue_size = 128


def handler_for(routes: Dict[str, object]):
    """A request handler class that answers GETs from ``routes`` (path ->
    handler(query) -> :class:`Answer`); anything else is a 404."""

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        server_version = "zipkin-tpu-torch-reader"

        def log_message(self, fmt, *args):  # requests are not logged
            pass

        def do_GET(self):
            url = urlsplit(self.path)
            query = {k: v[0] for k, v in parse_qs(url.query, keep_blank_values=True).items()}
            fn = routes.get(url.path)
            if fn is None:
                ans = _text(404, "404: Not Found")
            else:
                try:
                    ans = fn(query)
                except Exception as e:  # the request fails, the reader keeps serving
                    ans = _text(500, f"{type(e).__name__}: {e}")
            self.send_response(ans.status)
            for name, value in ans.headers.items():
                self.send_header(name, value)
            self.send_header("Content-Type", ans.ctype)
            self.send_header("Content-Length", str(len(ans.body)))
            self.end_headers()
            self.wfile.write(ans.body)

    return Handler


def serve_until_signalled(httpd: ThreadingHTTPServer) -> None:
    """Serve on the calling (main) thread until SIGTERM or SIGINT."""
    def _stop(signum, frame):
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _stop)
    signal.signal(signal.SIGINT, _stop)
    try:
        httpd.serve_forever(poll_interval=0.2)
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()


def run_reader(seg_params: dict, reader_idx: int, port: int,
               default_lookback: int = 86400000) -> None:  # zt-reader-process: spawn entry — attaches the segment and serves; imports numpy and the standard library, never torch or the store
    """Blocking reader main (the supervisor's spawn target): attaches the
    segment and serves; imports numpy and the standard library, never
    torch or the store."""
    segment = MirrorSegment.attach(seg_params)
    view = SegmentView(segment, reader_idx)
    app = ReaderApp(view, port=port, default_lookback=default_lookback)
    try:
        serve_until_signalled(app.make_server())
    finally:
        # drop the numpy control-word views before interpreter shutdown
        # collects the SharedMemory object, or its __del__ meets exported
        # buffer pointers
        segment.close()

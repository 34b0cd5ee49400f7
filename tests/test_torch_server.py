"""The port's HTTP server (``zipkin_tpu_torch.server``, standard library
only) driven over real sockets on an ephemeral port.

- Ports of the reference's server cases (``tests/test_server.py``
  ``TestIngestAndQuery``, ``TestOps``, ``TestSampling``, the throttle and
  gzip edges of ``tests/test_backpressure_and_edges.py``, and
  ``tests/test_server_tpu.py:48-141``), over ``InMemoryStorage`` and over
  ``TorchStorage(device="cpu")``.
- HTTP parity: the same POSTs to the port's server and to the reference's
  aiohttp server over a one-shard ``TpuStorage``; every GET body equal,
  percentile rows within the digest's rtol 1e-5 and HLL estimates within
  rtol 1e-6 (the tolerances of ``tests/test_torch_store.py``).
- Concurrency, the entry point's ``--help``, and that the server loads no
  aiohttp.
- The multi-process ingest tier behind the server: the ``TPU_MP_*``
  settings, the tier refused with the reference's warning off the device
  store or the line-rate path, 202 and every span landed, 429 on a full
  tier beside the throttle's 503, the ``alloc`` site's 429, and ``stop()``
  (or the resume adapter's ``close()``) draining and closing the tier
  before the final snapshot.
"""

from __future__ import annotations

import asyncio
import gzip
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.parse
import urllib.request

import numpy as np
import pytest

from tests.fixtures import TRACE, TODAY, lots_of_spans
from tests.test_torch_store import JSMALL, SMALL, ref_store, small_store, to_port
import tests.torch_cpu  # noqa: F401  (one intra-op thread a test process)
from zipkin_tpu.model import json_v1 as ref_json_v1
from zipkin_tpu.model import json_v2 as ref_json
from zipkin_tpu.model import proto3 as ref_proto3
from zipkin_tpu_torch import native
from zipkin_tpu_torch.collector.core import Collector, CollectorSampler
from zipkin_tpu_torch.model import json_v2 as port_json
from zipkin_tpu_torch.model.span import Span as PortSpan
from zipkin_tpu_torch.server.app import ZipkinServer, parse_annotation_query
from zipkin_tpu_torch.server.config import ServerConfig
from zipkin_tpu_torch.storage.memory import InMemoryStorage
from zipkin_tpu_torch.storage.spi import SpanConsumer
from zipkin_tpu_torch.storage.throttle import RejectedExecutionError
from zipkin_tpu_torch.utils.call import Call

DAY_MS = 86_400_000
QUERY_TS = TODAY + 3_600_000
TRACE_BODY = ref_json.encode_span_list(TRACE)


class Client:
    """urllib against one running server: (status, body bytes)."""

    def __init__(self, server: ZipkinServer) -> None:
        self.base = f"http://127.0.0.1:{server.port}"

    def request(self, method, path, data=None, headers=None, params=None):
        url = self.base + path + ("?" + urllib.parse.urlencode(params) if params else "")
        req = urllib.request.Request(url, data=data, headers=headers or {}, method=method)
        try:
            with urllib.request.urlopen(req, timeout=60) as resp:
                return resp.status, resp.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()

    def post(self, path, data, headers=None):
        return self.request("POST", path, data, headers)

    def get(self, path, params=None):
        return self.request("GET", path, params=params)

    def json(self, path, params=None):
        status, body = self.get(path, params)
        assert status == 200, (path, status, body)
        return json.loads(body)


def serve(storage=None, **config):
    config.setdefault("storage_type", "mem")  # the card's store is the default
    config.setdefault("default_lookback", DAY_MS)
    config.setdefault("autocomplete_keys", ("env",))
    server = ZipkinServer(ServerConfig(host="127.0.0.1", port=0, **config), storage=storage,
                          seal_interval_s=0)
    return server.start()


@pytest.fixture
def served():
    servers = []

    def start(storage=None, **config):
        server = serve(storage, **config)
        servers.append(server)
        return Client(server)

    yield start
    for server in servers:
        server.stop()


def make_storage(kind: str):
    if kind == "mem":
        return InMemoryStorage(autocomplete_keys=("env",))
    store = small_store(autocomplete_keys=("env",))
    store._deps_max_stale_ms = 0.0
    return store


STORES = pytest.mark.parametrize("kind", ["mem", "torch"])


def config_of(kind: str) -> dict:
    return {"storage_type": "mem" if kind == "mem" else "tpu"}


# -- ports of the reference's server cases ------------------------------------


@STORES
def test_baseline_post_trace_and_read_back(served, kind):
    c = served(make_storage(kind), **config_of(kind))
    assert c.post("/api/v2/spans", TRACE_BODY, {"Content-Type": "application/json"})[0] == 202
    spans = port_json.decode_span_list(c.get(f"/api/v2/trace/{TRACE[0].trace_id}")[1])
    key = lambda s: (s.id, bool(s.shared))  # noqa: E731
    assert sorted(spans, key=key) == sorted(to_port(TRACE), key=key)


@STORES
@pytest.mark.parametrize("how", ["gzip", "proto3", "v1"])
def test_post_encodings(served, kind, how):
    c = served(make_storage(kind), **config_of(kind))
    if how == "gzip":
        status, _ = c.post("/api/v2/spans", gzip.compress(TRACE_BODY), {"Content-Encoding": "gzip"})
    elif how == "proto3":
        status, _ = c.post("/api/v2/spans", ref_proto3.encode_span_list(TRACE),
                           {"Content-Type": "application/x-protobuf"})
    else:
        status, _ = c.post("/api/v1/spans", ref_json_v1.encode_v1_span_list(TRACE))
    assert status == 202
    assert c.get(f"/api/v2/trace/{TRACE[0].trace_id}")[0] == 200
    assert "frontend" in c.json("/api/v2/services")


@STORES
def test_post_malformed_is_400(served, kind):
    c = served(make_storage(kind), **config_of(kind))
    assert c.post("/api/v2/spans", b"\xffnot-spans")[0] == 400
    assert c.post("/api/v2/spans", b'[{"traceId":"x!"}]')[0] == 400
    assert c.post("/api/v2/spans", b"\x1f\x8bnot-gzip")[0] == 400
    assert c.json("/metrics")["counter.zipkin_collector.messages_dropped.http"] == 2


@STORES
def test_search_traces(served, kind):
    c = served(make_storage(kind), **config_of(kind))
    c.post("/api/v2/spans", TRACE_BODY)
    traces = c.json("/api/v2/traces", {"serviceName": "backend", "endTs": QUERY_TS,
                                       "lookback": DAY_MS})
    assert len(traces) == 1 and len(traces[0]) == len(TRACE)
    assert c.json("/api/v2/traces", {"serviceName": "nope", "endTs": QUERY_TS}) == []
    assert len(c.json("/api/v2/traces", {"annotationQuery": "error", "endTs": QUERY_TS})) == 1
    assert c.get("/api/v2/traces", {"lookback": "-5"})[0] == 400


@STORES
def test_trace_not_found_404_bad_id_400_and_trace_many(served, kind):
    c = served(make_storage(kind), **config_of(kind))
    assert c.get("/api/v2/trace/feed")[0] == 404
    assert c.get("/api/v2/trace/nothex!")[0] == 400
    c.post("/api/v2/spans", TRACE_BODY)
    assert len(c.json("/api/v2/traceMany", {"traceIds": f"{TRACE[0].trace_id},feed"})) == 1
    assert c.get("/api/v2/traceMany")[0] == 400
    assert c.get("/api/v2/nope")[0] == 404


@STORES
def test_names_endpoints(served, kind):
    c = served(make_storage(kind), **config_of(kind))
    c.post("/api/v2/spans", TRACE_BODY)
    assert c.json("/api/v2/services") == ["backend", "frontend"]
    assert c.json("/api/v2/spans", {"serviceName": "frontend"}) == ["get /", "get /api"]
    assert c.json("/api/v2/remoteServices", {"serviceName": "backend"}) == ["mysql"]


@STORES
def test_dependencies(served, kind):
    c = served(make_storage(kind), **config_of(kind))
    c.post("/api/v2/spans", TRACE_BODY)
    got = sorted(c.json("/api/v2/dependencies", {"endTs": QUERY_TS, "lookback": DAY_MS}),
                 key=lambda x: x["parent"])
    assert got == [
        {"parent": "backend", "child": "mysql", "callCount": 1, "errorCount": 1},
        {"parent": "frontend", "child": "backend", "callCount": 1},
    ]
    assert c.get("/api/v2/dependencies")[0] == 400
    assert c.get("/api/v2/dependencies", {"endTs": "x"})[0] == 400


@STORES
def test_autocomplete(served, kind):
    c = served(make_storage(kind), **config_of(kind))
    span = dict(ref_json.span_to_dict(TRACE[0]))
    span["tags"] = {"env": "prod"}
    c.post("/api/v2/spans", json.dumps([span]).encode())
    assert c.json("/api/v2/autocompleteKeys") == ["env"]
    assert c.json("/api/v2/autocompleteValues", {"key": "env"}) == ["prod"]
    assert c.get("/api/v2/autocompleteValues")[0] == 400


@STORES
def test_health_info_and_metrics(served, kind):
    c = served(make_storage(kind), **config_of(kind))
    body = c.json("/health")
    assert body["status"] == "UP" and body["zipkin"][config_of(kind)["storage_type"]]["status"] == "UP"
    assert "version" in c.json("/info")["zipkin"]
    c.post("/api/v2/spans", TRACE_BODY)
    metrics = c.json("/metrics")
    assert metrics["counter.zipkin_collector.messages.http"] == 1
    assert metrics["counter.zipkin_collector.spans.http"] == len(TRACE)
    assert metrics["counter.zipkin_collector.bytes.http"] == len(TRACE_BODY)
    if kind == "torch":
        assert "gauge.zipkin_tpu.ctxDeltaLanes" in metrics
        assert "gauge.zipkin_tpu.ctxMaintenanceMs" in metrics


def test_annotation_query_grammar():
    assert parse_annotation_query("error and http.method=GET") == {"error": "", "http.method": "GET"}
    assert parse_annotation_query(None) == {}
    assert parse_annotation_query("a=1 and a=2") == {"a": "2"}


def test_sample_rate_zero_drops_all_but_debug():
    storage = InMemoryStorage()
    collector = Collector(storage, sampler=CollectorSampler(0.0))
    normal = PortSpan.create("cafe", "1", timestamp=1, duration=1)
    debug = PortSpan.create("feed", "2", timestamp=1, duration=1, debug=True)
    assert collector.accept([normal, debug]) == 1
    assert storage.span_count == 1


def test_sampler_is_consistent_per_trace():
    sampler = CollectorSampler(0.5)
    for trace_id in (0x123456789ABCDEF0, 0xFEDCBA9876543210, 1, 2**63 + 5):
        assert sampler.is_sampled(trace_id) == sampler.is_sampled(trace_id)


class _RejectingConsumer(SpanConsumer):
    def accept(self, spans):
        def run():
            raise RejectedExecutionError("queue full")

        return Call.of(run)


class _RejectingStorage(InMemoryStorage):
    def span_consumer(self):
        return _RejectingConsumer()


def test_throttle_shed_maps_to_503(served):
    c = served(_RejectingStorage())
    assert c.post("/api/v2/spans", TRACE_BODY, {"Content-Type": "application/json"})[0] == 503
    metrics = c.json("/metrics")
    assert metrics["counter.zipkin_collector.spans_dropped.http"] == len(TRACE)


def test_server_boots_with_throttle_enabled(served):
    c = served(throttle_enabled=True)
    assert c.post("/api/v2/spans", TRACE_BODY)[0] == 202
    assert c.get("/health")[0] == 200
    assert len(c.json(f"/api/v2/trace/{TRACE[0].trace_id}")) == len(TRACE)


def test_gzip_bomb_rejected_413():
    server = serve(InMemoryStorage())
    server.MAX_INFLATED = 1024 * 1024  # a small cap for the test
    try:
        bomb = gzip.compress(b"[" + b" " * (8 * 1024 * 1024) + b"]")
        status, _ = Client(server).post("/api/v2/spans", bomb, {"Content-Type": "application/json"})
        assert status == 413
    finally:
        server.stop()


def test_gzip_member_after_the_cap_rejected_413():
    """A first member that fills the cap exactly leaves no room: a second
    member is refused, however small its limit would have been."""
    server = serve(InMemoryStorage())
    cap = server.MAX_INFLATED = 1024 * 1024
    try:
        first = gzip.compress(b" " * cap)
        half = gzip.compress(b" " * (cap // 2))
        assert server._inflate(first) == server._inflate(half + half) == b" " * cap
        bomb = first + gzip.compress(b" " * (8 * cap))
        status, _ = Client(server).post("/api/v2/spans", bomb, {"Content-Type": "application/json"})
        assert status == 413
        status, _ = Client(server).post("/api/v2/spans", first + gzip.compress(b" "),
                                        {"Content-Type": "application/json"})
        assert status == 413
    finally:
        server.stop()


def test_chunked_body_and_oversized_body(served):
    """A chunked POST is read whole; a body declared past the 64 MiB cap is
    refused with 413 before it is read."""
    import http.client

    c = served(InMemoryStorage())
    port = int(c.base.rsplit(":", 1)[1])
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("POST", "/api/v2/spans", body=iter([TRACE_BODY[:100], TRACE_BODY[100:]]),
                     headers={"Content-Type": "application/json"}, encode_chunked=True)
        assert conn.getresponse().status == 202
    finally:
        conn.close()
    assert len(c.json(f"/api/v2/trace/{TRACE[0].trace_id}")) == len(TRACE)
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.putrequest("POST", "/api/v2/spans")
        conn.putheader("Content-Length", str(65 * 1024 * 1024))
        conn.endheaders()
        assert conn.getresponse().status == 413
    finally:
        conn.close()


def _raw_post(port: int, head: bytes, body: bytes = b"") -> bytes:
    """Send a request's head and the start of its body without closing the
    connection; return the answer, which must come within 10 s."""
    import socket

    with socket.create_connection(("127.0.0.1", port), timeout=10) as sock:
        sock.sendall(b"POST /api/v2/spans HTTP/1.1\r\nHost: x\r\n" + head + b"\r\n" + body)
        out = b""
        while b"\r\n\r\n" not in out:
            chunk = sock.recv(4096)  # socket.timeout here: the server kept reading
            if not chunk:
                break
            out += chunk
        return out


@pytest.mark.parametrize("head", [
    b"Content-Length: -1\r\n",
    b"Content-Length: 12abc\r\n",
    b"Transfer-Encoding: chunked\r\n",
], ids=["negative_length", "malformed_length", "negative_chunk"])
def test_negative_or_malformed_lengths_get_400(served, head):
    """A length that is negative or not a number is refused with 400 at
    once; the server neither reads to the end of the stream nor drops the
    connection without an answer. The 413 cap stays."""
    c = served(InMemoryStorage())
    port = int(c.base.rsplit(":", 1)[1])
    body = b"-1\r\n" + b"x" * 100 if b"chunked" in head else b"[" * 100
    answer = _raw_post(port, head, body)
    assert answer.startswith(b"HTTP/1.1 400"), answer
    answer = _raw_post(port, b"Transfer-Encoding: chunked\r\n", b"zz\r\n" + b"x" * 100)
    assert answer.startswith(b"HTTP/1.1 400"), answer
    assert _raw_post(port, b"Transfer-Encoding: chunked\r\n",
                     b"%x\r\n" % (65 * 1024 * 1024)).startswith(b"HTTP/1.1 413")
    assert c.post("/api/v2/spans", TRACE_BODY, {"Content-Type": "application/json"})[0] == 202


# -- ports of tests/test_server_tpu.py:48-141 ---------------------------------


@pytest.mark.parametrize("fast", [False, True], ids=["object", "fast"])
def test_device_store_post_query_back_and_dependencies(served, fast):
    if fast and not native.available():
        pytest.skip("no C compiler for the native parser")
    c = served(make_storage("torch"), storage_type="tpu", tpu_fast_ingest=fast)
    assert c.post("/api/v2/spans", TRACE_BODY, {"Content-Type": "application/json"})[0] == 202
    if not fast:  # the fast path archives a 1/64 trace sample
        assert len(c.json(f"/api/v2/trace/{TRACE[0].trace_id}")) == len(TRACE)
    got = {(x["parent"], x["child"]): x
           for x in c.json("/api/v2/dependencies", {"endTs": QUERY_TS, "lookback": DAY_MS})}
    assert got[("frontend", "backend")]["callCount"] == 1
    assert got[("backend", "mysql")]["errorCount"] == 1


def test_device_store_percentile_and_cardinality_endpoints(served):
    c = served(make_storage("torch"), storage_type="tpu")
    spans = lots_of_spans(1500, seed=21, services=5, span_names=6)
    assert c.post("/api/v2/spans", ref_json.encode_span_list(spans),
                  {"Content-Type": "application/json"})[0] == 202
    rows = c.json("/api/v2/tpu/percentiles", {"q": "0.5,0.99"})
    assert rows and all("quantiles" in r for r in rows)
    one = rows[0]["serviceName"]
    svc_rows = c.json("/api/v2/tpu/percentiles", {"serviceName": one, "sketch": "hist"})
    assert svc_rows and all(r["serviceName"] == one for r in svc_rows)
    cards = c.json("/api/v2/tpu/cardinalities")
    true_traces = len({s.trace_id for s in spans})
    assert abs(cards["_global"] - true_traces) / true_traces < 0.15
    assert c.json("/api/v2/tpu/counters")["spans"] == len(spans)
    overview = c.json("/api/v2/tpu/overview", {"q": "0.5,0.99"})
    assert overview["percentiles"] == rows and overview["cardinalities"] == cards
    assert c.get("/api/v2/tpu/percentiles", {"q": "1.5"})[0] == 400
    assert c.get("/api/v2/tpu/overview", {"q": "x"})[0] == 400
    assert c.post("/api/v2/tpu/snapshot", b"")[0] == 501  # the core store does not snapshot


def test_seal_ticker_seals_the_time_tier_and_stops():
    import time

    store = make_storage("torch")
    server = ZipkinServer(ServerConfig(host="127.0.0.1", port=0, storage_type="tpu"),
                          storage=store, seal_interval_s=0.05).start()
    try:
        assert Client(server).post("/api/v2/spans", TRACE_BODY)[0] == 202
        deadline = time.monotonic() + 30
        while store.ingest_counters()["ttSeals"] == 0 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert store.ingest_counters()["ttSeals"] > 0
        threads = list(server._threads)
    finally:
        server.stop()
    assert threads and not any(t.is_alive() for t in threads)


def test_sketch_routes_only_over_a_device_store(served):
    c = served(InMemoryStorage())
    assert c.get("/api/v2/tpu/percentiles")[0] == 404


# -- HTTP parity with the reference's aiohttp server ----------------------------


def _ref_exchange(storage, config, requests):
    """The requests against the reference server over ``storage``: [(status,
    body bytes)]."""
    from aiohttp.test_utils import TestClient, TestServer

    from zipkin_tpu.server.app import ZipkinServer as RefServer
    from zipkin_tpu.server.config import ServerConfig as RefConfig

    async def run():
        server = RefServer(RefConfig(**config), storage=storage)
        client = TestClient(TestServer(server.make_app()))
        await client.start_server()
        out = []
        try:
            for method, path, data, headers, params in requests:
                resp = await client.request(method, path, data=data, headers=headers or {},
                                            params=params)
                out.append((resp.status, await resp.read()))
        finally:
            await client.close()
        return out

    return asyncio.run(run())


def _port_exchange(storage, config, requests):
    server = serve(storage, **config)
    try:
        client = Client(server)
        return [client.request(m, p, d, h, params) for m, p, d, h, params in requests]
    finally:
        server.stop()


def _assert_bodies_equal(path, got, want):
    if path == "/metrics":  # the reference adds planes the port leaves out
        got = {k: v for k, v in got.items() if k.startswith("counter.")}
        want = {k: v for k, v in want.items() if k.startswith("counter.")}
    if path == "/api/v2/tpu/overview":  # its counters hold wall-clock gauges
        _assert_bodies_equal("/api/v2/tpu/percentiles", got["percentiles"], want["percentiles"])
        _assert_bodies_equal("/api/v2/tpu/cardinalities", got["cardinalities"], want["cardinalities"])
        assert got["counters"]["spans"] == want["counters"]["spans"]
    elif path == "/api/v2/tpu/percentiles":
        assert [(r["serviceName"], r["spanName"], r["count"]) for r in got] == \
            [(r["serviceName"], r["spanName"], r["count"]) for r in want]
        for g, w in zip(got, want):
            assert list(g["quantiles"]) == list(w["quantiles"])
            np.testing.assert_allclose(list(g["quantiles"].values()), list(w["quantiles"].values()),
                                       rtol=1e-5)
    elif path == "/api/v2/tpu/cardinalities":
        assert list(got) == list(want)
        np.testing.assert_allclose(list(got.values()), list(want.values()), rtol=1e-6)
    else:
        assert got == want, path


@pytest.mark.parametrize("fast", [False, True], ids=["object", "fast"])
def test_get_bodies_equal_the_reference_server(fast):
    if fast and not native.available():
        pytest.skip("no C compiler for the native parser")
    spans = lots_of_spans(3000, seed=17, services=6, span_names=5)
    tagged = dict(ref_json.span_to_dict(TRACE[0]))
    tagged["tags"] = {"env": "prod"}
    end_ts = max(s.timestamp for s in spans) // 1000 + 60_000
    posts = [
        ("POST", "/api/v2/spans", ref_json.encode_span_list(spans[:1000]),
         {"Content-Type": "application/json"}, None),
        ("POST", "/api/v2/spans", ref_proto3.encode_span_list(spans[1000:2000]),
         {"Content-Type": "application/x-protobuf"}, None),
        ("POST", "/api/v2/spans", gzip.compress(ref_json.encode_span_list(spans[2000:])),
         {"Content-Encoding": "gzip"}, None),
        ("POST", "/api/v1/spans", ref_json_v1.encode_v1_span_list(TRACE), None, None),
        ("POST", "/api/v2/spans", json.dumps([tagged]).encode(), None, None),
        ("POST", "/api/v2/spans", b"\xffnot-spans", None, None),
    ]
    sample_ids = sorted({s.trace_id for s in spans})[:40] + [TRACE[0].trace_id]
    window = {"endTs": str(end_ts), "lookback": str(DAY_MS)}
    gets = [
        ("/api/v2/services", None), ("/api/v2/spans", {"serviceName": "svc01"}),
        ("/api/v2/remoteServices", {"serviceName": "svc01"}),
        ("/api/v2/traces", {"serviceName": "svc02", "limit": "5", **window}),
        ("/api/v2/traces", {"annotationQuery": "error", "endTs": str(QUERY_TS)}),
        ("/api/v2/traceMany", {"traceIds": ",".join(sample_ids)}), ("/api/v2/traceMany", None),
        ("/api/v2/trace/feed", None), ("/api/v2/trace/nothex!", None),
        ("/api/v2/dependencies", window), ("/api/v2/dependencies", None),
        ("/api/v2/autocompleteKeys", None), ("/api/v2/autocompleteValues", {"key": "env"}),
        ("/api/v2/autocompleteValues", None),
        ("/api/v2/tpu/percentiles", {"q": "0.5,0.99"}),
        ("/api/v2/tpu/percentiles", {"serviceName": "svc01", "sketch": "hist"}),
        ("/api/v2/tpu/percentiles", {"q": "1.5"}),
        ("/api/v2/tpu/cardinalities", None), ("/api/v2/tpu/overview", {"q": "0.5,0.99"}),
        ("/health", None), ("/info", None), ("/metrics", None),
    ] + [(f"/api/v2/trace/{tid}", None) for tid in sample_ids]
    requests = posts + [("GET", path, None, None, params) for path, params in gets]
    common = dict(default_lookback=DAY_MS, storage_type="tpu", tpu_fast_ingest=fast,
                  autocomplete_keys=("env",))
    ref = ref_store(autocomplete_keys=("env",))
    port = small_store(autocomplete_keys=("env",))
    ref._deps_max_stale_ms = port._deps_max_stale_ms = 0.0
    want = _ref_exchange(ref, common, requests)
    got = _port_exchange(port, common, requests)
    assert [s for s, _ in got] == [s for s, _ in want]
    assert [s for s, _ in got[: len(posts)]] == [202] * (len(posts) - 1) + [400]
    found = 0
    for (method, path, *_), (status, g), (_, w) in zip(requests, got, want):
        if method == "GET" and status == 200:
            _assert_bodies_equal(path, json.loads(g), json.loads(w))
            found += path.startswith("/api/v2/trace/")
    assert found >= (2 if fast else len(sample_ids))
    assert JSMALL.max_keys == SMALL.max_keys


# -- concurrency and the entry point ------------------------------------------


def test_concurrent_posts_count_every_span(served):
    """8 threads POST at once through the fast path into one device store
    (C interning under the store's intern lock): every counter sums."""
    if not native.available():
        pytest.skip("no C compiler for the native parser")
    store = make_storage("torch")
    c = served(store, storage_type="tpu", tpu_fast_ingest=True)
    bodies = [(ref_proto3 if i % 2 else ref_json).encode_span_list(
        lots_of_spans(300, seed=100 + i, services=8, span_names=4)) for i in range(16)]
    statuses, lock = [], threading.Lock()

    def post(mine):
        for body in mine:
            status, _ = c.post("/api/v2/spans", body)
            with lock:
                statuses.append(status)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=post, args=(bodies[i::8],)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert statuses == [202] * len(bodies)
    metrics = c.json("/metrics")
    assert metrics["counter.zipkin_collector.messages.http"] == len(bodies)
    assert metrics["counter.zipkin_collector.spans.http"] == 300 * len(bodies)
    assert metrics["counter.zipkin_collector.bytes.http"] == sum(map(len, bodies))
    assert store.ingest_counters()["spans"] == 300 * len(bodies)
    assert store.ingest_counters()["batches"] == len(bodies)
    # ids stayed coherent: every service and key interned once
    names = store.vocab.services.names
    assert len(names) == len(set(names)) == 8
    assert len(store.vocab._key_list) == len(set(store.vocab._key_list))


def test_entry_point_help_exits_0():
    out = subprocess.run([sys.executable, "-m", "zipkin_tpu_torch.server", "--help"],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "--storage" in out.stdout


def test_server_modules_load_no_aiohttp():
    code = ("import sys\n"
            "import zipkin_tpu_torch.server.__main__, zipkin_tpu_torch.server.app\n"
            "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
            "('aiohttp', 'grpc', 'jax', 'zipkin_tpu'))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


# -- the multi-process ingest tier ----------------------------------------------


def test_mp_settings_parse_from_the_environment(monkeypatch):
    """``TPU_MP_WORKERS`` (0: off), ``TPU_MP_QUEUE_DEPTH``, ``TPU_MP_RING_SLOTS``
    and ``TPU_MP_COALESCE_MAX``: the reference's names and defaults."""
    for name in ("TPU_MP_WORKERS", "TPU_MP_QUEUE_DEPTH", "TPU_MP_RING_SLOTS", "TPU_MP_COALESCE_MAX"):
        monkeypatch.delenv(name, raising=False)
    cfg = ServerConfig.from_env()
    assert (cfg.tpu_mp_workers, cfg.tpu_mp_queue_depth, cfg.tpu_mp_ring_slots,
            cfg.tpu_mp_coalesce_max) == (0, 2, 0, 8)
    monkeypatch.setenv("TPU_MP_WORKERS", "3")
    monkeypatch.setenv("TPU_MP_QUEUE_DEPTH", "5")
    monkeypatch.setenv("TPU_MP_RING_SLOTS", "6")
    monkeypatch.setenv("TPU_MP_COALESCE_MAX", "4")
    cfg = ServerConfig.from_env()
    assert (cfg.tpu_mp_workers, cfg.tpu_mp_queue_depth, cfg.tpu_mp_ring_slots,
            cfg.tpu_mp_coalesce_max) == (3, 5, 6, 4)


@pytest.mark.parametrize("why", ["mem", "no_fast_ingest"])
def test_mp_tier_refused_with_the_reference_warning(served, caplog, why):
    """The tier is the line-rate path's scale-out over the device store: on
    ``mem``, or with fast ingest off, it is not built, with the reference's
    warning, and POSTs take the synchronous path."""
    if why == "mem":
        c = served(storage_type="mem", tpu_fast_ingest=True, tpu_mp_workers=2)
    else:
        c = served(small_store(), storage_type="tpu", tpu_mp_workers=2)
    assert "TPU_MP_WORKERS=2 ignored: requires STORAGE_TYPE=tpu" in caplog.text
    assert c.post("/api/v2/spans", TRACE_BODY)[0] == 202
    assert len(c.json(f"/api/v2/trace/{TRACE[0].trace_id}")) == len(TRACE)
    assert "gauge.zipkin_tpu.mpWorkers" not in c.json("/metrics")


def _mp_payloads(n, per=500):
    spans = lots_of_spans(n * per, seed=71, services=5, span_names=6)
    return [(ref_proto3 if i % 2 else ref_json).encode_span_list(spans[i * per:(i + 1) * per])
            for i in range(n)]


def _post_until_accepted(c, body, headers=None, limit_s=60.0):
    """POST as a client that backs off on 429 (the tier refuses while every
    worker's queue is full, as it is while the workers start); the final
    status and the 429s seen."""
    refused = 0
    deadline = time.monotonic() + limit_s
    while True:
        status = c.post("/api/v2/spans", body, headers)[0]
        if status != 429 or time.monotonic() > deadline:
            return status, refused
        refused += 1
        time.sleep(0.02)


def _mp_server(storage, **config):
    config.setdefault("tpu_mp_workers", 2)
    return serve(storage, storage_type="tpu", tpu_fast_ingest=True, **config)


def test_mp_tier_answers_202_and_lands_every_span():
    """JSON v2 and proto3 POSTs go to the workers and are answered 202; after
    a drain every span is in the store, and /metrics carries the tier's
    gauges; stop() closes the tier and unhooks it from the store."""
    if not native.available():
        pytest.skip("no C compiler for the native parser")
    store = small_store()
    server = _mp_server(store)
    c = Client(server)
    try:
        ing = server._mp_ingester
        assert ing is not None and store.mp_ingester is ing and server.collector.mp_ingester is ing
        ps = _mp_payloads(6)
        refused = 0
        for p in ps:
            ctype = "application/x-protobuf" if p[:1] == b"\n" else "application/json"
            status, n = _post_until_accepted(c, p, {"Content-Type": ctype})
            assert status == 202
            refused += n
        ing.drain()
        assert store.agg.host_counters["spans"] == 3000
        m = c.json("/metrics")
        assert m["gauge.zipkin_tpu.mpWorkers"] == m["gauge.zipkin_tpu.mpWorkersAlive"] == 2
        assert m["gauge.zipkin_tpu.mpAccepted"] == m["counter.zipkin_collector.spans.http"] == 3000
        assert m["gauge.zipkin_tpu.mpInflight"] == 0
        # a 429 is a full tier or an admission shed (the ladder is on)
        assert m["gauge.zipkin_tpu.mpRejected"] + m["gauge.zipkin_tpu.overloadShedTotal"] \
            + m["gauge.zipkin_tpu.overloadShedTenant"] == refused
        assert m["counter.zipkin_collector.messages_dropped.http"] == refused
    finally:
        server.stop()
    assert ing._closed and store.mp_ingester is None


def test_full_tier_answers_429_and_the_throttle_keeps_503():
    """A frozen lone worker with a queue of one: the first POST is queued
    (202), the next finds every queue full (429 with the overload ladder's
    backoff guidance and scope ``global``, as the reference answers a full
    tier), while a throttle shed on the object path stays 503. Unfrozen,
    the 202'd payload lands at stop()."""
    if not native.available():
        pytest.skip("no C compiler for the native parser")
    store = small_store()
    server = _mp_server(store, tpu_mp_workers=1, tpu_mp_queue_depth=1)
    c = Client(server)
    ing = server._mp_ingester
    pid = ing._procs[0].pid
    os.kill(pid, signal.SIGSTOP)
    try:
        ps = _mp_payloads(3, per=100)
        assert c.post("/api/v2/spans", ps[0])[0] == 202
        url = f"{c.base}/api/v2/spans"
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(urllib.request.Request(url, data=ps[2], method="POST"),
                                   timeout=60)
        assert e.value.code == 429 and "saturated" in e.value.read().decode()
        assert int(e.value.headers["Retry-After"]) >= 1
        assert int(e.value.headers["X-Retry-After-Ms"]) >= 50
        assert e.value.headers["X-Shed-Scope"] == "global"
        assert ing.counters["rejected"] == 1

        class Shedding(SpanConsumer):
            def accept(self, spans):
                raise RejectedExecutionError("throttle full")

        server.collector._consumer = Shedding()
        v1 = ref_json_v1.encode_v1_span_list(TRACE)
        assert c.post("/api/v1/spans", v1, {"Content-Type": "application/json"})[0] == 503
        m = c.json("/metrics")
        assert m["counter.zipkin_collector.messages_dropped.http"] == 1
        assert m["gauge.zipkin_tpu.mpRejected"] == 1
    finally:
        os.kill(pid, signal.SIGCONT)
        server.stop()
    assert store.agg.host_counters["spans"] == 100


def test_alloc_fault_answers_429_and_counts_the_message_dropped(served):
    """The ``alloc`` resource site at the collector boundary: an injected
    allocation failure is answered 429, not 500, and counted dropped."""
    from zipkin_tpu_torch import faults

    c = served()
    faults.arm_resource("alloc", nth=1, count=1)
    try:
        assert c.post("/api/v2/spans", TRACE_BODY)[0] == 429
    finally:
        faults.disarm()
    assert c.post("/api/v2/spans", TRACE_BODY)[0] == 202
    m = c.json("/metrics")
    assert m["counter.zipkin_collector.messages_dropped.http"] == 1
    assert m["counter.zipkin_collector.messages.http"] == 2


def test_stop_drains_then_closes_the_tier_before_the_final_snapshot(tmp_path):
    """stop() drains the tier, always closes it, and only then takes the
    final snapshot and closes the store: every 202'd span is in the
    snapshot's counters."""
    if not native.available():
        pytest.skip("no C compiler for the native parser")
    from zipkin_tpu_torch.storage.tpu import TorchStorage as Adapter

    store = Adapter(config=SMALL, device="cpu", batch_size=256,
                    checkpoint_dir=str(tmp_path / "ckpt"), wal_dir=str(tmp_path / "wal"))
    server = _mp_server(store, tpu_snapshot_interval_s=3600.0)
    ing = server._mp_ingester
    calls = []

    def spy(name, fn):
        def run(*a, **k):
            calls.append((name, store.agg.host_counters["spans"]))
            return fn(*a, **k)
        return run

    ing.drain = spy("drain", ing.drain)
    ing.close = spy("close", ing.close)
    store.snapshot = spy("snapshot", store.snapshot)
    store.close = spy("store.close", store.close)
    c = Client(server)
    for p in _mp_payloads(4):
        assert _post_until_accepted(c, p)[0] == 202
    server.stop()
    assert [n for n, _ in calls] == ["drain", "close", "snapshot", "store.close"]
    assert dict(calls)["snapshot"] == 2000
    assert ing._closed and store.mp_ingester is None
    revived = Adapter(config=SMALL, device="cpu", batch_size=256,
                      checkpoint_dir=str(tmp_path / "ckpt"))
    assert revived.agg.host_counters["spans"] == 2000
    revived.close()


def test_adapter_close_drains_and_closes_an_attached_tier(tmp_path):
    """A caller that only closes the storage: the resume adapter drains the
    attached tier before its WAL detaches, so the log holds every span."""
    if not native.available():
        pytest.skip("no C compiler for the native parser")
    from zipkin_tpu_torch.storage.tpu import TorchStorage as Adapter
    from zipkin_tpu_torch.tpu.mp_ingest import MultiProcessIngester

    store = Adapter(config=SMALL, device="cpu", batch_size=256, wal_dir=str(tmp_path / "wal"))
    ing = MultiProcessIngester(store, workers=1)
    store.mp_ingester = ing
    for p in _mp_payloads(3):
        ing.submit(p)
    store.close()
    assert ing._closed and store.mp_ingester is None
    revived = Adapter(config=SMALL, device="cpu", batch_size=256, wal_dir=str(tmp_path / "wal"))
    assert revived.agg.host_counters["spans"] == 1500
    revived.close()


def test_entry_point_with_mp_workers_answers_202_429_and_drains_on_sigterm(tmp_path):
    """``TPU_FAST_INGEST=1 TPU_MP_WORKERS=2 TPU_MP_QUEUE_DEPTH=1 python -m
    zipkin_tpu_torch.server --storage tpu`` (the store on the CPU here): a
    backing-off client's POSTs are all 202, a flood from 4 threads meets
    429, /metrics accounts for every 202'd span once the tier drains, and
    SIGTERM ends it with exit code 0."""
    if not native.available():
        pytest.skip("no C compiler for the native parser")
    import concurrent.futures
    import socket

    code = ("import sys\n"
            "from zipkin_tpu_torch.server import app\n"
            "build = app.build_storage\n"
            "app.build_storage = lambda config, device=None: build(config, device='cpu')\n"
            "from zipkin_tpu_torch.server.__main__ import main\n"
            "sys.exit(main(sys.argv[1:]))\n")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root, QUERY_HOST="127.0.0.1", TPU_FAST_INGEST="1",
               TPU_MP_WORKERS="2", TPU_MP_QUEUE_DEPTH="1", TPU_ARCHIVE_DIR="off",
               TPU_MAX_SERVICES="128", TPU_MAX_KEYS="512", TPU_HLL_PRECISION="10",
               TPU_DIGEST_CENTROIDS="32", TPU_RING_CAPACITY="16384")
    proc = subprocess.Popen([sys.executable, "-c", code, "--port", str(port), "--storage", "tpu"],
                            cwd=str(tmp_path), env=env, stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE)
    base = f"http://127.0.0.1:{port}"

    def post(body):
        req = urllib.request.Request(base + "/api/v2/spans", data=body, method="POST")
        try:
            with urllib.request.urlopen(req, timeout=60) as resp:
                return resp.status
        except urllib.error.HTTPError as e:
            return e.code

    try:
        deadline = time.monotonic() + 120
        while True:
            assert proc.poll() is None, proc.stderr.read().decode()
            try:
                with urllib.request.urlopen(base + "/health", timeout=5) as resp:
                    if json.loads(resp.read())["status"] == "UP":
                        break
            except OSError:
                pass
            assert time.monotonic() < deadline, "no /health"
            time.sleep(0.2)
        ps = _mp_payloads(16, per=200)
        accepted = refused = 0
        for p in ps[:4]:
            while (status := post(p)) == 429:
                refused += 1
                time.sleep(0.005)
            assert status == 202
            accepted += 1
        with concurrent.futures.ThreadPoolExecutor(4) as pool:
            flood = list(pool.map(post, ps[4:]))
        assert set(flood) <= {202, 429} and 429 in flood
        accepted += flood.count(202)
        deadline = time.monotonic() + 60
        while True:
            with urllib.request.urlopen(base + "/metrics", timeout=30) as resp:
                m = json.loads(resp.read())
            if m["gauge.zipkin_tpu.mpInflight"] == 0 and \
                    m["gauge.zipkin_tpu.mpAccepted"] == 200 * accepted:
                break
            assert time.monotonic() < deadline, m
            time.sleep(0.1)
        assert m["gauge.zipkin_tpu.mpWorkersAlive"] == 2
        refused += flood.count(429)
        # a 429 is a full tier or an admission shed (the ladder is on)
        assert m["gauge.zipkin_tpu.mpRejected"] + m["gauge.zipkin_tpu.overloadShedTotal"] \
            + m["gauge.zipkin_tpu.overloadShedTenant"] == refused
        assert m["counter.zipkin_collector.messages_dropped.http"] == refused
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)

"""The port's flood configs 8 and 9 (``zipkin_tpu_torch.evals.run_configs``)
against the reference's ``evals/run_configs.py`` and the JAX package, on
the CPU.

- Their payloads (``fixtures.flood_spans``) encode to the same bytes as the
  reference's ``spans_for``, rebuilt here from its lines on the JAX model.
- Both pass at the reference's settings, each line a superset of the
  reference's keys, and every fault is disarmed afterwards.
- Durable parity against the reference: config8's acked span set (the
  payloads answered 202), ingested into the JAX package's store at
  config8's ``AggConfig`` on one shard, gives the same integer planes
  (histograms and HLL registers by name, the global registers, the host
  span counters) as the port's cold-booted store, bit for bit.
- ``wire.flood`` (config9's waves) answers in order, each request on its
  own connection that answered a ``GET /health`` before any request of the
  flood reached the server.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

import tests.torch_cpu  # noqa: F401  (one intra-op thread a test process)
from tests.test_torch_evals_gates import emitted_keys
from zipkin_tpu.model import json_v2 as jjson
from zipkin_tpu.model.span import Endpoint as JEndpoint
from zipkin_tpu.model.span import Span as JSpan
from zipkin_tpu.parallel.mesh import make_mesh
from zipkin_tpu.tpu.state import AggConfig as JConfig
from zipkin_tpu.tpu.store import TpuStorage
from zipkin_tpu_torch import faults
from zipkin_tpu_torch.evals import fixtures, wire
from zipkin_tpu_torch.evals import run_configs as rc
from zipkin_tpu_torch.model import json_v2

PER = 40  # spans a payload: EVAL_FLOOD_PER's default


def ref_spans_for(i: int, n: int, base: int):
    """The reference's ``spans_for`` of configs 8 (base 0xE800_0000) and 9
    (0xE900_0000), on the JAX model."""
    ep = JEndpoint.create(service_name=f"svc{i % 8}", ip="10.0.0.1")
    return [
        JSpan.create(
            trace_id=f"{base + i:016x}", id=f"{(i << 16) + j + 1:016x}", name=f"op{j % 8}",
            timestamp=1_753_000_000_000_000 + i * 1000 + j, duration=500 + j, local_endpoint=ep)
        for j in range(n)
    ]


@pytest.mark.parametrize("base", [0xE800_0000, 0xE900_0000])
@pytest.mark.parametrize("i,n", [(0, 40), (17, 40), (0x9000, 4), (0x9105, 80)])
def test_flood_spans_match_the_reference(base, i, n):
    assert json_v2.encode_span_list(fixtures.flood_spans(i, n, base)) == \
        jjson.encode_span_list(ref_spans_for(i, n, base))


def named_planes(store) -> dict:
    """A store's integer planes keyed by name, not vocab id (the fan-out
    tier interns in arrival order): histograms by (service, span name),
    HLL registers by service, the global registers, the span count."""
    hist, hll_regs, _ = store.agg.merged_sketches()
    hist, hll_regs = np.asarray(hist), np.asarray(hll_regs)
    svc, names = store.vocab.services.lookup, store.vocab.span_names.lookup
    keys = {(svc(s), names(n)): kid for kid, (s, n) in enumerate(store.vocab._key_list) if kid}
    return dict(
        hist={k: hist[kid].tobytes() for k, kid in keys.items() if hist[kid].any()},
        hll={svc(i): hll_regs[i].tobytes() for i in range(1, len(store.vocab.services))},
        hll_global=hll_regs[store.config.global_hll_row].tobytes(),
        spans=int(store.agg.host_counters["spans"]),
    )


def test_config8_passes_and_its_cold_boot_equals_the_reference(monkeypatch, capsys):
    stores, posts = [], []
    real_store, real_flood = rc._flood_store, rc.wire.flood

    def kept(tmp, device):
        store = real_store(tmp, device)
        stores.append(store)
        return store

    def recorded(requests):
        got = real_flood(requests)
        posts.extend((body, ans.status) for (_, _, body, _), ans in zip(requests, got))
        return got

    monkeypatch.setattr(rc, "_flood_store", kept)
    monkeypatch.setattr(rc.wire, "flood", recorded)
    capsys.readouterr()
    assert rc.config8("cpu")
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert emitted_keys("config8") <= set(line), emitted_keys("config8") - set(line)
    assert line["offered_over_capacity"] >= 3.0 and line["acked"] > 0 and line["shed"] > 0
    assert line["sheds_with_guidance"] == line["shed"] and line["grpc_shed_guided"]
    assert not faults._resource_armed
    _live, revived = stores  # the cold boot is the second store on the dirs
    acked = [body for body, status in posts if status == 202]
    assert len(acked) == line["acked"] and len(posts) == line["offered"]

    ref = TpuStorage(config=JConfig(**rc.FLOOD_CFG), mesh=make_mesh(1), pad_to_multiple=512)
    try:
        for body in acked:
            ref.ingest_json_fast(body)
        ref.agg.block_until_ready()
        want = named_planes(ref)
    finally:
        ref.close()
    assert want["spans"] == PER * len(acked)
    assert named_planes(revived) == want


def test_config9_passes_at_the_reference_settings(capsys):
    capsys.readouterr()
    assert rc.config9("cpu")
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert emitted_keys("config9") <= set(line), emitted_keys("config9") - set(line)
    assert line["acked"]["A"] == line["acked"]["C"] == 6 and line["a_c_sheds"] == 0
    assert line["sheds_tenant_scoped_to_b"] == line["shed"] >= 1
    assert line["global_stays_b0"] and line["tenant_levels"]["B"] >= 2
    assert line["durable_parity_mid_flood"] and line["durable_parity"]
    assert line["calm_ticks_to_level0"] <= line["long_window_ticks"]
    assert not faults._resource_armed


class _Logged(BaseHTTPRequestHandler):
    """Logs (connection, method, path, body) in arrival order; a POST is
    answered 202 with its body's length in a header, a GET 200 with its
    path as the body."""

    protocol_version = "HTTP/1.1"
    log: list = []
    lock = threading.Lock()

    def log_message(self, *args):
        pass

    def _log(self, body: bytes) -> None:
        with self.lock:
            self.log.append((id(self), self.command, self.path, body))

    def do_GET(self):
        self._log(b"")
        self.send_response(200)
        self.send_header("Content-Length", str(len(self.path)))
        self.end_headers()
        self.wfile.write(self.path.encode())

    def do_POST(self):
        body = self.rfile.read(int(self.headers["Content-Length"]))
        self._log(body)
        self.send_response(202)
        self.send_header("X-Got", str(len(body)))
        self.send_header("Content-Length", "0")
        self.end_headers()


def test_flood_sends_every_request_on_a_warmed_connection_and_answers_in_order():
    srv = ThreadingHTTPServer(("127.0.0.1", 0), _Logged)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    _Logged.log = []
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        reqs = [("POST", base + "/api/v2/spans", b"x" * k, {"X-Tenant-Id": "B"}) for k in range(1, 9)]
        reqs += [("GET", base + "/api/v2/services?q=1", None, None)] * 3
        got = wire.flood(reqs)
    finally:
        srv.shutdown()
        srv.server_close()
    assert [a.status for a in got] == [202] * 8 + [200] * 3
    assert [a.headers["X-Got"] for a in got[:8]] == [str(k) for k in range(1, 9)]
    assert all(a.body == b"/api/v2/services?q=1" for a in got[8:])
    assert all(a.ms > 0 for a in got)
    by_conn = {}
    for conn, method, path, body in _Logged.log:
        by_conn.setdefault(conn, []).append((method, path, body))
    assert len(by_conn) == len(reqs)
    assert all(seen[0] == ("GET", "/health", b"") and len(seen) == 2 for seen in by_conn.values())
    assert sorted((m, p, b) for seen in by_conn.values() for m, p, b in seen[1:]) == \
        sorted((m, r.split(base)[1], b or b"") for m, r, b, _ in reqs)
    # every warm-up reached the server before the flood's first request
    first = next(i for i, e in enumerate(_Logged.log) if e[2] != "/health")
    assert all(e[2] == "/health" for e in _Logged.log[:first]) and first == len(reqs)

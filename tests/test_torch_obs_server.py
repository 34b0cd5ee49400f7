"""The observability plane through the port's server: statusz, /prometheus
and /metrics of an in-process port server on the CPU carry the reference
server's sections, keys and metric names for every ported plane (the same
POSTs and reads against the JAX package's aiohttp server over a one-shard
``TpuStorage``); self-tracing keeps the reference's B3 rules
(tests/test_self_tracing.py's specs); over-budget stages become
``zipkin-tpu-pipeline`` spans under the posted trace; the time tier's seal
rides the windows ticker; and the multi-process tier shows its relayed and
``mp_*`` stages, its workers and its shadow tap."""

from __future__ import annotations

import json
import threading
import time

import pytest

from tests.test_torch_server import (TRACE_BODY, Client, _mp_payloads,
                                     _mp_server, _post_until_accepted, _ref_exchange, serve)
from tests.test_torch_store import ref_store, small_store
import tests.torch_cpu  # noqa: F401  (one intra-op thread a test process)
from zipkin_tpu_torch import native, obs
from zipkin_tpu_torch.server.app import ZipkinServer
from zipkin_tpu_torch.server.config import ServerConfig
from zipkin_tpu_torch.storage.memory import InMemoryStorage

READS = [
    ("POST", "/api/v2/spans", TRACE_BODY, {"Content-Type": "application/json"}, None),
    ("GET", "/api/v2/tpu/percentiles", None, None, None),
    ("GET", "/api/v2/tpu/cardinalities", None, None, None),
]
PAGES = [("GET", "/api/v2/tpu/statusz", None, None, None), ("GET", "/prometheus", None, None, None),
         ("GET", "/metrics", None, None, None)]


def _families(text: bytes) -> set:
    return {line.split()[2] for line in text.decode().splitlines() if line.startswith("# TYPE")}


@pytest.fixture(scope="module")
def pages(tmp_path_factory):
    cfg = dict(storage_type="tpu", tpu_fast_ingest=True,
               obs_incident_dir=str(tmp_path_factory.mktemp("incidents")))
    want = _ref_exchange(ref_store(), cfg, READS + PAGES)[len(READS):]
    server = serve(small_store(), **cfg)
    try:
        client = Client(server)
        for method, path, data, headers, params in READS:
            assert client.request(method, path, data, headers, params)[0] in (200, 202)
        deadline = time.monotonic() + 30
        while (time.monotonic() < deadline
               and (server._accuracy.rollups < 1 or server._obs_windows.ticks < 1
                    or server._mirror.publishes < 1)):
            time.sleep(0.05)
        got = [client.request(*r[:2]) for r in PAGES]
    finally:
        server.stop()
    assert [s for s, _ in got] == [s for s, _ in want] == [200, 200, 200]
    return [b for _, b in got], [b for _, b in want]


def test_statusz_has_the_reference_sections_and_keys(pages):
    got, want = (json.loads(p[0]) for p in pages)
    assert set(got) == set(want)
    assert {"stages", "slow", "recorder", "windows", "slo", "accuracy", "device", "queries",
            "mirror", "overload", "incidents"} <= set(got)
    for section in set(got) - {"slow"}:
        # the device block carries the port's step timeline beside the
        # reference's keys
        extra = {"timeline"} if section == "device" else set()
        assert set(got[section]) == set(want[section]) | extra, section
    assert set(got["stages"]) == set(want["stages"])  # the 29 stages
    assert [s["name"] for s in got["slo"]["specs"]] == [s["name"] for s in want["slo"]["specs"]]
    assert all(set(a) == set(b) for a, b in zip(got["slo"]["specs"], want["slo"]["specs"]))
    assert set(got["windows"]["lookbacks"]) == set(want["windows"]["lookbacks"])
    assert set(got["device"]["totals"]) == set(want["device"]["totals"])
    assert {"spmd_init", "spmd_step", "spmd_card", "spmd_quant_digest"} <= set(got["device"]["programs"])
    assert got["device"]["hbm"] == {}  # the store runs on the CPU
    assert set(got["accuracy"]["gauges"]) == set(want["accuracy"]["gauges"])
    # the admission plane: the ladder at B0 after a calm exchange, with the
    # reference's counters and an accounting-only tenant table
    assert got["overload"]["levelName"] == want["overload"]["levelName"] == "B0"
    assert got["overload"]["readMode"] == "normal"
    assert set(got["overload"]["counters"]) == set(want["overload"]["counters"])
    assert set(got["overload"]["tenants"]) == set(want["overload"]["tenants"])
    assert set(got["overload"]["signals"]) <= set(want["overload"]["signals"]) | {"hbm"}


def test_prometheus_and_metrics_carry_the_reference_names(pages):
    (_, got_prom, got_metrics), (_, want_prom, want_metrics) = pages
    got, want = _families(got_prom), _families(want_prom)
    assert got <= want
    assert got == want
    for fam in ("zipkin_tpu_stage_latency_seconds", "zipkin_tpu_slo_alert", "zipkin_tpu_slo_burn_rate",
                "zipkin_tpu_device_program_calls", "zipkin_tpu_host_transfer_bytes",
                "zipkin_tpu_query_lock_wait_seconds", "zipkin_tpu_query_segment_count_total",
                "zipkin_tpu_accuracy_hll_rel_err", "zipkin_collector_spans_total",
                "zipkin_tpu_overload_level", "zipkin_tpu_overload_shed_total",
                "zipkin_tpu_overload_deadline_expired_total", "zipkin_tpu_read_cache_stale_serves",
                "zipkin_tpu_tenant_table_size", "zipkin_tpu_tenant_offered_total"):
        assert fam in got, fam
    gm, wm = set(json.loads(got_metrics)), set(json.loads(want_metrics))
    # the per-stage quantile gauges exist for the stages that ran, which
    # differ with the timing of the ticks
    not_stage = lambda names: {n for n in names if ".stage." not in n}
    assert not_stage(gm) <= not_stage(wm)
    assert not_stage(gm) == not_stage(wm)
    for name in ("overloadLevel", "overloadShedTotal", "overloadShedTenant", "deadlineExpired",
                 "tenantOffered_default"):
        assert f"gauge.zipkin_tpu.{name}" in gm, name
    assert any(n.startswith("gauge.zipkin_tpu.slo.") for n in gm)


def _self_spans(storage, tries=100):
    for _ in range(tries):
        spans = [s for t in storage.get_all_traces() for s in t
                 if s.local_service_name == "zipkin-server"]
        if spans:
            return spans
        time.sleep(0.05)
    return []


@pytest.mark.parametrize("sampled,rate,traced", [
    (None, 1.0, True),    # a query request is traced
    ("0", 1.0, False),    # the caller's no-sample decision wins
    ("1", 0.0, True),     # forced past a local rate of 0
    ("garbage", 0.0, False),  # garbage falls back to the local rate
])
def test_self_tracing_keeps_the_reference_b3_rules(sampled, rate, traced):
    storage = InMemoryStorage()
    server = serve(storage, self_tracing_enabled=True, self_tracing_sample_rate=rate)
    try:
        headers = {"X-B3-TraceId": "463ac35c9f6413ad", "X-B3-SpanId": "a2fb4a1d1a96d312"}
        if sampled is not None:
            headers["X-B3-Sampled"] = sampled
        assert Client(server).request("GET", "/api/v2/services", headers=headers)[0] == 200
        if not traced:
            time.sleep(0.2)
        spans = _self_spans(storage, tries=100 if traced else 2)
    finally:
        server.stop()
    assert bool(spans) == traced
    if traced:
        (span,) = spans
        assert span.kind.value == "SERVER" and span.name == "get /api/v2/services"
        assert span.trace_id == "463ac35c9f6413ad" and span.parent_id == "a2fb4a1d1a96d312"
        assert span.tags["http.path"] == "/api/v2/services"
        assert span.tags["http.status_code"] == "200"


def test_over_budget_stages_become_pipeline_spans_under_the_posted_trace():
    store = small_store()
    server = serve(store, storage_type="tpu", self_tracing_enabled=True,
                   obs_selfspans_enabled=True, obs_budget_scale=1e-9)
    try:
        c = Client(server)
        headers = {"Content-Type": "application/json", "X-B3-TraceId": "00000000000000aa",
                   "X-B3-SpanId": "00000000000000bb"}
        assert c.post("/api/v2/spans", TRACE_BODY, headers)[0] == 202
        deadline = time.monotonic() + 30
        names = set()
        while time.monotonic() < deadline and not {"zipkin-server", "zipkin-tpu-pipeline"} <= names:
            status, body = c.get("/api/v2/trace/00000000000000aa")
            names = {s["localEndpoint"]["serviceName"] for s in json.loads(body)} if status == 200 else set()
            time.sleep(0.05)
        assert {"zipkin-server", "zipkin-tpu-pipeline"} <= names
        st = c.json("/api/v2/tpu/statusz")
        assert st["recorder"]["selfSpans"] and st["recorder"]["selfSpansEmitted"] > 0
        assert any(ev.get("traceId") == "00000000000000aa" for ev in st["slow"])
        assert st["stages"]["http_boundary"]["count"] >= 1
    finally:
        server.stop()
    assert obs.RECORDER.budget_scale == 1.0  # stop() disarmed the recorder


def test_the_seal_rides_the_windows_ticker():
    store = small_store()
    server = ZipkinServer(ServerConfig(host="127.0.0.1", port=0, storage_type="tpu",
                                       obs_windows_tick_s=0.05),
                          storage=store, seal_interval_s=1.0).start()
    try:
        assert Client(server).post("/api/v2/spans", TRACE_BODY)[0] == 202
        deadline = time.monotonic() + 30
        while store.ingest_counters()["ttSeals"] == 0 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert store.ingest_counters()["ttSeals"] > 0
        names = {t.name for t in threading.enumerate()}
        assert "obs-windows-ticker" in names and "zipkin-tt-seal" not in names
    finally:
        server.stop()
    assert not server._obs_windows.ticker_running


def test_the_ticker_seals_at_the_asked_period():
    """``seal_interval_s`` is the seal's period with the windows on too: on
    a 0.05 s ticker a 0.5 s period seals about once every ten ticks, not
    on every tick."""
    store = small_store()
    calls = []
    seal = store.tt_seal
    store.tt_seal = lambda *a, **kw: calls.append(time.monotonic()) or seal(*a, **kw)
    server = ZipkinServer(ServerConfig(host="127.0.0.1", port=0, storage_type="tpu",
                                       obs_windows_tick_s=0.05),
                          storage=store, seal_interval_s=0.5)
    t0 = time.monotonic()
    server.start()
    try:
        time.sleep(1.3)
    finally:
        server.stop()
    elapsed = time.monotonic() - t0
    ticks = server._obs_windows.ticks
    assert calls and ticks >= 2 * len(calls), (ticks, len(calls))
    assert len(calls) <= elapsed / 0.5 + 1
    assert all(b - a >= 0.5 for a, b in zip(calls, calls[1:]))


def test_multi_process_tier_under_the_plane():
    if not native.available():
        pytest.skip("no C compiler for the native parser")
    before = obs.RECORDER.snapshot()
    store = small_store()
    server = _mp_server(store)
    try:
        c = Client(server)
        for p in _mp_payloads(4):
            ctype = "application/x-protobuf" if p[:1] == b"\n" else "application/json"
            assert _post_until_accepted(c, p, {"Content-Type": ctype})[0] == 202
        server._mp_ingester.drain()
        st = c.json("/api/v2/tpu/statusz")
        shadow = server._obs_shadow.counters()
    finally:
        server.stop()
    after = obs.RECORDER.snapshot()
    ran = {s: after.stage(s).count - before.stage(s).count
           for s in ("parse", "pack", "route", "mp_vocab_replay", "mp_device_feed", "mp_record",
                     "mp_lut_remap", "coalesce", "device_dispatch")}
    # a group of one chunk remaps in place, a larger one is coalesced
    assert ran["mp_lut_remap"] + ran["coalesce"] == ran["mp_device_feed"] > 0, ran
    assert all(ran[s] > 0 for s in ("parse", "pack", "route", "mp_vocab_replay",
                                     "device_dispatch")), ran
    assert ran["mp_record"] == 4  # one a payload
    assert [w["widx"] for w in st["workers"]] == [0, 1]
    assert sum(w["spans"] for w in st["workers"]) == 2000
    assert shadow["shadowOfferedBatches"] > 0

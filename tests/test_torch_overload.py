"""The port's overload plane (``zipkin_tpu_torch.runtime.overload``) against
the JAX package's (``zipkin_tpu.runtime.overload``), on the CPU.

The reference's cases (tests/test_overload.py) run against the port, less
the gRPC trailer case (the port has no gRPC server yet):

- the ladder: an immediate jump up, the exit margin's hold, one level per
  dwell down, the transition history and callbacks, EMA smoothing, the
  status shape;
- value-class admission: B0 admits all, the byte probe, B3's error-only
  admission, B2's fractional credit, the sampling pressure hook, the
  jittered retry delay, the deadline counter;
- the store's brownout reads: cache first within the bound, cache only for
  any hit while a cold key still computes;
- the HTTP boundary of the port's ``http.server``: ``X-Request-Timeout-Ms``
  (504, or no deadline when malformed), B3's 429 with ``Retry-After`` and
  ``X-Shed-Scope: global`` beside a 202 for the error class, statusz and
  ``/prometheus``; a sustained flood through the fan-out tier with a slow
  feed and a full disk sheds with guidance, loses no acked span and the
  ladder steps back to B0;
- ENOSPC at the WAL, the snapshot and the archive, and an allocation
  failure at the collector, each held to the reference's store.

Parity: the same seeded ticks (an injected clock and ``seed=``) and the
same admission calls go through both packages' controllers: levels,
transitions, status, counters, verdicts and retry delays are equal. The
same seeded payload stream goes through both packages' collectors with
each controller held at B2 and then B3: the admitted and shed sequences are
equal, and so are the two stores (``assert_store_parity``).

Tolerances: none for the controller (integer and deterministic float
code); the stores' as ``tests/test_torch_wal.py`` states them.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import time
import types

import numpy as np
import pytest

import tests.torch_cpu  # noqa: F401  (one intra-op thread a test process)
from tests.fixtures import TODAY_US, lots_of_spans
from tests.test_torch_server import Client, serve
from tests.test_torch_store import to_port
from tests.test_torch_wal import assert_store_parity, batches, end_of, port_adapter, ref_adapter
from zipkin_tpu import faults as ref_faults
from zipkin_tpu.collector.core import Collector as RefCollector
from zipkin_tpu.model import json_v2 as ref_json
from zipkin_tpu.model.span import Endpoint, Span
from zipkin_tpu.runtime.overload import OverloadController as RefController
from zipkin_tpu.runtime.tenant import TenantAdmission as RefTenantAdmission
from zipkin_tpu.tpu.mp_ingest import IngestBackpressure as RefBackpressure
from zipkin_tpu_torch import faults, native
from zipkin_tpu_torch.collector.core import Collector
from zipkin_tpu_torch.obs.recorder import StageRecorder
from zipkin_tpu_torch.obs.slo import SloWatchdog, default_specs
from zipkin_tpu_torch.obs.windows import WindowedTelemetry
from zipkin_tpu_torch.runtime.overload import (B0, B1, B2, B3, CLASS_BULK, CLASS_ERROR,
                                               OverloadController)
from zipkin_tpu_torch.runtime.tenant import TenantAdmission
from zipkin_tpu_torch.storage.memory import InMemoryStorage
from zipkin_tpu_torch.tpu.mp_ingest import IngestBackpressure
from zipkin_tpu_torch.tpu.state import AggState

# queue_saturation's design limit is 0.9: a gauge of 0.9 is pressure 1.0,
# past every enter threshold
SATURATED = {"critpathQueueSaturation": 0.9}
CALM = {"critpathQueueSaturation": 0.0}


@pytest.fixture(autouse=True)
def _disarm():
    yield
    faults.disarm()
    ref_faults.disarm()


class Clock:
    def __init__(self, t: float = 1000.0) -> None:
        self.t = t

    def __call__(self) -> float:
        return self.t


def ctl_with(**kw):
    kw.setdefault("seed", 7)
    kw.setdefault("hbm_stats", lambda: {})  # no card gauge
    return OverloadController(**kw)


def ref_ctl_with(**kw):
    kw.setdefault("seed", 7)
    kw.setdefault("hbm_stats", lambda: {})
    return RefController(**kw)


def drive_to(ctl, level):
    for _ in range(12):
        if ctl.evaluate(SATURATED) >= level:
            return
    raise AssertionError(f"never reached B{level}: load={ctl.load_index}")


def bulk_payload(i, per=40):
    """Bulk class: a unique trace a payload, no b"error" in its bytes."""
    tid = f"{0xB000_0000 + i:016x}"
    ep = Endpoint.create(service_name=f"svc{i % 8:02d}", ip="10.0.0.9")
    spans = [Span.create(trace_id=tid, id=f"{(i << 16) + j + 1:016x}", name=f"op{j % 6:02d}",
                         timestamp=TODAY_US + i * 1000 + j, duration=1000 + j, local_endpoint=ep)
             for j in range(per)]
    body = ref_json.encode_span_list(spans)
    assert b"error" not in body
    return body


def error_payload(i, per=4):
    """Essential class: carries the literal "error" tag."""
    tid = f"{0xE000_0000 + i:016x}"
    ep = Endpoint.create(service_name="svc-err", ip="10.0.0.8")
    spans = [Span.create(trace_id=tid, id=f"{(i << 16) + j + 1:016x}", name="boom",
                         timestamp=TODAY_US + j, duration=500, local_endpoint=ep,
                         tags={"error": "true"})
             for j in range(per)]
    return ref_json.encode_span_list(spans)


def _no_wall(status: dict) -> dict:
    """A status without the history's wall-clock instants."""
    out = dict(status)
    out["history"] = [{k: v for k, v in ev.items() if k != "at"} for ev in status["history"]]
    return out


# -- the ladder -----------------------------------------------------------------


class TestLadder:
    def test_step_up_is_immediate_and_jumps(self):
        ctl = ctl_with(ema_alpha=1.0)  # load == raw
        assert ctl.level == B0
        assert ctl.evaluate(SATURATED) == B3  # B0 -> B3 in one tick
        assert ctl.transitions == 1
        assert ctl.level_name == "B3"

    def test_exit_margin_holds_level_below_enter_threshold(self):
        ctl = ctl_with(ema_alpha=1.0, dwell_ticks=3)
        drive_to(ctl, B3)
        hold = {"critpathQueueSaturation": 0.90 * 0.9}  # under B3's enter, over its exit
        for _ in range(10):
            assert ctl.evaluate(hold) == B3

    def test_step_down_is_one_level_per_dwell_window(self):
        ctl = ctl_with(ema_alpha=1.0, dwell_ticks=3)
        drive_to(ctl, B3)
        levels = [ctl.evaluate(CALM) for _ in range(9)]
        assert levels == [B3, B3, B2, B2, B2, B1, B1, B1, B0]

    def test_transition_history_and_callbacks(self):
        seen = []
        ctl = ctl_with(ema_alpha=1.0, dwell_ticks=1)
        ctl.on_transition.append(seen.append)
        ctl.evaluate(SATURATED)
        for _ in range(10):
            ctl.evaluate(CALM)
        assert ctl.level == B0
        assert [e["to"] for e in seen] == ["B3", "B2", "B1", "B0"]
        assert seen[0]["topSignal"] == "queue_saturation"
        assert list(ctl.history) == seen
        assert ctl.counters()["overloadTransitions"] == 4

    def test_ema_smooths_single_tick_noise(self):
        ctl = ctl_with(ema_alpha=0.3)
        ctl.evaluate(SATURATED)
        assert ctl.level == B0
        for _ in range(5):
            ctl.evaluate(CALM)
        assert ctl.level == B0

    def test_status_shape(self):
        ctl, ref = ctl_with(ema_alpha=1.0), ref_ctl_with(ema_alpha=1.0)
        for c in (ctl, ref):
            c.evaluate(SATURATED)
        st = ctl.status()
        assert st["levelName"] == "B3" and st["readMode"] == "cache_only"
        assert st["topSignal"] == "queue_saturation"
        assert st["counters"]["transitions"] == 1
        assert st["enterThresholds"] == [0.70, 0.85, 0.95]
        assert st["history"][0]["from"] == "B0"
        assert set(st) == set(ref.status())


# -- admission --------------------------------------------------------------------


class TestAdmission:
    def test_b0_admits_everything(self):
        ctl = ctl_with()
        for i in range(5):
            assert ctl.admit_ingest(bulk_payload(i, per=2))[0]
        assert ctl.counters()["overloadAdmitted"] == 5
        assert ctl.counters()["overloadShedTotal"] == 0

    def test_classify_probes_unparsed_bytes(self):
        assert OverloadController.classify(error_payload(0)) == CLASS_ERROR
        assert OverloadController.classify(bulk_payload(0, per=2)) == CLASS_BULK

    def test_b3_admits_error_class_only(self):
        ctl = ctl_with(ema_alpha=1.0)
        drive_to(ctl, B3)
        assert ctl.admit_ingest(error_payload(1)) == (True, CLASS_ERROR)
        assert ctl.admit_ingest(bulk_payload(1, per=2)) == (False, CLASS_BULK)
        c = ctl.counters()
        assert c["overloadAdmittedEssential"] == 1 and c["overloadShedBulk"] == 1

    def test_b2_fractional_credit_tracks_admit_rate_exactly(self):
        ctl = ctl_with(ema_alpha=1.0)
        mid = (0.85 + 0.95) / 2.0  # bulk admit p = 0.5
        ctl.evaluate({"critpathQueueSaturation": mid * 0.9})
        assert ctl.level == B2
        assert abs(ctl.status()["bulkAdmitP"] - 0.5) < 1e-6
        verdicts = [ctl.admit_ingest(bulk_payload(i, per=2))[0] for i in range(10)]
        assert sum(verdicts) == 5
        assert ctl.admit_ingest(error_payload(2))[0]

    def test_bulk_shed_nudges_sampling_pressure_hook(self):
        rc = types.SimpleNamespace(calls=0)
        rc.note_pressure = lambda: setattr(rc, "calls", rc.calls + 1)
        ctl = ctl_with(ema_alpha=1.0, rate_controller=rc)
        drive_to(ctl, B3)
        for i in range(3):
            ctl.admit_ingest(bulk_payload(i, per=2))
        assert rc.calls == 3

    def test_retry_after_grows_with_pressure_and_stays_bounded(self):
        calm, hot = ctl_with(seed=3), ctl_with(seed=3, ema_alpha=1.0)
        drive_to(hot, B3)
        calm_mean = sum(calm.retry_after_s() for _ in range(50)) / 50
        hot_mean = sum(hot.retry_after_s() for _ in range(50)) / 50
        assert hot_mean > calm_mean * 3
        for _ in range(50):
            assert 0.05 <= hot.retry_after_s() <= 30.0
        assert len({round(hot.retry_after_s(), 6) for _ in range(20)}) > 1

    def test_deadline_counter(self):
        ctl = ctl_with()
        ctl.note_deadline_expired()
        ctl.note_deadline_expired(2)
        assert ctl.counters()["deadlineExpired"] == 3


# -- parity with the reference ------------------------------------------------------


def test_a_seeded_tick_stream_matches_the_reference_exactly():
    """400 seeded ticks of every signal (the card's memory included), with
    admission calls for three tenants and both classes between them, through
    both packages' controllers and tenant tables on one injected clock:
    equal levels after every tick, verdicts and retry delays, and equal
    history, status and counters at the end."""
    rng = np.random.default_rng(11)
    clock = Clock()
    hbm = {"bytesInUse": 0, "bytesLimit": 100}
    kw = dict(seed=5, clock=clock, hbm_stats=lambda: dict(hbm), dwell_ticks=3)
    port, ref = OverloadController(**kw), RefController(**kw)
    port.tenant_admission = TenantAdmission(bytes_per_s=400.0, burst_s=1.0, clock=clock)
    ref.tenant_admission = RefTenantAdmission(bytes_per_s=400.0, burst_s=1.0, clock=clock)
    levels = set()
    for tick in range(400):
        # a load that wanders through every level and back
        base = 0.6 + 0.5 * np.sin(tick / 25.0) + rng.normal(0, 0.08)
        counters = {
            "critpathQueueSaturation": float(max(0.0, base) * 0.9 * rng.uniform(0.7, 1.0)),
            "critpathWorkerOccupancy": float(rng.uniform(0, 0.9)),
            "queryLockWaiters": float(rng.integers(0, 4)),
            "snapshotAgeS": float(rng.uniform(0, 1500)),
        }
        p99 = {"wire_to_ack": float(rng.uniform(0, 2e5)), "wal_fsync": float(rng.uniform(0, 8e4)),
               "query_wall": float(max(0.0, base) * 5e4 * rng.uniform(0.5, 1.0))}
        hbm["bytesInUse"] = int(rng.integers(0, 85))
        clock.t += 1.0
        lp, lr = port.evaluate(counters, p99), ref.evaluate(counters, p99)
        assert lp == lr, tick
        levels.add(lp)
        for _ in range(int(rng.integers(0, 6))):
            tenant = ("a", "b", None)[int(rng.integers(0, 3))]
            data = b"x" * int(rng.integers(10, 300)) + (b"error" if rng.random() < 0.2 else b"")
            clock.t += float(rng.uniform(0, 0.05))
            vp, vr = port.admit(data, tenant=tenant), ref.admit(data, tenant=tenant)
            assert tuple(vp) == tuple(vr), tick
        assert port.retry_after_s() == ref.retry_after_s()
        assert port.retry_after_s("a") == ref.retry_after_s("a")
        assert port.read_mode() == ref.read_mode()
    assert levels == {B0, B1, B2, B3}
    assert port.transitions == ref.transitions > 8
    assert _no_wall(port.status()) == _no_wall(ref.status())
    assert port.counters() == ref.counters()


# -- brownout read modes over the store's read cache -----------------------------------


class _FakeCtl:
    def __init__(self, mode="normal", max_stale_ms=60_000):
        self.mode = mode
        self.max_stale_ms = max_stale_ms

    def read_mode(self):
        return self.mode


class TestBrownoutReads:
    def test_cache_first_serves_version_stale_within_bound(self, tmp_path):
        store = port_adapter(tmp_path, wal_dir=False, checkpoint=False)
        calls = []
        compute = lambda: calls.append(1) or len(calls)  # noqa: E731
        assert store._cached_read("k", compute) == 1
        assert store._cached_read("k", compute) == 1  # a plain hit
        store.agg.write_version += 1
        assert store._cached_read("k", compute) == 2  # normal: the version drops it
        store.overload = _FakeCtl("cache_first")
        store.agg.write_version += 1
        assert store._cached_read("k", compute) == 2  # stale within the bound serves
        assert store.ingest_counters()["readCacheStaleServes"] == 1
        store.overload.max_stale_ms = 0
        time.sleep(0.002)
        assert store._cached_read("k", compute) == 3  # past the bound: a device read
        store.close()

    def test_cache_only_serves_any_hit_but_computes_cold_keys(self, tmp_path):
        store = port_adapter(tmp_path, wal_dir=False, checkpoint=False)
        calls = []
        compute = lambda: calls.append(1) or len(calls)  # noqa: E731
        store._cached_read("k", compute)
        store.overload = _FakeCtl("cache_only", max_stale_ms=0)
        store.agg.write_version += 5
        time.sleep(0.002)
        assert store._cached_read("k", compute) == 1  # any age
        assert store._cached_read("k2", compute) == 2  # a cold key still computes
        store.overload = _FakeCtl("normal")
        assert store._cached_read("k", compute) == 3  # the first normal read purges
        store.close()


# -- deadlines and backoff guidance at the port's HTTP boundary ------------------------


def _raw(server, method, path, data=None, headers=None):
    """(status, headers, body) of one request."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{server.port}{path}", data=data,
                                 headers=headers or {}, method=method)
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


JSON_CT = {"Content-Type": "application/json"}


class TestDeadlinePropagation:
    def test_expired_budget_dropped_before_dispatch(self):
        server = serve(InMemoryStorage())
        try:
            status, headers, _ = _raw(server, "POST", "/api/v2/spans", bulk_payload(0, per=2),
                                      {**JSON_CT, "X-Request-Timeout-Ms": "0"})
            assert status == 504 and headers["X-Deadline-Expired"] == "1"
            assert _raw(server, "GET", "/api/v2/traces", headers={"X-Request-Timeout-Ms": "0"})[0] == 504
            assert _raw(server, "POST", "/api/v2/spans", bulk_payload(1, per=2),
                        {**JSON_CT, "X-Request-Timeout-Ms": "60000"})[0] == 202
            assert Client(server).json("/metrics")["gauge.zipkin_tpu.deadlineExpired"] >= 2
        finally:
            server.stop()

    def test_malformed_and_absent_headers_mean_no_deadline(self):
        server = serve(InMemoryStorage())
        try:
            assert _raw(server, "POST", "/api/v2/spans", bulk_payload(2, per=2),
                        {**JSON_CT, "X-Request-Timeout-Ms": "bogus"})[0] == 202
            assert _raw(server, "GET", "/api/v2/traces")[0] == 200
        finally:
            server.stop()


class TestBoundaryGuidance:
    def test_b3_sheds_bulk_with_retry_after_admits_errors(self):
        server = serve(InMemoryStorage())
        try:
            ctl = server._overload
            assert ctl is not None  # on by default, as in the reference
            for _ in range(6):
                ctl.evaluate(SATURATED)
            assert ctl.level == B3
            status, headers, body = _raw(server, "POST", "/api/v2/spans", bulk_payload(3, per=2),
                                         JSON_CT)
            assert status == 429 and b"B3" in body
            assert int(headers["Retry-After"]) >= 1 and int(headers["X-Retry-After-Ms"]) >= 50
            assert headers["X-Shed-Scope"] == "global"
            assert _raw(server, "POST", "/api/v2/spans", error_payload(3), JSON_CT)[0] == 202
            prom = Client(server).get("/prometheus")[1].decode()
            assert "zipkin_tpu_overload_level 3" in prom
            assert "zipkin_tpu_overload_shed_bulk_total 1" in prom
            st = Client(server).json("/api/v2/tpu/statusz")["overload"]
            assert st["levelName"] == "B3" and st["readMode"] == "cache_only"
        finally:
            server.stop()


# -- a sustained flood through the fan-out tier ------------------------------------------


def _assert_same_state(a, b) -> None:
    """Two port stores answer alike: host counters, the integer sketch
    planes, the dependency matrices and the cardinalities (a restore
    rolls up early, so the ring's link context may differ benignly)."""
    assert a.agg.host_counters == b.agg.host_counters
    la = dict(zip(AggState._fields, a.agg.state_arrays()))
    lb = dict(zip(AggState._fields, b.agg.state_arrays()))
    for name in ("hll", "hist", "hist_t", "tb_hll", "tb_calls", "tb_errs"):
        np.testing.assert_array_equal(la[name], lb[name], err_msg=name)
    for x, y in zip(a.agg.dependency_matrices(0, 1 << 31), b.agg.dependency_matrices(0, 1 << 31)):
        np.testing.assert_array_equal(x, y)
    assert a.trace_cardinalities(staleness_ms=0) == b.trace_cardinalities(staleness_ms=0)


class TestSustainedFlood:
    def test_flood_sheds_with_guidance_zero_acked_loss_b0_recovery(self, tmp_path):
        """Three times the tier's queue capacity through the HTTP boundary
        while the device feed is slow and the WAL hits ENOSPC: every shed
        carries guidance, every 202 survives to a cold boot, the disk-full
        window is flagged and clears, and the ladder returns to B0."""
        if not native.available():
            pytest.skip("no C compiler for the native parser")
        workers, depth, per, n_flood = 1, 2, 40, 18
        assert n_flood >= 3 * workers * depth
        storage = port_adapter(tmp_path)
        server = serve(storage, storage_type="tpu", tpu_fast_ingest=True, tpu_mp_workers=workers,
                       tpu_mp_queue_depth=depth)
        try:
            faults.arm_resource("feed.latency", nth=1, count=6, latency_ms=120)
            faults.arm_resource("wal.append", nth=1, count=1)
            with concurrent.futures.ThreadPoolExecutor(n_flood) as pool:
                results = list(pool.map(
                    lambda i: _raw(server, "POST", "/api/v2/spans", bulk_payload(i, per=per),
                                   JSON_CT)[:2], range(n_flood)))
            acked = [r for r in results if r[0] == 202]
            shed = [r for r in results if r[0] == 429]
            assert len(acked) + len(shed) == n_flood
            assert acked and shed
            for _, headers in shed:
                assert int(headers["Retry-After"]) >= 1 and int(headers["X-Retry-After-Ms"]) > 0
                assert headers["X-Shed-Scope"] in ("global", "tenant")
            server._mp_ingester.drain()
            acked_spans = per * len(acked)
            c = storage.ingest_counters()
            assert (c["walEnospc"], c["walMissedRecords"], c["durabilityAtRisk"]) == (1, 1, 1)
            assert storage.agg.host_counters["spans"] == acked_spans
            assert storage.snapshot() is not None  # re-covers the missed record
            assert storage.ingest_counters()["durabilityAtRisk"] == 0
            revived = port_adapter(tmp_path)
            assert revived.agg.host_counters["spans"] == acked_spans
            _assert_same_state(storage, revived)
            revived.close()
            ctl = server._overload
            for _ in range(6):
                ctl.evaluate(SATURATED)
            assert ctl.level == B3
            ticks_to_b0 = next((t for t in range(1, 41) if ctl.evaluate(CALM) == B0), None)
            assert ticks_to_b0 is not None and ticks_to_b0 <= 40
            assert ctl.status()["history"]
            m = Client(server).json("/metrics")
            assert m["gauge.zipkin_tpu.overloadTransitions"] >= 2
            assert m["gauge.zipkin_tpu.overloadLevel"] == 0
        finally:
            server.stop()


# -- ENOSPC and allocation failures, held to the reference's store --------------------------


def _arm(site, **kw):
    faults.arm_resource(site, **kw)
    ref_faults.arm_resource(site, **kw)


class TestEnospcRecovery:
    def test_wal_append_enospc_flags_pages_and_recovers(self, tmp_path):
        bs = batches(4)
        port, ref = port_adapter(tmp_path / "p"), ref_adapter(tmp_path / "r")
        for store, conv in ((port, to_port), (ref, lambda s: s)):
            store.accept(conv(bs[0])).execute()
        _arm("wal.append", nth=1, count=1)
        for store, conv in ((port, to_port), (ref, lambda s: s)):
            store.accept(conv(bs[1])).execute()  # ENOSPC: degrade, never crash
        c = port.ingest_counters()
        assert (c["walEnospc"], c["walMissedRecords"], c["durabilityAtRisk"]) == (1, 1, 1)
        # the durability page: the gauge spec trips the watchdog
        clock = types.SimpleNamespace(t=1000.0)
        win = WindowedTelemetry(StageRecorder(), port.ingest_counters, tick_s=1.0, slots=16,
                                coarse_slots=4, coarse_factor=16, clock=lambda: clock.t)
        dog = SloWatchdog(win, [s for s in default_specs(short_s=4, long_s=8)
                                if s.name == "durability_at_risk"])
        clock.t += 1.0
        win.tick(clock.t)
        assert dog.verdicts()[0]["alert"]
        for store, conv in ((port, to_port), (ref, lambda s: s)):
            store.accept(conv(bs[2])).execute()
            assert store.snapshot() is not None  # the commit clears at-risk
        assert port.ingest_counters()["durabilityAtRisk"] == 0
        clock.t += 1.0
        win.tick(clock.t)
        assert not dog.verdicts()[0]["alert"]
        for store, conv in ((port, to_port), (ref, lambda s: s)):
            store.accept(conv(bs[3])).execute()
        revived = (port_adapter(tmp_path / "p"), ref_adapter(tmp_path / "r"))
        assert_store_parity(*revived, end_ts=end_of(bs))

    def test_snapshot_enospc_keeps_prior_generation_and_retries(self, tmp_path):
        bs = batches(3)
        port, ref = port_adapter(tmp_path / "p"), ref_adapter(tmp_path / "r")
        for store, conv in ((port, to_port), (ref, lambda s: s)):
            store.accept(conv(bs[0])).execute()
            assert store.snapshot() is not None
            store.accept(conv(bs[1])).execute()
        _arm("snapshot", nth=1, count=1)
        assert port.snapshot() is None and ref.snapshot() is None
        c = port.ingest_counters()
        assert (c["snapshotEnospc"], c["durabilityAtRisk"]) == (1, 1)
        for store, conv in ((port, to_port), (ref, lambda s: s)):
            assert store.snapshot() is not None  # space freed: the retry commits
            assert store.ingest_counters()["durabilityAtRisk"] == 0
            store.accept(conv(bs[2])).execute()
        assert_store_parity(port_adapter(tmp_path / "p"), ref_adapter(tmp_path / "r"),
                            end_ts=end_of(bs))

    def test_snapshot_enospc_without_retry_still_recovers_via_wal(self, tmp_path):
        bs = batches(2)
        port, ref = port_adapter(tmp_path / "p"), ref_adapter(tmp_path / "r")
        for store, conv in ((port, to_port), (ref, lambda s: s)):
            for spans in bs:
                store.accept(conv(spans)).execute()
        _arm("snapshot", nth=1, count=1)
        assert port.snapshot() is None and ref.snapshot() is None
        # a crash while durability is at risk: the WAL replays to parity
        assert_store_parity(port_adapter(tmp_path / "p"), ref_adapter(tmp_path / "r"),
                            end_ts=end_of(bs))

    def test_archive_enospc_drops_batch_not_process(self, tmp_path):
        bs = batches(3)
        port = port_adapter(tmp_path / "p", wal_dir=False, checkpoint=False,
                            archive_dir=str(tmp_path / "pa"))
        ref = ref_adapter(tmp_path / "r", wal_dir=False, checkpoint=False,
                          archive_dir=str(tmp_path / "ra"))
        for store, conv in ((port, to_port), (ref, lambda s: s)):
            store.accept(conv(bs[0])).execute()
        _arm("archive", nth=1, count=1)
        for store, conv in ((port, to_port), (ref, lambda s: s)):
            store.accept(conv(bs[1])).execute()  # the archive write fails, the process stays
        c = port.ingest_counters()
        assert c["archiveEnospc"] == 1 and c["archiveSpansDroppedEnospc"] >= len(bs[1])
        assert (c["archiveAtRisk"], c["durabilityAtRisk"]) == (1, 0)
        for store, conv in ((port, to_port), (ref, lambda s: s)):
            store.accept(conv(bs[2])).execute()
        assert port.ingest_counters()["archiveAtRisk"] == 0
        assert_store_parity(port, ref, end_ts=end_of(bs))
        port.close()
        ref.close()

    def test_alloc_failure_degrades_to_backpressure(self):
        collector = Collector(InMemoryStorage())
        faults.arm_resource("alloc", nth=1, count=1)
        with pytest.raises(IngestBackpressure, match="allocation failure"):
            collector.accept_spans_bytes(bulk_payload(9, per=2))
        assert collector.accept_spans_bytes(bulk_payload(10, per=2)) == 2


# -- the slice: both packages' collectors and stores under B2 and B3 -----------------------


def test_collectors_at_b2_then_b3_admit_and_shed_alike_and_the_stores_stay_equal(tmp_path):
    """A seeded stream of 48 payloads (one in four carries an error tag)
    through each package's collector into its store, with each controller
    held at B2 (bulk admit p 0.5) for the first half and at B3 for the
    second: the same payloads are admitted and shed with the same scope and
    retry delay, and the two stores are equal afterwards."""
    port = port_adapter(tmp_path / "p", wal_dir=False, checkpoint=False)
    ref = ref_adapter(tmp_path / "r", wal_dir=False, checkpoint=False)
    pc, rc = Collector(port), RefCollector(ref)
    pc.overload = ctl_with(seed=3, ema_alpha=1.0)
    rc.overload = ref_ctl_with(seed=3, ema_alpha=1.0)
    rng = np.random.default_rng(23)
    spans = lots_of_spans(48 * 50, seed=23, services=6, span_names=5)
    mid = (0.85 + 0.95) / 2.0
    got, want, sent = [], [], []
    for i in range(48):
        if i in (0, 24):
            gauge = {"critpathQueueSaturation": (mid if i == 0 else 1.0) * 0.9}
            assert pc.overload.evaluate(gauge) == rc.overload.evaluate(gauge) == (B2 if i == 0 else B3)
        chunk = spans[i * 50:(i + 1) * 50]
        if rng.random() < 0.25:
            chunk = [dataclasses.replace(s, tags={**s.tags, "error": "true"}) for s in chunk]
        body = ref_json.encode_span_list(chunk)
        for collector, out, exc in ((pc, got, IngestBackpressure), (rc, want, RefBackpressure)):
            try:
                out.append(("admitted", collector.accept_spans_bytes(body)))
            except exc as e:
                out.append(("shed", e.scope, e.tenant, e.retry_after_s))
        if got[-1][0] == "admitted":
            sent.append(chunk)
    assert got == want
    verdicts = [g[0] for g in got]
    assert "admitted" in verdicts[24:] and "shed" in verdicts[:24] and "admitted" in verdicts[:24]
    assert pc.overload.counters() == rc.overload.counters()
    assert pc.overload.counters()["overloadShedBulk"] == verdicts.count("shed")
    assert_store_parity(port, ref, end_ts=end_of(sent))

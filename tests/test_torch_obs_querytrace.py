"""The port's query plane (``zipkin_tpu_torch/obs/querytrace.py`` and its
stamps in the store, aggregator, readpack and device observatory) against
the JAX package's: each read kind records the reference's set of query
segments on the same data, the instrumented lock keeps the reference's
ledger, the fold is the reference's, and the port's store keeps the
reference's contracts (tests/test_obs_querytrace.py's specs)."""

from __future__ import annotations

import json
import threading
import time

import pytest

import tests.torch_cpu  # noqa: F401  (one intra-op thread a test process)
from zipkin_tpu.obs import querytrace as ref_qt
from zipkin_tpu.parallel.mesh import make_mesh
from zipkin_tpu.tpu.state import AggConfig as JConfig
from zipkin_tpu.tpu.store import TpuStorage
from zipkin_tpu_torch import obs as port_obs
from zipkin_tpu_torch.obs import querytrace as port_qt
from zipkin_tpu_torch.obs.recorder import StageRecorder
from zipkin_tpu_torch.obs.windows import WindowedTelemetry
from zipkin_tpu_torch.tpu.state import AggConfig
from zipkin_tpu_torch.tpu.store import TorchStorage

SIZES = dict(max_services=64, max_keys=256, hll_precision=8, digest_centroids=16,
             digest_buffer=1 << 12, ring_capacity=1 << 12, link_buckets=4, hist_slices=2)


@pytest.fixture(scope="module")
def stores():
    ref = TpuStorage(config=JConfig(**SIZES), mesh=make_mesh(1), pad_to_multiple=256)
    port = TorchStorage(config=AggConfig(**SIZES), device="cpu", pad_to_multiple=256)
    now_ms = int(time.time() * 1000)
    spans = [{"traceId": f"{i + 1:032x}", "id": f"{i + 1:016x}", "name": "op%d" % (i % 3),
              "timestamp": (now_ms - 1000) * 1000, "duration": 1000 + i,
              "localEndpoint": {"serviceName": "svc%d" % (i % 4)}} for i in range(300)]
    data = json.dumps(spans).encode()
    for st in (ref, port):
        st.ingest_json_fast(data)
        st.set_query_observatory(True)
    yield ref, port, now_ms
    ref.close()
    port.close()


READS = {
    "dependencies": lambda st, now: st.get_dependencies(now, 3_600_000).execute(),
    "quantiles": lambda st, now: st.latency_quantiles([0.5, 0.99]),
    "windowed_quantiles": lambda st, now: st.latency_quantiles([0.5, 0.99], end_ts=now,
                                                               lookback=3_600_000),
    "cardinalities": lambda st, now: st.trace_cardinalities(),
    "overview": lambda st, now: st.sketch_overview([0.5]),
}


def _segments(store, read, now_ms):
    store.invalidate_read_cache()
    store.querytrace.reset()
    read(store, now_ms)  # fresh: a device read
    read(store, now_ms)  # cached
    wf = store.querytrace.waterfall()
    return wf["queries"], sorted(s["name"] for s in wf["segments"]), wf


@pytest.mark.parametrize("kind", sorted(READS))
def test_each_read_kind_records_the_reference_segments(stores, kind):
    ref, port, now_ms = stores
    got_n, got, wf = _segments(port, READS[kind], now_ms)
    want_n, want, _ = _segments(ref, READS[kind], now_ms)
    assert (got_n, got) == (want_n, want)
    assert {"cache_probe", "device_dispatch", "device_wall", "readpack_transfer",
            "unpack"} <= set(got)
    assert 0.9 <= wf["conservation"]["p50"] <= 1.1
    assert any(h.startswith("query:") for h in wf["lock"]["holders"])


def test_query_wall_and_lock_waits_feed_the_windowed_plane(stores):
    _, port, now_ms = stores
    port.querytrace.reset()
    port_obs.RECORDER.reset()
    win = WindowedTelemetry(port_obs.RECORDER, port.ingest_counters, tick_s=1.0)
    win.on_tick(port.querytrace.on_tick)
    port.invalidate_read_cache()
    port.get_dependencies(now_ms, 3_600_000).execute()
    port.trace_cardinalities()
    win.tick()  # stitches after its snapshot
    win.tick()  # its delta holds the relayed query walls
    w = win.window(60.0)
    assert w.stage("query_wall").count == 2
    assert w.stage("query_lock_wait").count >= 2
    counters = port.ingest_counters()
    assert counters["queryTraces"] == 2 and counters["queryLockAcquisitions"] > 0
    assert set(counters["queryLock"]) == {"waitHist", "waitSumUs", "holdHist", "holdSumUs", "holders"}


def test_clear_reapplies_the_observatory_to_the_new_aggregator(stores):
    _, port, _ = stores
    old_lock = port.agg.lock
    port.set_query_observatory(False)
    port.clear()
    assert isinstance(port.agg.lock, port_qt.InstrumentedRLock) and port.agg.lock is not old_lock
    assert not port.agg.lock.enabled and not port.querytrace.enabled
    port.set_query_observatory(True)
    assert port.agg.lock.enabled
    assert port.querytrace.counters()["queryTraces"] == 0


def _lock_scenario(mod):
    rec = type("R", (), {"seen": [], "record_relayed": lambda self, s, d: self.seen.append(s)})()
    rec.seen = []
    lk = mod.InstrumentedRLock(name="agg", recorder=rec, enabled=True)
    with mod.lock_label("wal_replay"):
        with lk:
            with lk:  # re-entrant
                pass
    with lk:
        lk.relabel("ingest_fused")
    held = threading.Event()
    go = threading.Event()

    def holder():
        with lk:
            held.set()
            go.wait(5)

    t = threading.Thread(target=holder)
    t.start()
    held.wait(5)
    waiter = threading.Thread(target=lambda: lk.acquire() and lk.release())
    waiter.start()
    time.sleep(0.05)
    go.set()
    t.join(5)
    waiter.join(5)
    c = lk.counters()
    return ({k: c[k] for k in ("queryLockAcquisitions", "queryLockContended",
                               "queryLockReentries", "queryLockWaiters",
                               "queryLockWaitersHighWater")},
            sorted(c["queryLock"]["holders"]), sorted(c), rec.seen)


def test_instrumented_lock_keeps_the_reference_ledger():
    got, want = _lock_scenario(port_qt), _lock_scenario(ref_qt)
    assert got == want
    assert got[0] == {"queryLockAcquisitions": 4, "queryLockContended": 1,
                      "queryLockReentries": 1, "queryLockWaiters": 0,
                      "queryLockWaitersHighWater": 1}
    assert got[3] == ["query_lock_wait"] * 4


def test_fold_and_stitch_equal_the_reference():
    def run(mod):
        qo = mod.QueryObservatory(recorder=StageRecorder(), enabled=True)
        tr = mod.QueryTrace("quantiles")
        tr.t0_ns = 1_000_000
        tr.wall_ns = 100_000
        tr.ivs = [(mod.QSEG_CACHE_PROBE, 1_000_000, 1_010_000),
                  (mod.QSEG_DEVICE_DISPATCH, 1_020_000, 1_050_000),
                  (mod.QSEG_READPACK_TRANSFER, 1_040_000, 1_070_000),
                  (mod.QSEG_SERIALIZE, 1_090_000, 1_200_000)]
        f = qo._fold(tr)
        qo._done.append(tr)
        qo.stitch()
        return f["durs_ns"], f["conservation"], qo.counters()["querySegments"]

    assert run(port_qt) == run(ref_qt)
    assert port_qt.QSEG_NAMES == ref_qt.QSEG_NAMES and port_qt.QSEG_KIND == ref_qt.QSEG_KIND

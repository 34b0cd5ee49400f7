"""The port's resume adapter (``zipkin_tpu_torch.storage.tpu.TorchStorage``)
against the reference's (``zipkin_tpu.storage.tpu.TpuStorage`` on one
shard), and durable boot through the port's server, on the CPU.

Each adapter case gives both packages the same sequence (batches,
snapshots, controller publishes, a crash) and holds the port's boot to the
reference's: leaves (integer bit for bit, digest weights exact and means
rtol 1e-5), host counters, vocab ids, wal_seq and reads. Crashes stop the
victim's controller first and check that its log gained nothing before the
next boot (``tests/test_torch_wal.py``'s ``crash``).

The server cases: ``TPU_RESUME_DIR`` and the explicit dirs, the snapshot
route, the periodic snapshot's bound on the WAL, a stop and start on the
same dirs, a stop that drains the request in flight before its final
snapshot, and the sampling budget that the adapter now starts.
"""

from __future__ import annotations

import glob
import http.client
import json
import os
import threading
import time

import numpy as np
import pytest

from tests.test_torch_fastpath import payloads
from tests.test_torch_server import Client
from tests.test_torch_store import SMALL, small_store, to_port
from tests.test_torch_wal import (
    assert_store_parity, batches, crash, end_of, feed, log_records, port_adapter, ref_adapter,
    sampled)
from tests.fixtures import lots_of_spans
import tests.torch_cpu  # noqa: F401  (one intra-op thread a test process)
from zipkin_tpu import faults as ref_faults
from zipkin_tpu import native as ref_native
from zipkin_tpu.model import json_v2 as ref_json
from zipkin_tpu_torch import faults, native
from zipkin_tpu_torch.server import app
from zipkin_tpu_torch.server.app import ZipkinServer, build_storage
from zipkin_tpu_torch.server.config import ServerConfig
from zipkin_tpu_torch.storage.memory import InMemoryStorage
from zipkin_tpu_torch.storage.tpu import TorchStorage
from zipkin_tpu_torch.tpu.columnar import fuse_columns, pack_spans

DAY_MS = 86_400_000


@pytest.fixture(autouse=True)
def _disarm():
    yield
    faults.disarm()
    ref_faults.disarm()


def reboot(tmp_path, victims, **kw):
    """Crash (port, reference) and boot both again on the same dirs."""
    port, ref = victims
    left = crash(port)
    crash(ref)
    assert log_records(tmp_path / "p" / "wal") == left  # the victim wrote nothing since
    return port_adapter(tmp_path / "p", **kw.get("port", {})), \
        ref_adapter(tmp_path / "r", **kw.get("ref", {}))


def test_crash_without_a_snapshot(tmp_path):
    bs = batches(4)
    stores = port_adapter(tmp_path / "p"), ref_adapter(tmp_path / "r")
    for b in bs:
        feed(stores, b)
    port, ref = reboot(tmp_path, stores)
    assert port.restore_stats["walReplayBatches"] == 4
    assert port.resume_offset == ref.resume_offset == sum(len(b) for b in bs)
    assert_store_parity(port, ref, end_of(bs))


def test_snapshot_then_crash_and_a_corrupt_newest_generation(tmp_path):
    """A snapshot, then a crash: restore plus the WAL tail. Then a fresh
    save whose state file rots at rest (the ``snapshot.state`` site): the
    next boot quarantines it, falls back one generation and replays the
    longer tail to the same state."""
    bs = batches(5)
    stores = port_adapter(tmp_path / "p"), ref_adapter(tmp_path / "r")
    for i, b in enumerate(bs[:4]):
        feed(stores, b)
        if i == 1:
            assert stores[0].snapshot() and stores[1].snapshot()
    port, ref = reboot(tmp_path, stores)
    assert port.restore_stats["walReplayBatches"] == ref.restore_stats["walReplayBatches"] == 2
    assert_store_parity(port, ref, end_of(bs[:4]))
    feed((port, ref), bs[4])
    faults.arm_corrupt("snapshot.state")
    ref_faults.arm_corrupt("snapshot.state")
    assert port.snapshot() and ref.snapshot()
    port, ref = reboot(tmp_path, (port, ref))
    for stats in (port.restore_stats, ref.restore_stats):
        assert stats["restoreFallbacks"] == 1 and stats["generationsQuarantined"] == 1
    assert glob.glob(str(tmp_path / "p" / "ckpt" / "*.npz.quarantine"))
    assert_store_parity(port, ref, end_of(bs))


def test_sampling_tables_verdicts_and_counters_restore(tmp_path):
    """The sampling tier on: controller publishes (sctl records) before and
    after a snapshot, sampled batches logged as their kept lanes. The
    reborn stores hold the victim's tables on the host and the device, give
    its verdicts, and restore its exact host counters."""
    port_cfg, ref_cfg = sampled(SMALL)
    kw = dict(sampling_budget=100.0, sampling_interval_s=3600.0)
    stores = (port_adapter(tmp_path / "p", config=port_cfg, **kw),
              ref_adapter(tmp_path / "r", config=ref_cfg, **kw))
    rng = np.random.default_rng(3)
    bs = batches(5)

    def publish():
        s = stores[0].sampler
        rate = rng.integers(1 << 12, 1 << 16, s.rate.shape, dtype=np.uint32)
        tail = rng.integers(1, 1 << 20, s.tail.shape, dtype=np.uint32)
        link = np.full(s.link.shape, 1 << 20, np.uint32)
        for store in stores:
            store.sampling_controller._publish(store.sampler, rate, tail, link)

    for i, b in enumerate(bs):
        if i in (0, 3):
            publish()
        feed(stores, b)
        if i == 2:
            assert stores[0].snapshot() and stores[1].snapshot()
    victim = stores[0]
    tables = (victim.sampler.rate.copy(), victim.sampler.tail.copy(), victim.sampler.link.copy())
    counters = dict(victim.agg.host_counters)
    assert 0 < counters["sampledDropped"] and 0 < counters["sampledKept"]
    port, ref = reboot(tmp_path, stores, port=dict(config=port_cfg, **kw),
                       ref=dict(config=ref_cfg, **kw))
    for got, want in zip((port.sampler.rate, port.sampler.tail, port.sampler.link), tables):
        np.testing.assert_array_equal(got, want)
    s = port.agg.states[0]
    for leaf, want in zip((s.s_rate, s.s_tail, s.s_link), tables):
        np.testing.assert_array_equal(leaf.numpy().astype(np.uint32), want)
    assert port.agg.host_counters == counters
    # the same verdicts over a fresh batch
    fresh = to_port(lots_of_spans(500, seed=77, services=6, span_names=5))
    cols = pack_spans(fresh, port.vocab, 256)
    fused = fuse_columns(cols)[None]
    np.testing.assert_array_equal(port.sampler.verdict_fused(fused),
                                  victim.sampler.verdict_fused(fused))
    assert port.agg.sampler is port.sampler and port.sampling_controller._thread is not None
    assert_store_parity(port, ref, end_of(bs))
    port.close()
    ref.close()
    assert port.sampling_controller._thread is None


def test_fast_ingest_after_a_resume_keeps_the_reference_ids(tmp_path):
    """Payloads through the line-rate path, a snapshot, more, a crash; then
    a payload with old and new names through the fast path of the reborn
    stores: the C interner is rebuilt from the restored vocab, so ids and
    leaves equal the reference's."""
    if not native.available() or not ref_native.available():
        pytest.skip("no C compiler for the native parser")
    spans = lots_of_spans(2400, seed=42, services=6, span_names=8)
    wire = payloads(spans[:1800], per=600)
    stores = port_adapter(tmp_path / "p"), ref_adapter(tmp_path / "r")
    for i, p in enumerate(wire):
        assert stores[0].ingest_json_fast(p) == stores[1].ingest_json_fast(p)
        if i == 1:
            assert stores[0].snapshot() and stores[1].snapshot()
    port, ref = reboot(tmp_path, stores)
    extra = lots_of_spans(600, seed=43, services=9, span_names=11)  # old and new names
    body = ref_json.encode_span_list(spans[1800:] + extra)
    assert port.ingest_json_fast(body) == ref.ingest_json_fast(body)
    assert len(port.vocab.services._names) > len(stores[0].vocab.services._names)
    assert_store_parity(port, ref, end_of([spans, extra]))


# -- the server ----------------------------------------------------------------


def test_resume_dir_derives_the_durable_dirs(monkeypatch, tmp_path):
    root = str(tmp_path / "state")
    monkeypatch.setenv("TPU_RESUME_DIR", root)
    for var in ("TPU_CHECKPOINT_DIR", "TPU_WAL_DIR"):
        monkeypatch.delenv(var, raising=False)
    cfg = ServerConfig.from_env()
    assert cfg.tpu_checkpoint_dir == os.path.join(root, "snap")
    assert cfg.tpu_wal_dir == os.path.join(root, "wal")
    assert (cfg.tpu_snapshot_interval_s, cfg.tpu_snapshot_keep, cfg.tpu_wal_fsync) == (300.0, 2, False)


def test_explicit_dirs_override_the_resume_dir(monkeypatch, tmp_path):
    monkeypatch.setenv("TPU_RESUME_DIR", str(tmp_path / "state"))
    monkeypatch.setenv("TPU_WAL_DIR", str(tmp_path / "elsewhere-wal"))
    monkeypatch.setenv("TPU_SNAPSHOT_KEEP", "3")
    monkeypatch.delenv("TPU_CHECKPOINT_DIR", raising=False)
    cfg = ServerConfig.from_env()
    assert cfg.tpu_wal_dir == str(tmp_path / "elsewhere-wal")
    assert cfg.tpu_checkpoint_dir == str(tmp_path / "state" / "snap")
    assert cfg.tpu_snapshot_keep == 3


def tpu_server(tmp_path, **config):
    """The port's server over a resume adapter on the CPU, built from its
    config as ``python -m zipkin_tpu_torch.server`` builds it."""
    config.setdefault("tpu_agg", {k: getattr(SMALL, k) for k in (
        "max_services", "max_keys", "hll_precision", "digest_centroids", "ring_capacity")})
    config.setdefault("tpu_checkpoint_dir", str(tmp_path / "snap"))
    config.setdefault("tpu_wal_dir", str(tmp_path / "wal"))
    config.setdefault("tpu_deps_max_stale_ms", 0.0)
    return ZipkinServer(ServerConfig(host="127.0.0.1", port=0, storage_type="tpu", **config),
                        seal_interval_s=0, device="cpu").start()


def test_snapshot_route_200_409_and_501(tmp_path):
    server = tpu_server(tmp_path)
    try:
        c = Client(server)
        assert c.post("/api/v2/spans", ref_json.encode_span_list(batches(1)[0]))[0] == 202
        status, body = c.post("/api/v2/tpu/snapshot", b"")
        assert status == 200 and json.loads(body) == {"snapshot": str(tmp_path / "snap")}
        assert os.path.exists(tmp_path / "snap" / "meta.json")
    finally:
        server.stop()
    for storage, want in ((InMemoryStorage(), 501), (small_store(), 501),
                          (TorchStorage(config=SMALL, device="cpu"), 409)):
        server = ZipkinServer(ServerConfig(host="127.0.0.1", port=0, storage_type="mem"),
                              storage=storage, seal_interval_s=0).start()
        try:
            assert Client(server).post("/api/v2/tpu/snapshot", b"")[0] == want
        finally:
            server.stop()


def test_periodic_snapshot_bounds_the_wal(tmp_path):
    server = tpu_server(tmp_path, tpu_snapshot_interval_s=0.2)
    try:
        store = server.storage
        store.wal.max_segment_bytes = 1  # one record per segment
        c = Client(server)
        for b in batches(4):
            assert c.post("/api/v2/spans", ref_json.encode_span_list(b))[0] == 202
        segments = lambda: glob.glob(str(tmp_path / "wal" / "wal-*.log"))  # noqa: E731

        def newest_seq():
            try:
                return json.loads((tmp_path / "snap" / "meta.json").read_text())["wal_seq"]
            except (OSError, ValueError):
                return None

        # four batch records, one segment each, and a digest-flush marker for each mirror publish
        # of the windows ticker that found pending points (its digest read flushes, as the
        # reference's does): once both retained generations hold every record, every segment but
        # the newest (the seq watermark) is deleted. Wait for both, read at one instant: two
        # generations at an older seq already leave one segment, before the next takes the head
        deadline = time.monotonic() + 30
        while True:
            n_segments, seq, head = len(segments()), newest_seq(), store.agg.wal_seq
            if (n_segments == 1 and seq == head) or time.monotonic() > deadline:
                break
            time.sleep(0.05)
        assert head >= 4
        assert n_segments == 1
        assert seq == head
        threads = list(server._threads)
    finally:
        server.stop()
    assert not any(t.is_alive() for t in threads)


def test_stop_then_start_on_the_same_dirs_answers_the_same(tmp_path):
    """The device-served routes answer the same after a stop (with its
    final snapshot) and a start on the same dirs. The raw-span archive is in
    memory only until the port has a disk archive, so the routes it serves
    (names, traces) start empty."""
    spans = lots_of_spans(900, seed=5, services=5, span_names=6)
    end_ts = max(s.timestamp for s in spans) // 1000 + 60_000
    reads = [("/api/v2/dependencies", {"endTs": end_ts, "lookback": DAY_MS}),
             ("/api/v2/tpu/percentiles", {"q": "0.5,0.99"}),
             ("/api/v2/tpu/cardinalities", None)]
    server = tpu_server(tmp_path)
    try:
        c = Client(server)
        assert c.post("/api/v2/spans", ref_json.encode_span_list(spans))[0] == 202
        before = [c.json(path, params) for path, params in reads]
        assert c.json("/api/v2/services")
    finally:
        server.stop()  # the final snapshot
    server = tpu_server(tmp_path)
    try:
        c = Client(server)
        metrics = c.json("/metrics")
        assert metrics["gauge.zipkin_tpu.walReplayBatches"] == 0  # the snapshot held it all
        assert metrics["gauge.zipkin_tpu.restoreMs"] > 0
        assert [c.json(path, params) for path, params in reads] == before
        assert c.json("/api/v2/tpu/counters")["spans"] == len(spans)
        assert c.json("/api/v2/services") == []
        assert c.get(f"/api/v2/trace/{spans[0].trace_id}")[0] == 404
    finally:
        server.stop()


def hold_post(server, spans):
    """POST ``spans`` on a thread and hold it inside the collector until the
    returned event is set: (thread, {"post": status} once done, event)."""
    entered, release = threading.Event(), threading.Event()
    accept = server.collector.accept_spans_bytes

    def held_accept(*a, **k):
        entered.set()
        assert release.wait(30)
        return accept(*a, **k)

    server.collector.accept_spans_bytes = held_accept
    status = {}
    post = threading.Thread(target=lambda: status.update(
        post=Client(server).post("/api/v2/spans", ref_json.encode_span_list(spans))[0]))
    post.start()
    assert entered.wait(30)
    return post, status, release


def test_stop_drains_a_request_in_flight_before_the_final_snapshot(tmp_path):
    """A POST still ingesting when stop() begins: stop() waits for it, so
    its 202 is in the final snapshot (no WAL here, so the snapshot is the
    only durable copy), while a keep-alive connection's next request gets
    503."""
    first, held = batches(2)
    server = tpu_server(tmp_path, tpu_wal_dir=None)
    c = Client(server)
    assert c.post("/api/v2/spans", ref_json.encode_span_list(first))[0] == 202
    idle = http.client.HTTPConnection("127.0.0.1", server.port, timeout=60)
    idle.request("GET", "/health")
    answer = idle.getresponse()
    assert answer.status == 200 and answer.read()
    post, status, release = hold_post(server, held)
    stop = threading.Thread(target=server.stop)
    stop.start()
    deadline = time.monotonic() + 30
    while not server._draining and time.monotonic() < deadline:
        time.sleep(0.01)
    idle.request("GET", "/health")
    assert idle.getresponse().status == 503
    idle.close()
    while server._httpd is not None and time.monotonic() < deadline:
        time.sleep(0.01)  # the listener is closed: stop() is past it
    time.sleep(0.2)
    assert stop.is_alive()  # waiting for the held POST
    release.set()
    post.join(30)
    stop.join(60)
    assert not stop.is_alive() and status["post"] == 202
    reborn = tpu_server(tmp_path, tpu_wal_dir=None)
    try:
        assert Client(reborn).json("/api/v2/tpu/counters")["spans"] == len(first) + len(held)
    finally:
        reborn.stop()


def test_a_request_past_the_drain_limit_answers_503(monkeypatch, tmp_path):
    """stop() waits only DRAIN_TIMEOUT_S: a request that ends later was not
    in the final snapshot, so it answers 503 and the sender retries."""
    monkeypatch.setattr(app, "DRAIN_TIMEOUT_S", 0.2)
    server = tpu_server(tmp_path, tpu_wal_dir=None)
    post, status, release = hold_post(server, batches(1)[0])
    server.stop()
    release.set()
    post.join(30)
    assert status["post"] == 503


def test_sampling_budget_moves_the_rate_tables_and_stops(monkeypatch, tmp_path):
    """STORAGE_TYPE=tpu with TPU_SAMPLING and a budget: the adapter starts
    the rate controller, whose ticks publish new tables; stop() ends it."""
    for k, v in dict(STORAGE_TYPE="tpu", TPU_SAMPLING="1", TPU_SAMPLING_BUDGET="50",
                     TPU_SAMPLING_INTERVAL_S="0.05", TPU_MAX_SERVICES="128",
                     TPU_MAX_KEYS="512", TPU_HLL_PRECISION="10",
                     TPU_DIGEST_CENTROIDS="32", TPU_RING_CAPACITY="16384").items():
        monkeypatch.setenv(k, v)
    storage = build_storage(ServerConfig.from_env(), device="cpu")
    server = ZipkinServer(ServerConfig.from_env(), storage=storage, seal_interval_s=0)
    server.config = ServerConfig(**{**server.config.__dict__, "host": "127.0.0.1", "port": 0})
    server.start()
    try:
        controller = storage.sampling_controller
        assert controller is not None and controller._thread.is_alive()
        before = storage.sampler.rate.copy()
        c = Client(server)
        spans = lots_of_spans(3000, seed=11, services=6, span_names=5)
        deadline = time.monotonic() + 30
        i = 0
        # the tables move under the load and move back once a tick sees a
        # quiet interval (a slow host leaves gaps between the POSTs), so the
        # move is watched for while the load runs
        moved = False
        while (controller.publishes < 3 or not moved) and time.monotonic() < deadline:
            body = ref_json.encode_span_list(spans[i % 3000: i % 3000 + 500])
            assert c.post("/api/v2/spans", body)[0] == 202
            i += 500
            moved = moved or not np.array_equal(storage.sampler.rate, before)
            time.sleep(0.05)
        assert controller.publishes >= 3
        assert moved
        assert c.json("/metrics")["gauge.zipkin_tpu.samplerPublishes"] >= 3
        thread = controller._thread
    finally:
        server.stop()
    thread.join(timeout=10)
    assert not thread.is_alive() and controller._thread is None

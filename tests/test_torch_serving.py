"""The port's scale-out serving (``zipkin_tpu_torch.serving``) on the CPU,
against the JAX package's (``zipkin_tpu.serving``).

The reference's own cases (tests/test_serving_segment.py,
test_serving_parity.py, test_serving_chaos.py) run against the port: the
segment's round trip, an oversized payload dropped, a crashed claim
re-evened, a CRC failure refused as a torn read, the bounded demand stripes
and key truncation, heartbeats; the settings' bounds; reader answers equal
the ingest store's at one generation, a miss registers and the next epoch
serves it, staleness bounds are hard 503s, a sweep of reader serves takes
zero aggregator-lock acquisitions and a publish one hold; the boot publish
reaches the segment; a SIGKILLed reader is respawned. Across packages: a
segment either package creates attaches with the other's
:class:`MirrorSegment` (header, payload, demand stripes); a payload the
port's store publishes decodes through the reference's ``SegmentView`` to
the same bytes as the port's; the port's reader on ``http.server`` answers
the reference's aiohttp reader byte for byte (bodies, status, Retry-After).
A spawned reader loads no torch, no jax and nothing of ``zipkin_tpu``. The
reference's tenant cases: a tenant-prefixed key registered ingest side serves
through the reader as the unscoped read it wraps, and a reader's miss on a
tenant key is refused and counted, never guessed. A reader SIGKILLed
mid-flood stays in the reference's suite (marked slow there) and here is
one kill, one respawn.

The port's repairs, each a departure from the reference: a key whose value
outgrows the segment is left out of the epoch and counted
(``segmentOversizedKeys``) while the other keys publish, where the
reference drops the whole epoch; and an idle publisher re-stamps its
unchanged epoch, so a reader keeps serving it past the staleness bound.

Tolerances: none; answers are compared as JSON bytes.
"""

from __future__ import annotations

import asyncio
import json
import os
import pickle
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
import zlib

import pytest

import tests.torch_cpu  # noqa: F401  (one intra-op thread a test process)
from tests.fixtures import lots_of_spans
from tests.test_torch_store import QS, small_store, to_port
from tests.test_torch_wal import port_adapter
from zipkin_tpu.serving import segment as ref_segment
from zipkin_tpu.serving import shape as ref_shape
from zipkin_tpu_torch.serving import segment as seg_mod
from zipkin_tpu_torch.serving.reader import ReaderApp
from zipkin_tpu_torch.serving.segment import MirrorSegment, SegmentUnavailable
from zipkin_tpu_torch.serving.shape import SegmentMiss, SegmentView, StalenessExceeded

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def J(x) -> str:
    return json.dumps(x, sort_keys=True)


def _payload(**kw):
    d = {"format": 1, "values": {"k": 1}}
    d.update(kw)
    return pickle.dumps(d, protocol=4)


def _ingest(store, n=400, seed=7) -> int:
    """Ingest n spans; returns an endTs (ms) just past them."""
    spans = lots_of_spans(n, seed=seed, services=8, span_names=12)
    store.span_consumer().accept(to_port(spans)).execute()
    return max(s.timestamp for s in spans) // 1000 + 60_000


def _serve(store, fn, *args, **kw):
    """A first touch of a key misses and registers; the next publish
    carries it."""
    try:
        return fn(*args, **kw)[0]
    except SegmentMiss:
        assert store.publish_mirror(force=True)
        return fn(*args, **kw)[0]


@pytest.fixture()
def served():
    """A store with an attached segment and one published epoch, and a
    SegmentView in the reader's role (the same protocol in one process)."""
    store = small_store(archive_max_span_count=100_000)
    seg = MirrorSegment(readers=2, capacity=4 << 20)
    try:
        store.end_ts = _ingest(store)
        store.attach_mirror_segment(seg)
        assert store.publish_mirror(force=True)
        yield store, seg, SegmentView(seg, 0)
    finally:
        store.mirror.segment_sink = None
        seg.close()
        store.close()


# -- the segment ---------------------------------------------------------------


def test_segment_round_trip_and_double_buffer():
    seg = MirrorSegment(readers=2, capacity=1 << 16)
    try:
        with pytest.raises(SegmentUnavailable, match="never published"):
            seg.read_frame()
        body = _payload()
        assert seg.write(body, mirror_generation=5, write_version=9, wall_ms=1234)
        fr = seg.read_frame()
        assert pickle.loads(fr.payload) == pickle.loads(body)
        assert (fr.gen, fr.mirror_generation, fr.write_version, fr.wall_ms, fr.publishes) == (
            2, 5, 9, 1234, 1)
        assert int(seg._a[seg_mod.H_CRC]) == zlib.crc32(body)
        assert seg.write(_payload(values={"k": 2}), mirror_generation=6, write_version=10)
        fr2 = seg.read_frame()
        assert pickle.loads(fr2.payload)["values"] == {"k": 2} and fr2.gen == 4
        # an oversized payload is dropped and the last epoch keeps serving
        assert not seg.write(b"x" * ((1 << 16) + 1), mirror_generation=7, write_version=11)
        assert seg.status()["overflows"] == 1 and seg.generation() == 4
    finally:
        seg.close()


def test_crc_failure_and_a_crashed_claim_are_torn_reads():
    seg = MirrorSegment(readers=1, capacity=1 << 16)
    try:
        seg.write(_payload(), mirror_generation=1, write_version=1)
        seg._a[seg_mod.H_GEN] = int(seg._a[seg_mod.H_GEN]) + 1  # a writer died mid-claim
        try:
            seg.read_frame(spins=12, spin_sleep_s=0.0)
            raise AssertionError("a torn frame was served")
        except SegmentUnavailable as e:
            assert "torn" in e.reason
        assert seg.write(_payload(), mirror_generation=2, write_version=2)  # re-evens
        assert seg.read_frame().gen % 2 == 0
        buf = int(seg._a[seg_mod.H_BUF])
        off = seg._buf0_off if buf == 0 else seg._buf1_off
        seg._shm.buf[off:off + 4] = b"\xde\xad\xbe\xef"  # rot behind the header's back
        try:
            seg.read_frame(spins=6, spin_sleep_s=0.0)
            raise AssertionError("a corrupt frame was served")
        except SegmentUnavailable as e:
            assert e.torn == 6 and e.writer_alive
    finally:
        seg.close()


def test_demand_stripes_are_bounded_and_drain_in_order():
    seg = MirrorSegment(readers=2, capacity=1 << 14, demand_slots=4, key_cap=16)
    try:
        for i in range(4):
            assert seg.demand_push(0, f"quant:0.{i}")
        assert not seg.demand_push(0, "overflowed")
        assert seg.demand_push(1, "k" * 100)
        assert seg.demand_drain() == [f"quant:0.{i}" for i in range(4)] + ["k" * 16]
        assert seg.demand_drain() == []
        seg.heartbeat(0, gen_seen=0, serves=7, age_us=1500, demands=3, demand_overflow=1, errors=0)
        r0, r1 = seg.reader_status()
        assert r0["alive"] and r0["serves"] == 7 and r0["lastServeAgeMs"] == 1.5
        assert r1["pid"] == 0 and not r1["alive"]
        seg.note_supervisor(4242, 3)
        assert (seg.status()["supervisorPid"], seg.status()["respawns"]) == (4242, 3)
    finally:
        seg.close()


@pytest.mark.parametrize("creator", ["port", "ref"])
def test_a_segment_attaches_with_the_other_packages_class(creator):
    mods = {"port": seg_mod, "ref": ref_segment}
    other = "ref" if creator == "port" else "port"
    seg = mods[creator].MirrorSegment(readers=3, capacity=1 << 16, demand_slots=8, key_cap=40)
    try:
        seg.write(_payload(values={"k": 3}), mirror_generation=4, write_version=8)
        att = mods[other].MirrorSegment(name=seg.name)  # geometry from the header words
        try:
            assert (att.readers, att.capacity, att.demand_slots, att.key_cap) == (3, 1 << 16, 8, 40)
            assert (att._buf0_off, att._buf1_off) == (seg._buf0_off, seg._buf1_off)
            fr = att.read_frame()
            assert pickle.loads(fr.payload)["values"] == {"k": 3}
            assert (fr.mirror_generation, fr.write_version) == (4, 8)
            assert att.demand_push(2, "card")
            att.heartbeat(2, gen_seen=fr.gen, serves=1, age_us=5, demands=1,
                          demand_overflow=0, errors=0)
            assert seg.demand_drain() == ["card"]
            assert seg.reader_status()[2]["serves"] == 1
            att.write(_payload(values={"k": 4}), mirror_generation=5, write_version=9)
            assert pickle.loads(seg.read_frame().payload)["values"] == {"k": 4}
        finally:
            att.close()
    finally:
        seg.close()


@pytest.mark.parametrize("name,value", [
    ("TPU_READERS", "0"), ("TPU_READERS", "65"),
    ("TPU_MIRROR_SEGMENT_BYTES", "1024"), ("TPU_MIRROR_SEGMENT_BYTES", str(2 << 30)),
    ("TPU_READER_PORT_BASE", "80"), ("TPU_READER_PORT_BASE", "70000"),
])
def test_serving_settings_refuse_out_of_bounds(monkeypatch, name, value):
    from zipkin_tpu_torch.server.config import ServerConfig

    monkeypatch.setenv(name, value)
    with pytest.raises(ValueError, match=name):
        ServerConfig.from_env()


def test_serving_settings_parse(monkeypatch):
    from zipkin_tpu_torch.server.config import ServerConfig

    cfg = ServerConfig.from_env()
    assert (cfg.tpu_mirror_segment_bytes, cfg.tpu_readers, cfg.tpu_reader_port_base) == (0, 4, 9512)
    assert (cfg.tpu_read_mirror, cfg.tpu_mirror_max_stale_ms) == (True, 5000)
    monkeypatch.setenv("TPU_READERS", "8")
    monkeypatch.setenv("TPU_MIRROR_SEGMENT_BYTES", str(8 << 20))
    monkeypatch.setenv("TPU_READER_PORT_BASE", "9700")
    monkeypatch.setenv("TPU_READ_MIRROR", "0")
    cfg = ServerConfig.from_env()
    assert (cfg.tpu_readers, cfg.tpu_mirror_segment_bytes, cfg.tpu_reader_port_base) == (
        8, 8 << 20, 9700)
    assert cfg.tpu_read_mirror is False


# -- reader answers against the ingest store -------------------------------------


def test_reader_answers_equal_the_store_at_one_generation(served):
    store, _seg, view = served
    end_ts = store.end_ts
    assert J(_serve(store, view.serve_quantiles, QS)) == J(store.latency_quantiles(list(QS)))
    assert J(_serve(store, view.serve_quantiles, QS, "svc01", None, False)) == J(
        store.latency_quantiles(list(QS), "svc01", None, False))
    assert J(_serve(store, view.serve_cardinalities)) == J(store.trace_cardinalities())
    over = _serve(store, view.serve_overview, QS)
    want = store.sketch_overview(list(QS))
    assert J(over["percentiles"]) == J(want["percentiles"])
    assert J(over["cardinalities"]) == J(want["cardinalities"])
    from zipkin_tpu_torch.model.json_v2 import link_to_dict

    deps = _serve(store, view.serve_dependencies, end_ts, 7 * 86_400_000)
    assert deps and J(deps) == J([link_to_dict(x) for x in
                                  store.get_dependencies(end_ts, 7 * 86_400_000).execute()])


def test_a_miss_registers_and_the_next_epoch_serves(served):
    store, _seg, view = served
    with pytest.raises(SegmentMiss) as ei:
        view.serve_quantiles((0.25,))
    assert ei.value.registered
    assert store.publish_mirror(force=True)  # drains the reader's demand first
    assert J(view.serve_quantiles((0.25,))[0]) == J(store.latency_quantiles([0.25]))
    counters = store.ingest_counters()
    assert counters["readerDemandRequests"] == 1 and counters["readerDemandOverflow"] == 0
    assert counters["readerDemandUnparsed"] == 0


def test_staleness_bounds_are_hard_503s_never_silent_stale(served):
    _store, _seg, view = served
    with pytest.raises(StalenessExceeded) as ei:
        view.serve_cardinalities(staleness_ms=0)
    assert ei.value.fresh_required
    with pytest.raises(StalenessExceeded) as ei:
        view.serve_cardinalities(staleness_ms=1e-6)
    assert not ei.value.fresh_required and ei.value.age_ms > ei.value.bound_ms
    rows, age = view.serve_cardinalities(staleness_ms=60_000)
    assert rows["_global"] > 0 and age >= 0.0
    assert (view.stale_rejects, view.fresh_rejects) == (1, 1)


def test_reader_serves_take_zero_lock_acquisitions_and_a_publish_one(served):
    store, _seg, view = served
    store.set_query_observatory(True)
    end_ts = int(time.time() * 1000)
    _serve(store, view.serve_dependencies, end_ts, 3_600_000)
    _serve(store, view.serve_overview, QS)
    before = store.ingest_counters()["queryLockAcquisitions"]
    for _ in range(30):
        view.serve_quantiles(QS)
        view.serve_cardinalities()
        view.serve_overview(QS)
        view.serve_dependencies(end_ts, 3_600_000)
    assert store.ingest_counters()["queryLockAcquisitions"] == before
    assert view.serves >= 120 and view.memo_hits >= 3 * 29
    assert store.publish_mirror(force=True)  # the segment rides outside the lock
    assert store.ingest_counters()["queryLockAcquisitions"] == before + 1


def test_a_port_payload_decodes_the_same_through_the_references_view(served):
    store, seg, view = served
    ref_seg = ref_segment.MirrorSegment(name=seg.name)
    try:
        ref_view = ref_shape.SegmentView(ref_seg, 1)
        end_ts = store.end_ts
        calls = [("serve_quantiles", (QS,)), ("serve_quantiles", (QS, "svc02", None, True)),
                 ("serve_cardinalities", ()), ("serve_overview", (QS,)),
                 ("serve_dependencies", (end_ts, 7 * 86_400_000))]
        for name, args in calls:
            mine = _serve(store, getattr(view, name), *args)
            theirs = getattr(ref_view, name)(*args)[0]
            if name == "serve_overview":
                mine, theirs = dict(mine), dict(theirs)
            assert J(mine) == J(theirs), name
        payload = pickle.loads(seg.read_frame().payload)
        assert not [k for k, v in payload["values"].items()
                    if any("torch" in type(x).__module__ for x in v)]
    finally:
        ref_seg.close()


def test_the_boot_publish_reaches_the_segment_and_close_retires_it(tmp_path):
    victim = port_adapter(tmp_path)
    _ingest(victim, n=600, seed=11)
    victim.snapshot()
    want = victim.trace_cardinalities(staleness_ms=0)
    victim.close()
    resumed = port_adapter(tmp_path, mirror_segment_bytes=4 << 20, mirror_segment_readers=2)
    try:
        seg = resumed.mirror_segment
        reader = MirrorSegment.attach(seg.params())
        try:
            rows, _ = SegmentView(reader, 1).serve_cardinalities()
            assert J(rows) == J(want) == J(resumed.trace_cardinalities())
        finally:
            reader.close()
        name = seg.name
    finally:
        resumed.close()
    assert resumed.mirror_segment is None and resumed.mirror.segment_sink is None
    with pytest.raises(FileNotFoundError):
        MirrorSegment(name=name)


# -- the HTTP reader ---------------------------------------------------------------


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


class _RefReader:
    """The reference's aiohttp reader over the same segment, on a loop of
    its own thread."""

    def __init__(self, seg_name):
        from aiohttp import web
        from zipkin_tpu.serving.reader import ReaderApp as RefApp

        self.seg = ref_segment.MirrorSegment(name=seg_name)
        self.app = RefApp(ref_shape.SegmentView(self.seg, 1))
        self.loop = asyncio.new_event_loop()
        self.runner = web.AppRunner(self.app.build())
        ready = threading.Event()

        def run():
            asyncio.set_event_loop(self.loop)
            self.loop.run_until_complete(self.runner.setup())
            site = web.TCPSite(self.runner, "127.0.0.1", 0)
            self.loop.run_until_complete(site.start())
            self.port = site._server.sockets[0].getsockname()[1]
            ready.set()
            self.loop.run_forever()

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()
        assert ready.wait(30)

    def close(self):
        asyncio.run_coroutine_threadsafe(self.runner.cleanup(), self.loop).result(30)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(30)
        self.seg.close()


def test_the_http_reader_answers_as_the_references_byte_for_byte(served):
    store, seg, _view = served
    app = ReaderApp(SegmentView(MirrorSegment.attach(seg.params()), 0))
    httpd = app.make_server(port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    ref = _RefReader(seg.name)
    try:
        end_ts = store.end_ts
        paths = ["/api/v2/tpu/percentiles", "/api/v2/tpu/percentiles?serviceName=svc03&sketch=hist",
                 "/api/v2/tpu/cardinalities", "/api/v2/tpu/overview?q=0.5,0.9,0.99",
                 f"/api/v2/dependencies?endTs={end_ts}&lookback=604800000"]
        for path in paths:  # misses register; one publish carries them all
            _get(httpd.server_address[1], path)
        assert store.publish_mirror(force=True)
        errors = ["/api/v2/tpu/cardinalities?staleness_ms=0", "/api/v2/dependencies",
                  "/api/v2/tpu/percentiles?q=2", "/api/v2/tpu/percentiles?staleness_ms=x",
                  "/api/v2/tpu/percentiles?q=0.125", "/nowhere"]
        for path in paths + errors:
            got = _get(httpd.server_address[1], path)
            want = _get(ref.port, path)
            assert got[0] == want[0], path
            assert got[1]["Content-Type"] == want[1]["Content-Type"], path
            assert got[2] == want[2], path
            assert ("Retry-After" in got[1]) == ("Retry-After" in want[1]), path
            if got[0] == 200:
                assert float(got[1]["X-Staleness-Ms"]) >= 0.0
            if got[0] == 503:
                assert got[1]["Retry-After"] == want[1]["Retry-After"] == "1"
        status, _, body = _get(httpd.server_address[1], "/prometheus")
        lines = body.decode().splitlines()
        assert status == 200 and 'zipkin_tpu_reader_index{reader="r0"} 0' in lines
        ref_names = {ln.split("{")[0] for ln in _get(ref.port, "/prometheus")[2].decode().splitlines()}
        assert {ln.split("{")[0] for ln in lines} == ref_names
        metrics = json.loads(_get(httpd.server_address[1], "/metrics")[2])["reader"]
        assert set(metrics) == set(json.loads(_get(ref.port, "/metrics")[2])["reader"])
        assert json.loads(_get(httpd.server_address[1], "/health")[2])["status"] == "UP"
    finally:
        ref.close()
        httpd.shutdown()
        httpd.server_close()
        app.view._seg.close()


# -- reader processes -----------------------------------------------------------------


def _free_port_base(n):
    """A base port with n + 1 free ports below and at it (base - 1 included)."""
    for _ in range(50):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            base = s.getsockname()[1] + 1
        if base + n < 65000:
            try:
                socks = []
                for p in range(base - 1, base + n):
                    sk = socket.socket()
                    sk.bind(("127.0.0.1", p))
                    socks.append(sk)
                return base
            except OSError:
                continue
            finally:
                for sk in socks:
                    sk.close()
    raise RuntimeError("no free port range")


def _wait_up(port, limit_s=60.0):
    deadline = time.monotonic() + limit_s
    while time.monotonic() < deadline:
        try:
            if _get(port, "/health")[0] == 200:
                return True
        except OSError:
            pass
        time.sleep(0.1)
    return False


def test_a_spawned_reader_loads_no_torch_and_a_killed_one_respawns(served):
    from zipkin_tpu_torch.runtime.supervisor import RespawnBackoff
    from zipkin_tpu_torch.serving.supervisor import ReaderSupervisor

    store, seg, _view = served
    base = _free_port_base(1)
    sup = ReaderSupervisor(seg, 1, base, backoff=RespawnBackoff(base_s=0.05, healthy_s=0.0))
    sup.start()
    try:
        assert _wait_up(base), "the reader never answered"
        pid = sup._children[0].pid
        with open(f"/proc/{pid}/maps") as f:
            maps = f.read()
        assert "libtorch" not in maps and "libc10" not in maps and "libcuda" not in maps
        status, headers, body = _get(base, "/api/v2/tpu/cardinalities")
        assert status == 200 and J(json.loads(body)) == J(store.trace_cardinalities())
        os.kill(pid, signal.SIGKILL)
        deadline = time.monotonic() + 30
        while sup.respawns == 0 and time.monotonic() < deadline:
            sup.poll()
            time.sleep(0.05)
        assert sup.respawns == 1 and seg.status()["respawns"] == 1
        assert _wait_up(base) and sup._children[0].pid != pid
    finally:
        sup.stop()
    # what a reader process imports: numpy and the standard library
    code = ("import sys\n"
            "from zipkin_tpu_torch.serving import reader, supervisor, segment, shape\n"
            "import zipkin_tpu_torch.serving.__main__\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in ('torch', 'jax', 'zipkin_tpu')))\n")
    done = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                          timeout=120, env=dict(os.environ, PYTHONPATH=ROOT))
    assert done.returncode == 0, done.stderr
    assert done.stdout.strip() == "[]"


def test_a_reader_process_that_exits_leaves_the_segment_attachable():
    """Python 3.12's resource tracker unlinks every block a process tree
    attached when it exits; an exiting reader front end must not take the
    ingest process's segment with it (the reference's does)."""
    seg = MirrorSegment(readers=1, capacity=1 << 16)
    try:
        seg.write(_payload(values={"k": 5}), mirror_generation=1, write_version=1)
        code = ("import sys\nfrom zipkin_tpu_torch.serving.segment import MirrorSegment\n"
                "s = MirrorSegment(name=sys.argv[1])\nassert s.read_frame().mirror_generation == 1\n"
                "s.close()\n")
        done = subprocess.run([sys.executable, "-c", code, seg.name], cwd=ROOT, capture_output=True,
                              text=True, timeout=120, env=dict(os.environ, PYTHONPATH=ROOT))
        assert done.returncode == 0, done.stderr
        assert "leaked" not in done.stderr
        again = MirrorSegment(name=seg.name)  # still there after the tracker exited
        try:
            assert pickle.loads(again.read_frame().payload)["values"] == {"k": 5}
        finally:
            again.close()
    finally:
        seg.close()


def test_request_threads_never_pair_one_epoch_with_anothers_vocab():
    """The reader's request threads share one SegmentView while epochs
    change under them: epoch g names g services and estimates g for each,
    so a serve that took one epoch's values and another's vocab answers a
    row count other than its values."""
    import numpy as np

    seg = MirrorSegment(readers=1, capacity=1 << 20)
    view = SegmentView(MirrorSegment.attach(seg.params()), 0)

    def publish(g):
        est = np.full(70, float(g))
        seg.write(pickle.dumps({
            "published_at": time.monotonic(), "max_stale_ms": 1e9, "deps_max_stale_ms": 1e9,
            "tt_enabled": False, "tt_sealed_through": -1, "time_bucket_minutes": 5,
            "global_hll_row": 69, "services": [""] + [f"s{i}" for i in range(1, g + 1)],
            "span_names": [""], "key_list": np.zeros((1, 2), np.int32),
            "values": {"card": ("card", est)}, "counters": {}}, protocol=4),
            mirror_generation=g, write_version=g)

    publish(1)
    bad, stop = [], threading.Event()

    def serve():
        while not stop.is_set():
            rows, _ = view.serve_cardinalities()
            g = rows["_global"]
            if len(rows) - 1 != g or any(v != g for v in rows.values()):
                bad.append(rows)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    threads = [threading.Thread(target=serve) for _ in range(12)]
    try:
        for t in threads:
            t.start()
        for g in range(2, 60):
            publish(g)
            time.sleep(0.002)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30)
        sys.setswitchinterval(interval)
        view._seg.close()
        seg.close()
    assert not any(t.is_alive() for t in threads)
    assert not bad, bad[0]
    assert view.decodes > 10


def test_tenant_prefixed_key_parity(served):
    """A tenant-scoped mirror key registered ingest side serves through the
    reader's ``tenant`` with the bytes of the unscoped read it wraps."""
    store, _seg, view = served
    store.mirror.register("tenant:t1:card", lambda: store.agg.cardinalities(), pinned=True)
    assert store.publish_mirror(force=True)
    assert J(_serve(store, view.serve_cardinalities, None, None, None, "t1")) == \
        J(store.trace_cardinalities())


def test_tenant_demand_keys_are_refused_not_guessed(served):
    """A reader's miss on a tenant-prefixed key is not registered (the
    publisher cannot infer a scoped compute): it is counted
    ``readerDemandUnparsed`` and keeps missing."""
    store, _seg, view = served
    with pytest.raises(SegmentMiss):
        view.serve_cardinalities(None, None, None, "t9")
    assert store.publish_mirror(force=True)
    assert store.ingest_counters()["readerDemandUnparsed"] == 1
    with pytest.raises(SegmentMiss):
        view.serve_cardinalities(None, None, None, "t9")


def test_an_oversized_key_is_left_out_and_the_rest_still_serve():
    """A registered ``ttq:`` window whose dense planes outgrow a small
    segment: the epoch publishes without it (counted), and the card,
    dependency and quantile keys serve from a ``SegmentView``."""
    store = small_store(archive_max_span_count=100_000)
    seg = MirrorSegment(readers=1, capacity=96 << 10)
    try:
        end_ts = _ingest(store)
        store._deps_max_stale_ms = 60_000.0
        store.attach_mirror_segment(seg)
        lo, hi = store._tt_epochs(end_ts, 3_600_000)
        assert store.mirror_register_key(f"ttq:{lo}:{hi}")
        store.get_dependencies(end_ts, 3_600_000).execute()  # a miss registers deps
        assert store.publish_mirror(force=True)
        snap = store.mirror.snapshot()
        assert len(pickle.dumps(snap.values[f"ttq:{lo}:{hi}"])) > seg.capacity
        c = store.ingest_counters()
        assert c["segmentOversizedKeys"] == 1 and c["segmentOverflows"] == 0
        assert c["segmentPublishes"] == 1
        view = SegmentView(seg, 0)
        payload = view.refresh()
        assert f"ttq:{lo}:{hi}" not in payload["values"]
        assert J(view.serve_cardinalities()[0]) == J(store.trace_cardinalities(staleness_ms=0))
        assert J(view.serve_quantiles(QS)[0]) == J(store.latency_quantiles(QS, staleness_ms=0))
        assert view.serve_dependencies(end_ts, 3_600_000)[0]
    finally:
        store.mirror.segment_sink = store.mirror.segment_restamp = None
        seg.close()


def test_an_idle_publisher_restamps_its_epoch_so_readers_keep_serving(served):
    """No ingest after an epoch: past ``max_stale_ms`` a reader still serves,
    because each skipped publish re-stamps the unchanged epoch; once the
    state moves, a skipped publish cannot happen and the stale epoch ages."""
    store, seg, view = served
    store.mirror.max_stale_ms = 200.0
    assert store.publish_mirror(force=True)
    rows, _ = view.serve_cardinalities()
    gen, decodes = seg.generation(), view.decodes
    time.sleep(0.3)
    assert not store.publish_mirror()  # skipped: nothing changed
    assert seg.generation() > gen and store.ingest_counters()["segmentRestamps"] >= 1
    got, age = view.serve_cardinalities()  # past the bound since the write
    assert J(got) == J(rows) and age < 200.0
    assert view.decodes == decodes  # the re-stamp reused the decoded epoch
    _ingest(store, seed=9)  # the state moves: no re-stamp
    time.sleep(0.3)
    assert not store.mirror.segment_restamp(store.mirror.snapshot())
    with pytest.raises(StalenessExceeded):
        view.serve_cardinalities()

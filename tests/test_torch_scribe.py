"""The port's scribe collector (``zipkin_tpu_torch/collector/scribe.py``):
the reference's ``tests/test_scribe.py`` (3 cases) against the port; the
same frames into both packages' device stores (integer planes bit-equal,
digest means rtol 1e-5); and a server booted from the reference's
environment (``COLLECTOR_SCRIBE_ENABLED``, port 0) whose scribe-fed trace
reads back over HTTP and survives ``stop()`` and a boot from its
checkpoint; such a server answers HTTP only once its scribe port is bound
(a ``/health`` of UP means scribe takes connections).

Frames carry the reference's thrift v1 encoding of ``tests/fixtures.py``
spans, base64 in ``LogEntry`` messages of category ``zipkin``. Every
socket has a deadline.
"""

from __future__ import annotations

import asyncio
import base64
import json
import socket
import struct
import urllib.request

import numpy as np

import tests.torch_cpu  # noqa: F401  (one intra-op thread a test process)
from tests.fixtures import TRACE, lots_of_spans
from tests.test_scribe import _entries_for, _log_call
from tests.test_torch_store import WEEK_MS, links, ref_store, small_store
from zipkin_tpu.collector.core import Collector as RefCollector
from zipkin_tpu.collector.scribe import ScribeCollector as RefScribe
from zipkin_tpu_torch.collector.core import Collector
from zipkin_tpu_torch.collector.scribe import (
    OK,
    ScribeCollector,
    _parse_log_call,
    decode_scribe_message,
)
from zipkin_tpu_torch.server.app import ZipkinServer, build_storage
from zipkin_tpu_torch.server.config import ServerConfig
from zipkin_tpu_torch.storage.memory import InMemoryStorage
from zipkin_tpu_torch.tpu.state import AggState

_T_I32 = 8
TIMEOUT_S = 30.0


def _exchange(port: int, frames) -> list:
    """Send each frame on one connection and read its reply."""
    replies = []
    with socket.create_connection(("127.0.0.1", port), timeout=TIMEOUT_S) as sock:
        f = sock.makefile("rb")
        for frame in frames:
            sock.sendall(frame)
            (length,) = struct.unpack(">I", f.read(4))
            replies.append(f.read(length))
    return replies


def _ok(reply: bytes) -> bool:
    return reply.endswith(bytes([_T_I32]) + struct.pack(">hi", 0, OK) + b"\x00")


def _on_loop(scribe, scenario):
    async def run():
        await scribe.start()
        try:
            return await asyncio.wait_for(asyncio.to_thread(scenario, scribe.port), TIMEOUT_S)
        finally:
            await asyncio.wait_for(scribe.stop(), TIMEOUT_S)

    return asyncio.run(run())


# -- tests/test_scribe.py -----------------------------------------------------


def test_parse_log_call():
    seqid, entries = _parse_log_call(_log_call(_entries_for(TRACE))[4:])
    assert seqid == 7
    assert len(entries) == len(TRACE)
    assert entries[0][0] == "zipkin"


def test_scribe_roundtrip():
    storage = InMemoryStorage()
    (reply,) = _on_loop(ScribeCollector(Collector(storage), host="127.0.0.1", port=0),
                        lambda port: _exchange(port, [_log_call(_entries_for(TRACE))]))
    # a versioned REPLY for "Log" with ResultCode OK
    assert b"Log" in reply and _ok(reply)
    trace = storage.get_trace(TRACE[0].trace_id).execute()
    assert len(trace) == len(TRACE)
    # client/server pair semantics survive the v1 conversion
    kinds = {(s.id, s.kind.value if s.kind else None) for s in trace}
    assert ("0000000000000002", "CLIENT") in kinds and ("0000000000000002", "SERVER") in kinds


def test_non_zipkin_category_ignored():
    storage = InMemoryStorage()
    _on_loop(ScribeCollector(Collector(storage), host="127.0.0.1", port=0),
             lambda port: _exchange(port, [_log_call([(b"other", base64.b64encode(b"junk"))])]))
    assert storage.span_count == 0


# -- across the two packages --------------------------------------------------


def test_scribe_frames_fill_the_same_device_state():
    """The same frames through the reference's scribe collector into
    ``TpuStorage(mesh=make_mesh(1))`` and the port's into
    ``TorchStorage(device="cpu")``: every reply OK, equal leaves, counters
    and links, and the port's frames decode to the spans sent."""
    spans = lots_of_spans(2000, seed=23, services=6, span_names=8)
    entries = _entries_for(spans)
    frames = [_log_call(entries[lo:lo + 256], seqid=lo) for lo in range(0, len(entries), 256)]
    assert [s.id for s in decode_scribe_message(entries[5][1])] == [spans[5].id]
    ref, port = ref_store(), small_store()
    for store in (ref, port):
        store._deps_max_stale_ms = 0.0
    ref_replies = _on_loop(RefScribe(RefCollector(ref), host="127.0.0.1", port=0),
                           lambda p: _exchange(p, frames))
    port_replies = _on_loop(ScribeCollector(Collector(port), host="127.0.0.1", port=0),
                            lambda p: _exchange(p, frames))
    assert port_replies == ref_replies and all(_ok(r) for r in port_replies)
    assert port.agg.host_counters == ref.agg.host_counters
    assert port.agg.host_counters["spans"] == len(spans)
    for name, g, w in zip(AggState._fields, port.agg.state_arrays(), ref.agg.state_arrays()):
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, name
        if name in ("digest", "tb_digest"):
            np.testing.assert_array_equal(g[..., 1], w[..., 1], err_msg=name)
            np.testing.assert_allclose(g[..., 0], w[..., 0], rtol=1e-5, err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
    end_ts = max(s.timestamp for s in spans) // 1000 + 60_000
    want = links(ref.get_dependencies(end_ts, WEEK_MS).execute())
    assert want and links(port.get_dependencies(end_ts, WEEK_MS).execute()) == want


# -- the server ---------------------------------------------------------------


def _boot(monkeypatch, root) -> ZipkinServer:
    env = dict(QUERY_HOST="127.0.0.1", QUERY_PORT="0", STORAGE_TYPE="tpu",
               COLLECTOR_SCRIBE_ENABLED="1", COLLECTOR_SCRIBE_PORT="0",
               TPU_RESUME_DIR=str(root), TPU_MAX_SERVICES="64", TPU_MAX_KEYS="256",
               TPU_HLL_PRECISION="9", TPU_DIGEST_CENTROIDS="32", TPU_RING_CAPACITY="8192",
               TPU_DEPS_MAX_STALE_MS="0")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    cfg = ServerConfig.from_env()
    assert cfg.scribe_enabled and cfg.scribe_port == 0
    return ZipkinServer(cfg, storage=build_storage(cfg, device="cpu"), seal_interval_s=0).start()


def _trace(server: ZipkinServer, trace_id: str):
    url = f"http://127.0.0.1:{server.port}/api/v2/trace/{trace_id}"
    with urllib.request.urlopen(url, timeout=TIMEOUT_S) as resp:
        return json.loads(resp.read())


def test_server_scribe_from_env_reads_back_and_survives_a_reboot(monkeypatch, tmp_path):
    server = _boot(monkeypatch, tmp_path / "state")
    try:
        assert server.scribe_port and server.components["scribe"].check().ok
        (reply,) = _exchange(server.scribe_port, [_log_call(_entries_for(TRACE))])
        assert _ok(reply)
        assert len(_trace(server, TRACE[0].trace_id)) == len(TRACE)
        assert server.metrics.get("spans", "scribe") == len(TRACE)
        assert server._scribe.collector.overload is None  # the reference's: no admission
    finally:
        server.stop()
    assert server._scribe is None and "scribe" not in server.components
    again = _boot(monkeypatch, tmp_path / "state")
    try:
        # the final snapshot holds every acked span: nothing is left to replay
        assert (tmp_path / "state" / "snap").is_dir()
        assert again.storage.restore_stats["walReplayBatches"] == 0
        assert again.storage.agg.host_counters["spans"] == len(TRACE)
        assert len(_trace(again, TRACE[0].trace_id)) == len(TRACE)
    finally:
        again.stop()


def test_stop_closes_a_connection_that_waits_between_frames():
    """A client that keeps its connection open after its frames cannot hold
    a server's stop(): the connection waiting for its next frame is closed
    (the reference's stop waits for the client to hang up)."""
    storage = InMemoryStorage()
    scribe = ScribeCollector(Collector(storage), host="127.0.0.1", port=0)

    async def run():
        await scribe.start()
        reader, writer = await asyncio.open_connection("127.0.0.1", scribe.port)
        writer.write(_log_call(_entries_for(TRACE)))
        await writer.drain()
        (length,) = struct.unpack(">I", await reader.readexactly(4))
        assert _ok(await reader.readexactly(length))
        t0 = asyncio.get_running_loop().time()
        await asyncio.wait_for(scribe.stop(), TIMEOUT_S)  # the client still holds it open
        stopped_in = asyncio.get_running_loop().time() - t0
        assert await asyncio.wait_for(reader.read(), TIMEOUT_S) == b""  # closed by the server
        writer.close()
        return stopped_in

    assert asyncio.run(run()) < 5.0
    assert len(storage.get_trace(TRACE[0].trace_id).execute()) == len(TRACE)


def test_the_server_answers_http_only_after_its_scribe_port_is_bound(monkeypatch):
    answered = []
    real_start = ScribeCollector.start

    async def start(self):
        # before scribe binds: a /health now must find no one serving
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{server.port}/health", timeout=0.5):
                answered.append(True)
        except OSError:
            answered.append(False)
        return await real_start(self)

    monkeypatch.setattr(ScribeCollector, "start", start)
    server = ZipkinServer(ServerConfig(host="127.0.0.1", port=0, storage_type="mem",
                                       scribe_enabled=True, scribe_port=0), seal_interval_s=0)
    server.start()
    try:
        assert answered == [False]
        with urllib.request.urlopen(f"http://127.0.0.1:{server.port}/health",
                                    timeout=TIMEOUT_S) as resp:
            assert json.loads(resp.read())["status"] == "UP"
        with socket.create_connection(("127.0.0.1", server.scribe_port), timeout=TIMEOUT_S):
            pass
    finally:
        server.stop()

"""The port's gRPC collector (``zipkin_tpu_torch/server/grpc.py``): the
reference's ``tests/test_grpc_collector.py`` cases against the port's
``GrpcCollectorServer`` and ``http.server`` server, plus the refusal to
start when ``grpc`` cannot be imported.

The spans cross at the wire: the reference's proto3 encoder makes the
``ListOfSpans`` bytes, the port decodes and stores them. Every channel call
and server stop has its own deadline.
"""

from __future__ import annotations

import asyncio
import os
import subprocess
import sys
import textwrap

import grpc
import grpc.aio
import pytest

import tests.torch_cpu  # noqa: F401  (one intra-op thread a test process)
from tests.fixtures import TRACE
from zipkin_tpu.model import proto3 as ref_proto3
from zipkin_tpu_torch import obs
from zipkin_tpu_torch.collector.core import Collector
from zipkin_tpu_torch.obs.selfspans import CURRENT_B3
from zipkin_tpu_torch.server.app import ZipkinServer
from zipkin_tpu_torch.server.config import ServerConfig
from zipkin_tpu_torch.server.grpc import METHOD, GrpcCollectorServer
from zipkin_tpu_torch.storage.memory import InMemoryStorage
from zipkin_tpu_torch.tpu.mp_ingest import IngestBackpressure

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BODY = ref_proto3.encode_span_list(TRACE)
CALL_S = 10.0


def _serve(collector, scenario):
    """Run ``scenario(port)`` against a GrpcCollectorServer on its own loop."""
    async def run():
        server = GrpcCollectorServer(collector, host="127.0.0.1", port=0)
        await server.start()
        try:
            await asyncio.wait_for(scenario(server.port), CALL_S)
        finally:
            await asyncio.wait_for(server.stop(), CALL_S)

    asyncio.run(run())


def test_report_roundtrip():
    storage = InMemoryStorage()

    async def scenario(port):
        async with grpc.aio.insecure_channel(f"127.0.0.1:{port}") as ch:
            assert await ch.unary_unary(METHOD)(BODY, timeout=CALL_S) == b""

    _serve(Collector(storage), scenario)
    assert len(storage.get_trace(TRACE[0].trace_id).execute()) == len(TRACE)


def test_report_malformed_invalid_argument():
    async def scenario(port):
        async with grpc.aio.insecure_channel(f"127.0.0.1:{port}") as ch:
            with pytest.raises(grpc.aio.AioRpcError) as err:
                await ch.unary_unary(METHOD)(b"\xff\xff\xff", timeout=CALL_S)
            assert err.value.code() == grpc.StatusCode.INVALID_ARGUMENT

    _serve(Collector(InMemoryStorage()), scenario)


def test_unknown_method_unimplemented():
    async def scenario(port):
        async with grpc.aio.insecure_channel(f"127.0.0.1:{port}") as ch:
            with pytest.raises(grpc.aio.AioRpcError) as err:
                await ch.unary_unary("/zipkin.proto3.SpanService/Nope")(b"", timeout=CALL_S)
            assert err.value.code() == grpc.StatusCode.UNIMPLEMENTED

    _serve(Collector(InMemoryStorage()), scenario)


def test_server_config_enables_grpc():
    cfg = ServerConfig(host="127.0.0.1", port=0, storage_type="mem",
                       grpc_collector_enabled=True, grpc_port=0)
    server = ZipkinServer(cfg, storage=InMemoryStorage(), seal_interval_s=0).start()
    try:
        assert server.grpc_port and server.grpc_port == server._grpc.port
        with grpc.insecure_channel(f"127.0.0.1:{server.grpc_port}") as ch:
            assert ch.unary_unary(METHOD)(BODY, timeout=CALL_S) == b""
        assert len(server.storage.get_trace(TRACE[0].trace_id).execute()) == len(TRACE)
        assert server.metrics.get("spans", "grpc") == len(TRACE)
    finally:
        server.stop()
    assert server._transport_loop is None and server._grpc is None


def test_server_grpc_collector_gets_fast_ingest():
    """The gRPC tier's collector carries the line-rate flag, the shared
    sampler and HTTP's admission, as the reference's does."""
    class _FastStorage(InMemoryStorage):
        def ingest_json_fast(self, data, sampler):  # pragma: no cover
            raise NotImplementedError

    cfg = ServerConfig(host="127.0.0.1", port=0, storage_type="mem", tpu_fast_ingest=True,
                       grpc_collector_enabled=True, grpc_port=0)
    server = ZipkinServer(cfg, storage=_FastStorage(), seal_interval_s=0).start()
    try:
        assert server.collector.fast_ingest  # HTTP tier (sanity)
        grpc_collector = server._grpc._collector
        assert grpc_collector.fast_ingest
        assert grpc_collector.sampler is server.collector.sampler
        assert grpc_collector.overload is server.collector.overload
    finally:
        server.stop()


def test_report_backpressure_maps_to_resource_exhausted():
    """IngestBackpressure is the gRPC twin of HTTP 429: RESOURCE_EXHAUSTED."""
    class PushbackCollector(Collector):
        def accept_spans_bytes(self, data, encoding=None):
            raise IngestBackpressure("every parse-worker queue is full")

    async def scenario(port):
        async with grpc.aio.insecure_channel(f"127.0.0.1:{port}") as ch:
            with pytest.raises(grpc.aio.AioRpcError) as err:
                await ch.unary_unary(METHOD)(BODY, timeout=CALL_S)
            assert err.value.code() == grpc.StatusCode.RESOURCE_EXHAUSTED

    _serve(PushbackCollector(InMemoryStorage()), scenario)


def test_report_records_grpc_boundary_stage():
    before = obs.RECORDER.snapshot().stage("grpc_boundary").count

    async def scenario(port):
        async with grpc.aio.insecure_channel(f"127.0.0.1:{port}") as ch:
            assert await ch.unary_unary(METHOD)(BODY, timeout=CALL_S) == b""

    _serve(Collector(InMemoryStorage()), scenario)
    assert obs.RECORDER.snapshot().stage("grpc_boundary").count == before + 1


def test_report_b3_metadata_links_slow_dispatch_spans():
    """x-b3-* metadata is CURRENT_B3 for the accept; x-b3-sampled: 0
    suppresses it."""
    seen = []

    class CapturingCollector(Collector):
        def accept_spans_bytes(self, data, encoding=None):
            seen.append(CURRENT_B3.get())
            return super().accept_spans_bytes(data, encoding)

    b3 = (("x-b3-traceid", "cafecafecafecafe"), ("x-b3-spanid", "beefbeefbeefbeef"))

    async def scenario(port):
        async with grpc.aio.insecure_channel(f"127.0.0.1:{port}") as ch:
            method = ch.unary_unary(METHOD)
            await method(BODY, metadata=b3 + (("x-b3-sampled", "1"),), timeout=CALL_S)
            await method(BODY, metadata=b3 + (("x-b3-sampled", "0"),), timeout=CALL_S)
            await method(BODY, timeout=CALL_S)

    _serve(CapturingCollector(InMemoryStorage()), scenario)
    assert seen == [("cafecafecafecafe", "beefbeefbeefbeef"), None, None]


_NO_GRPC = textwrap.dedent("""
    import sys
    sys.modules["grpc"] = None  # import grpc now raises ImportError
    {body}
""")


def _run(code: str, *args: str, env=None):
    return subprocess.run([sys.executable, "-c", code, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)


def test_server_refuses_to_start_without_grpc():
    """Asked for gRPC where ``grpc`` cannot be imported, ``start()`` raises
    naming the package and binds nothing, and the entry point exits != 0
    with that message: it never boots without the transport it was asked
    for."""
    lib = _NO_GRPC.format(body=textwrap.dedent("""
        from zipkin_tpu_torch.server.app import ZipkinServer
        from zipkin_tpu_torch.server.config import ServerConfig
        from zipkin_tpu_torch.storage.memory import InMemoryStorage
        cfg = ServerConfig(host="127.0.0.1", port=0, storage_type="mem",
                           grpc_collector_enabled=True, grpc_port=0)
        server = ZipkinServer(cfg, storage=InMemoryStorage(), seal_interval_s=0)
        try:
            server.start()
        except RuntimeError as e:
            assert "grpc" in str(e), e
            assert server._httpd is None and server.port is None
            print("refused:", e)
        else:
            server.stop()
            raise SystemExit("started without grpc")
    """))
    out = _run(lib)
    assert out.returncode == 0 and "refused:" in out.stdout, out.stderr
    entry = _NO_GRPC.format(body=textwrap.dedent("""
        from zipkin_tpu_torch.server.__main__ import main
        raise SystemExit(main(["--storage", "mem", "--port", "0"]))
    """))
    env = dict(os.environ, COLLECTOR_GRPC_ENABLED="1", COLLECTOR_GRPC_PORT="0",
               TPU_ARCHIVE_DIR="off", QUERY_HOST="127.0.0.1")
    out = _run(entry, env=env)
    assert out.returncode != 0
    assert "grpc package cannot be imported" in out.stderr, out.stderr[-2000:]


def test_grpc_is_imported_only_when_asked_for():
    """The server, the UI, scribe, the transports and the test kit load
    without ``grpc``; a server without gRPC enabled never imports it."""
    code = textwrap.dedent("""
        import sys
        import zipkin_tpu_torch.collector.scribe, zipkin_tpu_torch.collector.transports
        import zipkin_tpu_torch.server.app, zipkin_tpu_torch.server.ui, zipkin_tpu_torch.testkit
        from zipkin_tpu_torch.server.app import ZipkinServer
        from zipkin_tpu_torch.server.config import ServerConfig
        s = ZipkinServer(ServerConfig(host="127.0.0.1", port=0, storage_type="mem",
                                      scribe_enabled=True, scribe_port=0),
                         seal_interval_s=0).start()
        s.stop()
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("grpc", "jax", "aiohttp", "zipkin_tpu"))
        assert not bad, bad
        print("clean")
    """)
    out = _run(code)
    assert out.returncode == 0 and "clean" in out.stdout, out.stderr[-2000:]


def test_reports_fill_the_same_device_state_as_the_references():
    """The same seeded ``Report`` bodies through the reference's
    GrpcCollectorServer into ``TpuStorage(mesh=make_mesh(1))`` and the
    port's into ``TorchStorage(device="cpu")``: integer leaves bit-equal,
    digest weights exact and means rtol 1e-5, equal counters and links."""
    import numpy as np

    from tests.fixtures import lots_of_spans
    from tests.test_torch_store import WEEK_MS, links, ref_store, small_store
    from zipkin_tpu.collector.core import Collector as RefCollector
    from zipkin_tpu.server.grpc import GrpcCollectorServer as RefGrpcServer
    from zipkin_tpu_torch.tpu.state import AggState

    spans = lots_of_spans(2000, seed=29, services=6, span_names=8)
    bodies = [ref_proto3.encode_span_list(spans[lo:lo + 250]) for lo in range(0, 2000, 250)]
    ref, port = ref_store(), small_store()
    for store in (ref, port):
        store._deps_max_stale_ms = 0.0

    async def send(port_no):
        async with grpc.aio.insecure_channel(f"127.0.0.1:{port_no}") as ch:
            for body in bodies:
                assert await ch.unary_unary(METHOD)(body, timeout=CALL_S) == b""

    async def run(server):
        await server.start()
        try:
            await asyncio.wait_for(send(server.port), CALL_S * 3)
        finally:
            await asyncio.wait_for(server.stop(), CALL_S)

    asyncio.run(run(RefGrpcServer(RefCollector(ref), host="127.0.0.1", port=0)))
    asyncio.run(run(GrpcCollectorServer(Collector(port), host="127.0.0.1", port=0)))
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

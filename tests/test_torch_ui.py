"""The port's built-in UI (``zipkin_tpu_torch/server/ui.py`` and
``server/static/``): the bundle is the reference's byte for byte; the
reference's bundle checks (``tests/test_ui_assets.py``, ``tests/test_ui_spec.py``)
run against the port's copy; and the port's ``http.server`` server answers
``/zipkin``, ``/zipkin/``, ``/zipkin/static/{name}`` and ``/config.json``
as the reference's aiohttp server does (bodies, content types, the
``Content-Security-Policy``, 404 for an unknown asset).

The reference's check classes are subclassed here and read the bundle
through their module's ``ui``, which an autouse fixture points at the
port's module; the reference's files stay as they are.
"""

from __future__ import annotations

import asyncio
import json
import os
import re
import urllib.error
import urllib.request

import pytest

import tests.torch_cpu  # noqa: F401  (one intra-op thread a test process)
import tests.test_ui_assets as ref_assets
import tests.test_ui_spec as ref_spec
from zipkin_tpu.server import ui as ref_ui
from zipkin_tpu_torch.server import ui as port_ui
from zipkin_tpu_torch.server.app import UI_CSP, ZipkinServer
from zipkin_tpu_torch.server.config import ServerConfig
from zipkin_tpu_torch.storage.memory import InMemoryStorage

ASSETS = ("index.html", "app.js", "style.css")
TIMEOUT_S = 30.0


@pytest.fixture(autouse=True)
def _port_bundle(monkeypatch):
    monkeypatch.setattr(ref_assets, "ui", port_ui)
    monkeypatch.setattr(ref_spec, "ui", port_ui)


@pytest.mark.parametrize("name", ASSETS)
def test_static_bundle_is_the_references_byte_for_byte(name):
    with open(os.path.join(ref_ui.STATIC_DIR, name), "rb") as f:
        want = f.read()
    with open(os.path.join(port_ui.STATIC_DIR, name), "rb") as f:
        assert f.read() == want
    assert port_ui.STATIC_DIR != ref_ui.STATIC_DIR  # the port's own copy
    assert port_ui.asset(name) == ref_ui.asset(name)
    assert port_ui.asset("../" + name) is None and port_ui.asset("ui.py") is None


# -- the reference's checks over the port's bundle ----------------------------


class TestPortBundleParses(ref_assets.TestBundleParses):
    pass


class TestPortEscapingDiscipline(ref_assets.TestEscapingDiscipline):
    pass


class TestPortTreeOrder(ref_spec.TestTreeOrder):
    pass


class TestPortDepGraphLayout(ref_spec.TestDepGraphLayout):
    pass


def test_mirrors_pinned_to_the_ports_app_js():
    ref_spec.test_mirrors_pinned_to_shipped_app_js()


def _served(server: ZipkinServer, path: str) -> bool:
    if path in server.get_routes:
        return True
    return path.startswith("/api/v2/trace/") or path == "/api/v2/trace"


def test_every_fetched_path_is_a_route_of_the_ports_server():
    """The reference's API-surface check over the port's route table (with
    a store that serves the sketch reads, so the TPU routes register)."""
    from zipkin_tpu_torch.tpu.state import AggConfig
    from zipkin_tpu_torch.tpu.store import TorchStorage

    js = port_ui.asset("app.js")[0].decode()
    wanted = set(re.findall(r"['\"(](/(?:api/v2|info|metrics|prometheus)[\w/]*)", js))
    assert "/api/v2/traces" in wanted and "/api/v2/dependencies" in wanted
    cfg = AggConfig(max_services=8, max_keys=16, hll_precision=4, digest_centroids=4,
                    digest_buffer=64, ring_capacity=64)
    server = ZipkinServer(ServerConfig(host="127.0.0.1", port=0),
                          storage=TorchStorage(config=cfg, device="cpu", pad_to_multiple=32),
                          seal_interval_s=0)
    try:
        posts = set(server.post_routes)
        for path in sorted(wanted):
            assert _served(server, path) or path in posts, f"app.js fetches {path}, unserved"
    finally:
        server.storage.close()


# -- the routes over the port's server, against the reference's ---------------


def _get(port: int, path: str):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=TIMEOUT_S) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


CONFIG = dict(query_limit=25, default_lookback=3_600_000, search_enabled=False,
              autocomplete_keys=("env", "region"))


def _reference_answers(paths):
    """(status, content type, CSP, body) of each path on the reference's
    aiohttp server at the same config."""
    from aiohttp.test_utils import TestClient, TestServer

    from zipkin_tpu.server.app import ZipkinServer as RefServer
    from zipkin_tpu.server.config import ServerConfig as RefConfig
    from zipkin_tpu.storage.memory import InMemoryStorage as RefMemory

    async def run():
        client = TestClient(TestServer(RefServer(RefConfig(**CONFIG), storage=RefMemory())
                                       .make_app()))
        await client.start_server()
        try:
            out = {}
            for path in paths:
                resp = await client.get(path)
                out[path] = (resp.status, resp.headers.get("Content-Type", "").split(";")[0],
                             resp.headers.get("Content-Security-Policy"), await resp.read())
            return out
        finally:
            await client.close()

    return asyncio.run(run())


def test_ui_routes_and_config_answer_as_the_references():
    paths = ["/zipkin/", "/zipkin", "/zipkin/static/index.html", "/zipkin/static/app.js",
             "/zipkin/static/style.css", "/zipkin/static/nope.js", "/config.json"]
    want = _reference_answers(paths)
    server = ZipkinServer(ServerConfig(host="127.0.0.1", port=0, storage_type="mem", **CONFIG),
                          storage=InMemoryStorage(), seal_interval_s=0).start()
    try:
        for path in paths:
            status, headers, body = _get(server.port, path)
            w_status, w_ctype, w_csp, w_body = want[path]
            assert status == w_status, path
            if status != 200:
                assert status == 404 and path.endswith("nope.js")
                continue
            assert headers.get("Content-Type", "").split(";")[0] == w_ctype, path
            assert headers.get("Content-Security-Policy") == w_csp, path
            if path == "/config.json":
                assert json.loads(body) == json.loads(w_body)
                assert json.loads(body)["queryLimit"] == 25
            else:
                assert w_csp == UI_CSP and body == w_body, path
        with open(os.path.join(port_ui.STATIC_DIR, "app.js"), "rb") as f:
            assert _get(server.port, "/zipkin/static/app.js")[2] == f.read()
    finally:
        server.stop()

"""The Lens API contract against the port's ``http.server`` server: the
reference's ``tests/test_lens_conformance.py`` (10 cases) with the literal
URL shapes zipkin-lens sends, over ``urllib``, parametrised over the
in-memory store (``mem``) and the device store (``tpu``, the port's resume
adapter on the CPU). The UI and Lens depend on these shapes.

The fixture spans are the reference's (``tests/fixtures.py`` and the
reference test's ``TAGGED`` trace), sent as the reference's JSON v2 bytes.
One server per store serves a class's read-only cases; every socket has a
deadline.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.parse
import urllib.request

import pytest

import tests.torch_cpu  # noqa: F401  (one intra-op thread a test process)
from tests.fixtures import TRACE, TRACE_ID
from tests.test_lens_conformance import DAY_MS, QUERY_TS, TAGGED, TAGGED_TRACE_ID
from zipkin_tpu.model import json_v2 as ref_json
from zipkin_tpu_torch.server.app import ZipkinServer
from zipkin_tpu_torch.server.config import ServerConfig
from zipkin_tpu_torch.tpu.state import AggConfig

SMALL = AggConfig(max_services=64, max_keys=256, hll_precision=9, digest_centroids=32,
                  ring_capacity=1 << 13)
STORAGES = ("mem", "tpu")
TIMEOUT_S = 30.0


def make_server(storage_type: str, **cfg) -> ZipkinServer:
    config = ServerConfig(host="127.0.0.1", port=0, default_lookback=DAY_MS,
                          autocomplete_keys=("env",), storage_type=storage_type, **cfg)
    storage = None
    if storage_type == "tpu":
        from zipkin_tpu_torch.storage.tpu import TorchStorage

        storage = TorchStorage(config=SMALL, device="cpu", autocomplete_keys=("env",))
    return ZipkinServer(config, storage=storage, seal_interval_s=0)


def post(server: ZipkinServer, spans) -> int:
    req = urllib.request.Request(f"http://127.0.0.1:{server.port}/api/v2/spans",
                                 data=ref_json.encode_span_list(spans),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=TIMEOUT_S) as resp:
        return resp.status


def get(server: ZipkinServer, path_qs: str):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{server.port}{path_qs}",
                                    timeout=TIMEOUT_S) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def get_json(server: ZipkinServer, path_qs: str):
    status, body = get(server, path_qs)
    assert status == 200, body
    return json.loads(body)


def trace_ids(traces_json) -> set:
    return {t[0]["traceId"] for t in traces_json}


@pytest.fixture(scope="module", params=STORAGES)
def server(request):
    s = make_server(request.param).start()
    try:
        assert post(s, TRACE + TAGGED) == 202
        yield s
    finally:
        s.stop()


class TestLensDiscoverShapes:
    """The exact /api/v2/traces?... URLs the Lens discover page emits."""

    def test_service_and_span_name(self, server):
        # Lens encodes spaces as %20 in spanName
        url = (f"/api/v2/traces?serviceName=frontend&spanName=get%20%2F"
               f"&endTs={QUERY_TS}&lookback={DAY_MS}&limit=10")
        assert trace_ids(get_json(server, url)) == {TRACE_ID}

    def test_annotation_query_tag_equals_and_bare_key(self, server):
        base = f"/api/v2/traces?serviceName=frontend&endTs={QUERY_TS}&lookback={DAY_MS}&limit=10"
        q = urllib.parse.quote("http.method=OPTIONS and env=prod")
        assert trace_ids(get_json(server, f"{base}&annotationQuery={q}")) == {TAGGED_TRACE_ID}
        # bare key form: an annotation value ("retry")
        q = urllib.parse.quote("retry")
        assert trace_ids(get_json(server, f"{base}&annotationQuery={q}")) == {TAGGED_TRACE_ID}
        # no-match compound: every clause must hold
        q = urllib.parse.quote("env=prod and http.method=GET")
        assert get_json(server, f"{base}&annotationQuery={q}") == []

    def test_min_max_duration_microseconds(self, server):
        # Lens sends durations in microseconds
        url = (f"/api/v2/traces?serviceName=frontend&minDuration=300000"
               f"&endTs={QUERY_TS}&lookback={DAY_MS}&limit=10")
        assert trace_ids(get_json(server, url)) == {TRACE_ID}  # the 350 ms root
        url = (f"/api/v2/traces?serviceName=frontend&minDuration=10000"
               f"&maxDuration=50000&endTs={QUERY_TS}&lookback={DAY_MS}&limit=10")
        assert trace_ids(get_json(server, url)) == {TAGGED_TRACE_ID}  # 42 ms + 30 ms

    def test_remote_service_name(self, server):
        url = (f"/api/v2/traces?serviceName=backend&remoteServiceName=mysql"
               f"&endTs={QUERY_TS}&lookback={DAY_MS}&limit=10")
        assert trace_ids(get_json(server, url)) == {TRACE_ID}

    def test_limit_and_ordering_newest_first(self, server):
        out = get_json(server, f"/api/v2/traces?endTs={QUERY_TS}&lookback={DAY_MS}&limit=1")
        # newest first: the TAGGED trace is newer
        assert len(out) == 1 and trace_ids(out) == {TAGGED_TRACE_ID}


class TestLensLookupAndAutocomplete:
    def test_service_span_remote_lists(self, server):
        # mysql is only ever a remote endpoint: local service names exclude it
        assert get_json(server, "/api/v2/services") == ["backend", "frontend"]
        assert get_json(server, "/api/v2/spans?serviceName=frontend") == [
            "get /", "get /api", "options /"]
        assert get_json(server, "/api/v2/remoteServices?serviceName=backend") == ["mysql"]

    def test_autocomplete_endpoints(self, server):
        assert get_json(server, "/api/v2/autocompleteKeys") == ["env"]
        assert get_json(server, "/api/v2/autocompleteValues?key=env") == ["prod", "staging"]
        # an unknown key: an empty list, not an error
        assert get_json(server, "/api/v2/autocompleteValues?key=nope") == []

    def test_dependencies_shape(self, server):
        out = get_json(server, f"/api/v2/dependencies?endTs={QUERY_TS}&lookback={DAY_MS}")
        by_pair = {(d["parent"], d["child"]): d for d in out}
        assert ("frontend", "backend") in by_pair and ("backend", "mysql") in by_pair
        assert by_pair[("backend", "mysql")]["callCount"] == 1
        # errorCount only when nonzero
        assert by_pair[("backend", "mysql")].get("errorCount") == 1
        assert "errorCount" not in by_pair[("frontend", "backend")]


class TestStrictTraceId:
    """128-bit ids are fetchable by their 64-bit suffix only with
    STRICT_TRACE_ID=false."""

    @staticmethod
    def _run(strict: bool, check) -> None:
        s = ZipkinServer(ServerConfig(host="127.0.0.1", port=0, storage_type="mem",
                                      default_lookback=DAY_MS, strict_trace_id=strict),
                         seal_interval_s=0).start()
        try:
            assert post(s, TRACE) == 202
            check(s)
        finally:
            s.stop()

    def test_lenient_matches_64bit_suffix(self):
        def check(s):
            status, body = get(s, "/api/v2/trace/0000000000000ace")
            assert status == 200
            assert {span["traceId"] for span in json.loads(body)} == {TRACE_ID}

        self._run(False, check)

    def test_strict_requires_full_id(self):
        def check(s):
            assert get(s, "/api/v2/trace/0000000000000ace")[0] == 404
            assert get(s, f"/api/v2/trace/{TRACE_ID}")[0] == 200

        self._run(True, check)

"""The port's test kit (``zipkin_tpu_torch/testkit``): the reference's
``tests/test_testkit.py`` (3 cases) against the port's ``ZipkinMock``, plus
the mid-body disconnect and the hook's absence on a normal server.

Spans cross at the wire (the reference's JSON v2 bytes); ``store_spans``
takes the port's own Span objects. Every request has a deadline.
"""

from __future__ import annotations

import http.client
import urllib.error
import urllib.request

import pytest

import tests.torch_cpu  # noqa: F401  (one intra-op thread a test process)
from tests.fixtures import TRACE
from zipkin_tpu.model import json_v2 as ref_json
from zipkin_tpu_torch.model import json_v2 as port_json
from zipkin_tpu_torch.server.app import ZipkinServer
from zipkin_tpu_torch.server.config import ServerConfig
from zipkin_tpu_torch.testkit import HttpFailure, ZipkinMock

BODY = ref_json.encode_span_list(TRACE)
TIMEOUT_S = 30.0


def _post(url: str, body: bytes) -> int:
    req = urllib.request.Request(url, data=body, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=TIMEOUT_S) as resp:
        return resp.status


class TestZipkinMock:
    def test_post_then_assert_traces(self):
        with ZipkinMock() as zipkin:
            assert _post(zipkin.http_url, BODY) == 202
            assert zipkin.http_request_count == 1
            assert zipkin.trace_count == 1
            assert len(zipkin.traces()[0]) == len(TRACE)
            assert zipkin.collector_metrics().get("spans", "http") == len(TRACE)

    def test_enqueued_failure_then_recovery(self):
        with ZipkinMock() as zipkin:
            zipkin.enqueue_failure(HttpFailure.send_error_response(503, "go away"))
            with pytest.raises(urllib.error.HTTPError) as err:
                _post(zipkin.http_url, BODY)
            assert err.value.code == 503
            assert zipkin.trace_count == 0  # the failure is consumed, nothing stored
            # the next request succeeds (FIFO consumption)
            assert _post(zipkin.http_url, BODY) == 202
            assert zipkin.trace_count == 1
            assert zipkin.http_request_count == 2

    def test_store_spans_seeds_query_api(self):
        with ZipkinMock() as zipkin:
            zipkin.store_spans(port_json.decode_span_list(BODY))
            url = f"{zipkin.base_url}/api/v2/trace/{TRACE[0].trace_id}"
            with urllib.request.urlopen(url, timeout=TIMEOUT_S) as resp:
                assert resp.status == 200
                assert b"frontend" in resp.read()


def test_disconnect_during_body_closes_without_an_answer():
    with ZipkinMock() as zipkin:
        zipkin.enqueue_failure(HttpFailure.disconnect_during_body())
        conn = http.client.HTTPConnection("127.0.0.1", zipkin.port, timeout=TIMEOUT_S)
        try:
            conn.request("POST", "/api/v2/spans", BODY, {"Content-Type": "application/json"})
            with pytest.raises((http.client.RemoteDisconnected, ConnectionError)):
                conn.getresponse()
        finally:
            conn.close()
        assert zipkin.trace_count == 0 and zipkin.http_request_count == 1
        assert _post(zipkin.http_url, BODY) == 202
        assert zipkin.trace_count == 1


def test_a_normal_server_has_no_post_hook():
    server = ZipkinServer(ServerConfig(host="127.0.0.1", port=0, storage_type="mem"),
                          seal_interval_s=0)
    assert server.post_hook is None
    server.storage.close()

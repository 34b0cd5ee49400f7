"""Two of ``chip_smoke.py``'s checks, on the CPU.

- ``counted`` holds a read to its own readpack transfers: the pulls its
  thread makes and those of a traced query on another thread (a read over
  HTTP runs on the server's request thread), never a background thread's
  pull inside the window (the windows ticker's mirror publish made phase
  f2's first dependency read count 4 once).
- ``idle_serve`` (phase l0's idle reader check) says why a reader did not
  serve: the answer's body, the reader's ``/metrics`` and the server's
  segment counters are in the failure.
- ``eval_verdict`` (phase q's verdict on the evals' subprocess) fails the
  phase on a missing config line, a config that did not pass, a non-zero
  exit, the time limit, a missing launches line, a device config that
  missed a hand kernel or a config4 without its distinct-identity gate;
  five passing lines pass it.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
import torch

import chip_smoke
import tests.torch_cpu  # noqa: F401  (one intra-op thread a test process)
from zipkin_tpu_torch import readpack
from zipkin_tpu_torch.tpu.state import AggConfig
from zipkin_tpu_torch.tpu.store import TorchStorage
from zipkin_tpu_torch.workload import generate

CFG = AggConfig(max_services=16, max_keys=64, hll_precision=6, digest_centroids=8,
                digest_buffer=1024, ring_capacity=1024, time_buckets=4)


def _background_pull():
    """A device read on another thread, outside any query (what the
    ticker's mirror publish does), finished before this returns."""
    t = threading.Thread(target=lambda: readpack.pull(readpack.pack(
        (torch.arange(8),), (np.uint32,))))
    t.start()
    t.join()


@pytest.fixture(scope="module")
def store():
    s = TorchStorage(config=CFG, device="cpu", pad_to_multiple=64)
    cols = generate(512, seed=3, services=12, names_per_service=4).cols
    s.agg.ingest(cols)
    s._deps_max_stale_ms = 0
    return s


def test_a_read_counts_its_own_transfer_beside_another_threads_pull(store):
    def read():
        store.invalidate_read_cache()
        _background_pull()
        return store.trace_cardinalities()

    est, own, by_agg = chip_smoke.counted(store.agg, read)
    assert est and own == 1 and by_agg == 1


def test_a_read_on_a_server_thread_counts_its_traced_transfer(store):
    """A read over HTTP: the pull is on the request thread, inside the
    store's query trace; a background pull in the same window is not it."""
    def over_http():
        store.invalidate_read_cache()
        out = []
        t = threading.Thread(target=lambda: out.append(store.trace_cardinalities()))
        t.start()
        t.join()
        _background_pull()
        return out[0]

    est, own, _ = chip_smoke.counted(store.agg, over_http)
    assert est and own == 1


class _Reader(BaseHTTPRequestHandler):
    answers = {}

    def do_GET(self):  # noqa: N802 (http.server's name)
        status, headers, body = self.answers[self.path]
        self.send_response(status)
        for k, v in headers.items():
            self.send_header(k, v)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *_a):
        pass


class _Core:
    def ingest_counters(self):
        return {"segmentPublishes": 7, "segmentRestamps": 0, "segmentOversizedKeys": 1,
                "mirrorServes": 3, "spans": 512, "querySegments": {"x": 1}}


@pytest.fixture
def reader():
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _Reader)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield httpd, f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    httpd.server_close()


def test_an_idle_reader_that_does_not_serve_says_why(reader):
    _, base = reader
    _Reader.answers = {
        "/api/v2/tpu/cardinalities": (503, {"Retry-After": "1"},
                                      b"epoch age 2407.3ms exceeds bound 1500.0ms"),
        "/metrics": (200, {"Content-Type": "application/json"},
                     json.dumps({"readerGeneration": 4, "readerErrors": 2}).encode()),
    }
    with pytest.raises(AssertionError) as e:
        chip_smoke.idle_serve(base, "/api/v2/tpu/cardinalities", _Core(), 1500.0)
    msg = str(e.value)
    assert "503" in msg and "exceeds bound 1500.0ms" in msg
    assert '"readerErrors": 2' in msg
    assert '"segmentRestamps": 0' in msg and '"segmentPublishes": 7' in msg
    assert "spans" not in msg and "querySegments" not in msg


def test_an_idle_reader_that_serves_within_the_bound_passes(reader):
    _, base = reader
    _Reader.answers = {"/api/v2/tpu/cardinalities": (200, {"X-Staleness-Ms": "812.5"}, b"{}")}
    assert chip_smoke.idle_serve(base, "/api/v2/tpu/cardinalities", _Core(), 1500.0) == (200, 812.5)
    _Reader.answers["/api/v2/tpu/cardinalities"] = (200, {"X-Staleness-Ms": "1600"}, b"{}")
    _Reader.answers["/metrics"] = (200, {}, b"{}")
    with pytest.raises(AssertionError, match="answered 200 1600"):
        chip_smoke.idle_serve(base, "/api/v2/tpu/cardinalities", _Core(), 1500.0)


def _eval_lines(**override) -> dict:
    """Five passing config lines and the launches line, as the evals print
    them (``override`` replaces a config's line, None drops it)."""
    step = {"hll_update": 0, "hll_update_step": 16, "ring_append": 16, "link_chase": 8}
    lines = {c: {"config": c, "passed": True} for c in chip_smoke.EVAL_CONFIGS}
    lines["config4"].update(fast_path=True, distinct_identity_gate={"passed": True},
                            query_program_device_ms={"spmd_card": 0.1})
    lines.update(override)
    launches = {c: dict(step) for c in chip_smoke.EVAL_CONFIGS}
    launches["config0"] = dict.fromkeys(step, 0)
    out = ["{\"progress\": 1}", "not json"] + [json.dumps(v) for v in lines.values() if v is not None]
    return {"out": "\n".join(out + [json.dumps({"launches": launches})]), "launches": launches}


def test_five_passing_eval_lines_pass_phase_q():
    run = _eval_lines()
    fig = chip_smoke.eval_verdict(run["out"], 0, False)
    assert sorted(fig["configs"]) == list(chip_smoke.EVAL_CONFIGS)
    assert fig["launches"] == run["launches"]


@pytest.mark.parametrize("case", ["missing", "not_passed", "exit", "timeout", "no_launches",
                                  "no_identity_gate"])
def test_phase_q_fails_on_a_bad_run(case):
    run = _eval_lines(**{"missing": {"config2": None},
                         "not_passed": {"config3": {"config": "config3", "passed": False}},
                         "no_identity_gate": {"config4": {"config": "config4", "passed": True,
                                                          "fast_path": True,
                                                          "distinct_identity_gate": None}},
                         }.get(case, {}))
    out = run["out"]
    if case == "no_launches":
        out = out.rsplit("\n", 1)[0]
    with pytest.raises(AssertionError, match="phase q"):
        chip_smoke.eval_verdict(out, 1 if case == "exit" else 0, case == "timeout")


def test_phase_q_on_a_card_needs_each_device_config_to_launch_its_kernels():
    run = _eval_lines()
    run["launches"]["config2"]["link_chase"] = 0
    out = run["out"].rsplit("\n", 1)[0] + "\n" + json.dumps({"launches": run["launches"]})
    with pytest.raises(AssertionError, match="config2"):
        chip_smoke.eval_verdict(out, 0, False)

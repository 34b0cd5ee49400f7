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
- ``gate_verdict`` (phase q2's verdict on configs 5-9) passes five passing
  lines, and config5 missing only the reference's absolute rate with exit
  code 1; it fails a config of 6-9 that did not pass, config5 failing any
  other of its own gates (an answer neither 202 nor a counted 429, a
  detached WAL, a recompile) or missing one, spans short of the target,
  an exit code that disagrees with config5's rate gate, a missed or
  unequal launch, a missing line and the time limit.
- ``resume_verdict`` and ``durable_verdict`` (phase q3's) pass a resume run
  with restores and fail one with none, with cumulative spans short of the
  target, a failed or missing distinct-identity gate, a recompile, a boot
  that lost the previous window's count, no chase, a bad exit or the time
  limit; and a durable run with fewer than 2 snapshots, no durability,
  not passed or no chase.
- ``busy_ms`` and ``kernel_ms`` (the profiler's timings) take a trace that
  saw no device time again, and after three such traces time the calls on
  CUDA events instead and keep the miss in ``PROFILER_MISSES``; a trace
  that sees the device is taken as it is.
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


GATES = dict.fromkeys(chip_smoke.CONFIG5_GATES, True)  # config5's gates, all held


def _gate_lines(**override) -> dict:
    """Five passing lines of configs 5-9 and the launches line, as the
    evals print them (``override`` replaces a config's line, None drops
    it)."""
    step = {"hll_update": 0, "hll_update_step": 4, "ring_append": 4, "link_chase": 2}
    lines = {c: {"config": c, "passed": True} for c in chip_smoke.GATE_CONFIGS}
    lines["config5"].update(
        wire_to_ack_spans_per_sec={"fanout_w4": 1_200_000.0}, target_spans_per_sec=1e6,
        inprocess_proto3_spans_per_sec=500_000.0, spans_posted=chip_smoke.GATE_FANOUT_SPANS,
        sampling="~50% hash drop", wal="attached", responses={"202": 16, "429": 3},
        recompiles_in_window={"inprocess": 0, "fanout_w4": 0}, gates=GATES)
    for name, line in override.items():
        if line is None:
            lines[name] = None
        else:
            lines[name] = {**lines[name], **line}
    launches = {c: dict(step) for c in chip_smoke.GATE_CONFIGS}
    launches["total"] = {k: 5 * v for k, v in step.items()}
    out = ["{\"progress\": 1}", "not json"] + [json.dumps(v) for v in lines.values() if v is not None]
    return {"out": "\n".join(out + [json.dumps({"launches": launches})]), "launches": launches}


def test_five_passing_gate_lines_pass_phase_q2():
    run = _gate_lines()
    fig = chip_smoke.gate_verdict(run["out"], 0, False)
    assert sorted(fig["configs"]) == list(chip_smoke.GATE_CONFIGS)
    assert fig["launches"] == run["launches"] and fig["config5_rate_passed"]


def test_config5_missing_only_its_rate_passes_phase_q2_with_the_rate_logged():
    run = _gate_lines(config5={"passed": False, "wire_to_ack_spans_per_sec": {"fanout_w4": 5e5},
                               "gates": {**GATES, "rate": False}})
    fig = chip_smoke.gate_verdict(run["out"], 1, False)
    assert fig["config5_rate_passed"] is False
    assert fig["configs"]["config5"]["wire_to_ack_spans_per_sec"] == {"fanout_w4": 5e5}


@pytest.mark.parametrize("case", [
    "config6_failed", "config7_failed", "config8_failed", "config9_failed", "missing",
    "non_202", "wal_detached", "short_post", "recompiled", "no_gates", "rate_only_but_exit_0",
    "exit_1_with_all_passed", "missed_launch", "unequal_launches", "timeout", "no_launches"])
def test_phase_q2_fails_on_a_bad_run(case):
    override = {
        "config6_failed": {"config6": {"passed": False}},
        "config7_failed": {"config7": {"passed": False}},
        "config8_failed": {"config8": {"passed": False}},
        "config9_failed": {"config9": {"passed": False}},
        "missing": {"config8": None},
        "non_202": {"config5": {"passed": False, "responses": {"202": 15, "429": 3, "500": 1},
                                "gates": {**GATES, "responses": False}}},
        "wal_detached": {"config5": {"passed": False, "wal": "detached",
                                     "gates": {**GATES, "wal_attached": False}}},
        "short_post": {"config5": {"spans_posted": chip_smoke.GATE_FANOUT_SPANS - 65_536}},
        "recompiled": {"config5": {"passed": False,
                                   "recompiles_in_window": {"inprocess": 0, "fanout_w4": 1},
                                   "gates": {**GATES, "no_recompiles": False}}},
        "no_gates": {"config5": {"gates": {"rate": True}}},
        "rate_only_but_exit_0": {"config5": {"passed": False, "gates": {**GATES, "rate": False}}},
    }.get(case, {})
    run = _gate_lines(**override)
    out, rc = run["out"], 1 if case == "exit_1_with_all_passed" else 0
    if case in ("missed_launch", "unequal_launches"):
        run["launches"]["config7"]["hll_update_step"] = 0 if case == "missed_launch" else 5
        out = out.rsplit("\n", 1)[0] + "\n" + json.dumps({"launches": run["launches"]})
    if case == "no_launches":
        out = out.rsplit("\n", 1)[0]
    with pytest.raises(AssertionError, match="phase q2"):
        chip_smoke.gate_verdict(out, rc, case == "timeout")


def _resume_run(restores: int = 1, spans: int = chip_smoke.RESUME_SPANS, **final) -> str:
    """The resume driver's output: one tripped window a restore, a final
    window with ``final`` over a passing line, its launches and the
    driver's line."""
    out, spans_at = [], 0
    for w in range(1, restores + 1):
        spans_at += 1_000_000
        cursor = {"next_batch": 10 * w, "distinct_traces": 300_000 * w, "windows": w,
                  "spans": spans_at}
        out.append({"config": "config4", "window": w, "window_exit": 75, "recompiles_in_window": 0,
                    "resumed_from_spans": spans_at - 1_000_000 if w > 1 else 0,
                    "restore": {"restoreMs": 2000.0} if w > 1 else {"restoreMs": 0.1},
                    "cursor": cursor})
    w = restores + 1
    cursor = {"next_batch": 64, "distinct_traces": 1_400_000, "windows": w, "spans": spans}
    last = {"config": "config4", "passed": True, "window": w, "recompiles_in_window": 0,
            "resumed_from_spans": spans_at, "restore": {"restoreMs": 2500.0}, "cursor": cursor,
            "distinct_identity_gate": {"distinct_trace_ids": 1_420_000, "passed": True}}
    last.update(final)
    out.append(last)
    out.append({"launches": {"config4": {"hll_update": 0, "hll_update_step": 27,
                                         "ring_append": 27, "link_chase": 21}}})
    out.append({"artifact": "config4_resume_driver", "completed": True, "windows": w,
                "restores": restores, "cumulative_spans": spans, "distinct_trace_ids": 1_400_000,
                "passed": restores >= 1})
    return "\n".join(json.dumps(d) for d in out)


def test_a_resume_run_with_a_restore_passes_phase_q3():
    fig = chip_smoke.resume_verdict(_resume_run(restores=2), 0, False)
    assert [w["window"] for w in fig["windows"]] == [1, 2, 3]
    assert fig["driver"]["restores"] == 2 and fig["launches"]["config4"]["link_chase"] == 21


@pytest.mark.parametrize("case", ["no_restore", "short", "gate_failed", "no_gate", "recompiled",
                                  "lost_count", "no_chase", "exit", "timeout"])
def test_phase_q3_fails_on_a_bad_resume_run(case):
    out = {
        "no_restore": lambda: _resume_run(restores=0),
        "short": lambda: _resume_run(spans=chip_smoke.RESUME_SPANS - 65_536),
        "gate_failed": lambda: _resume_run(distinct_identity_gate={"passed": False}),
        "no_gate": lambda: _resume_run(distinct_identity_gate=None),
        "recompiled": lambda: _resume_run(recompiles_in_window=2),
        "lost_count": lambda: _resume_run(resumed_from_spans=999_999),
    }.get(case, _resume_run)()
    if case == "no_chase":
        out = out.replace('"link_chase": 21', '"link_chase": 0')
    with pytest.raises(AssertionError, match="phase q3"):
        chip_smoke.resume_verdict(out, 2 if case == "exit" else 0, case == "timeout")


def test_phase_q3_holds_the_durable_run_to_its_snapshots_and_launches():
    line = {"config": "config4", "passed": True, "durability": {"snapshots_taken": 2}}
    launches = {"launches": {"config4": {"hll_update": 0, "hll_update_step": 31, "ring_append": 31,
                                         "link_chase": 23}}}
    out = json.dumps(line) + "\n" + json.dumps(launches)
    assert chip_smoke.durable_verdict(out, 0, False)["line"] == line
    for bad in ({**line, "durability": {"snapshots_taken": 1}}, {**line, "durability": None},
                {**line, "passed": False}):
        with pytest.raises(AssertionError, match="phase q3"):
            chip_smoke.durable_verdict(json.dumps(bad) + "\n" + json.dumps(launches), 0, False)
    with pytest.raises(AssertionError, match="phase q3"):
        chip_smoke.durable_verdict(out.replace('"link_chase": 23', '"link_chase": 0'), 0, False)


def _profiles(*traces):
    """A stand-in ``device_profile`` that returns ``traces`` in turn (busy
    ms, rows, wall ms), counting the calls."""
    calls = []

    def profile(fn, iters, torch_, warm=True):
        calls.append(iters)
        return traces[len(calls) - 1]

    return profile, calls


@pytest.mark.parametrize("empty", [1, 2, 3])
def test_the_profiler_timings_retake_an_empty_trace_then_fall_back_to_cuda_events(monkeypatch, empty):
    seen = (0.25, [("ring_append_kernel", 0.2), ("Memset", 0.05)], 1.0)
    profile, calls = _profiles(*([(0.0, [], 1.0)] * empty + [seen]))
    monkeypatch.setattr(chip_smoke, "device_profile", profile)
    monkeypatch.setattr(chip_smoke, "cuda_ms", lambda fn, iters, torch_: 0.75)
    monkeypatch.setattr(chip_smoke, "PROFILER_MISSES", [])
    resets = []
    busy, rows = chip_smoke.busy_ms(None, 20, torch, reset=lambda: resets.append(1))
    if empty < 3:
        assert (busy, rows) == (0.25, seen[1]) and len(calls) == empty + 1
        assert chip_smoke.PROFILER_MISSES == []
    else:
        assert (busy, rows) == (0.75, []) and len(calls) == 3 and len(resets) == 4
        assert chip_smoke.PROFILER_MISSES == ["device busy 0.750000 ms a call on CUDA events"]

    profile, calls = _profiles(*([(0.05, [("Memset", 0.05)], 1.0)] * empty + [seen]))
    monkeypatch.setattr(chip_smoke, "device_profile", profile)
    monkeypatch.setattr(chip_smoke, "PROFILER_MISSES", [])
    got = chip_smoke.kernel_ms(None, 20, torch, "ring_append", 0.3)
    if empty < 3:
        assert got == (0.2, "profiler") and chip_smoke.PROFILER_MISSES == []
    else:
        assert got == (0.3, "graph replay") and len(calls) == 3
        assert chip_smoke.PROFILER_MISSES == [
            "ring_append 0.300000 ms a call from a graph replay on CUDA events"]

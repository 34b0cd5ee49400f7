"""The port's gate configs 5-7 (``zipkin_tpu_torch.evals.run_configs``)
against the reference's ``evals/run_configs.py``, on the CPU.

- config5's proto3 payloads and config7's spans encode to the same bytes
  as the reference's formulas, rebuilt here from its lines on the JAX
  package's model.
- config6 and config7 pass at the reference's settings (a 0.25 s tick,
  windows of 2 s and 4 s, the 50 ms and 0.20 limits, the C=4 digest), each
  line a superset of the reference's keys (its ``_emit`` keywords and the
  keys of the result it spreads into them).
- config5 at a small ``EVAL_FANOUT_SPANS`` and a small ``AggConfig`` holds
  every gate but the absolute rate (a CPU says nothing of the card's
  rate): only 202s and retried 429s, the spans posted, sampling armed at
  half rate, the WAL attached, 0 recompiles in its windows.
- ``wire.drive`` retries a 429 (over HTTP) or ``RESOURCE_EXHAUSTED`` (over
  gRPC, through ``wire.GrpcCollector``) after its pause and counts it, and
  tallies an answer that is neither.
"""

from __future__ import annotations

import ast
import json
import random
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

import tests.torch_cpu  # noqa: F401  (one intra-op thread a test process)
from tests import fixtures as jfixtures
from tests.test_torch_evals import ROOT, reference_keys
from zipkin_tpu.model import json_v2 as jjson
from zipkin_tpu.model import proto3 as jproto3
from zipkin_tpu.model.span import Endpoint as JEndpoint
from zipkin_tpu.model.span import Kind as JKind
from zipkin_tpu.model.span import Span as JSpan
from zipkin_tpu_torch.evals import fixtures, wire
from zipkin_tpu_torch.evals import run_configs as rc
from zipkin_tpu_torch.model import json_v2
from zipkin_tpu_torch.tpu.state import AggConfig

FANOUT_CFG = AggConfig(max_services=64, max_keys=512, hll_precision=8, digest_centroids=16,
                       digest_buffer=1 << 15, ring_capacity=1 << 15)


def last_line(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def emitted_keys(config: str) -> set:
    """The keys of the reference's line for ``config``: its ``_emit``
    keywords and, where it spreads a result dict (``**r``), the string keys
    of the dicts its ``scenario`` returns."""
    keys = reference_keys(config) - {None}
    tree = ast.parse((ROOT / "evals" / "run_configs.py").read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == config)
    for node in ast.walk(fn):
        if isinstance(node, ast.Return) and isinstance(node.value, ast.Dict):
            keys |= {k.value for k in node.value.keys if isinstance(k, ast.Constant)}
    return keys


# --- generators, byte for byte ------------------------------------------------

@pytest.mark.parametrize("batch", [1024, 4096])
def test_fanout_payloads_match_the_reference(batch):
    spans = jfixtures.lots_of_spans(2 * batch, seed=7, services=40, span_names=120)
    want = [jproto3.encode_span_list(spans[i: i + batch]) for i in range(0, len(spans), batch)]
    assert fixtures.fanout_payloads(batch) == want


def ref_make_spans(durs, seq0: int, ts: int):
    """The reference's config7 ``make_spans`` (evals/run_configs.py
    config7) from sequence number ``seq0`` at ``ts``, on the JAX model."""
    ep = JEndpoint.create("checkout", "10.0.0.7")
    seq = [seq0]
    out = []
    for d in durs:
        seq[0] += 1
        out.append(JSpan.create(
            trace_id=f"{seq[0]:016x}", id=f"{seq[0]:016x}", name="charge", kind=JKind.SERVER,
            local_endpoint=ep, timestamp=ts + seq[0], duration=int(d)))
    return out


@pytest.mark.parametrize("seq0", [0, 2064, 6064])
def test_drift_spans_match_the_reference(seq0):
    rng = random.Random(23)
    durs = [rng.gauss(1000, 40) for _ in range(300)] + \
        [100_000 if rng.random() < 0.10 else 1000 for _ in range(300)]
    ts = 1_790_000_000_000_000
    assert json_v2.encode_span_list(fixtures.drift_spans(durs, seq0, ts)) == \
        jjson.encode_span_list(ref_make_spans(durs, seq0, ts))


# --- configs 6 and 7 at the reference's settings --------------------------------

@pytest.mark.parametrize("name", ["config6", "config7"])
def test_watchdog_configs_pass_at_the_reference_settings(name, capsys):
    capsys.readouterr()
    assert rc.ALL[name]("cpu")
    line = last_line(capsys)
    assert line["config"] == name and line["passed"] is True
    assert emitted_keys(name) <= set(line), emitted_keys(name) - set(line)
    assert (line["short_s"], line["long_s"]) == (2.0, 4.0)
    assert line["healthy_baseline"] and line["trips"] >= 1 and line["clears"] >= 1
    assert line["tripped_after_s"] <= line["long_s"] + 1.0 and line["alert_on_prometheus"]
    if name == "config7":
        assert line["healthy_drift"] < 0.20 < line["drift_seen"]
        assert line["digest_centroids"] == 4


# --- config5's gates but the rate -------------------------------------------------

def test_config5_holds_every_gate_but_the_rate_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setenv("EVAL_FANOUT_SPANS", str(2 * rc.BATCH))
    capsys.readouterr()
    ok = rc.config5("cpu", FANOUT_CFG)
    line = last_line(capsys)
    assert line["config"] == "config5" and line["passed"] is ok
    assert emitted_keys("config5") <= set(line), emitted_keys("config5") - set(line)
    assert line["spans_posted"] == 2 * rc.BATCH
    assert (line["sampling"], line["wal"]) == ("~50% hash drop", "attached")
    assert set(line["responses"]) <= {"202", "429"} and line["responses"]["202"] == 2
    assert line["responses"].get("429", 0) == line["backpressure"]
    assert line["recompiles_in_window"] and not any(line["recompiles_in_window"].values())
    assert line["target_spans_per_sec"] == 1_000_000.0
    assert {k for k, v in line["gates"].items() if not v} <= {"rate"}
    assert ok is line["gates"]["rate"]


# --- the wire driver ----------------------------------------------------------

class _Answers(BaseHTTPRequestHandler):
    script: list = []
    seen: list = []

    def log_message(self, *a):
        pass

    def do_POST(self):
        self.rfile.read(int(self.headers["Content-Length"]))
        with _Answers.lock:
            status = _Answers.script.pop(0) if _Answers.script else 202
            _Answers.seen.append(status)
        self.send_response(status)
        self.send_header("Content-Length", "0")
        self.end_headers()


_Answers.lock = threading.Lock()


@pytest.fixture
def answers():
    srv = ThreadingHTTPServer(("127.0.0.1", 0), _Answers)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        yield srv.server_address[1]
    finally:
        srv.shutdown()
        srv.server_close()


def test_drive_retries_backpressure_and_tallies_other_answers(answers):
    _Answers.script, _Answers.seen = [429, 429, 202, 202, 500], []
    stats = {}
    elapsed = wire.drive(answers, "proto3", [b"a", b"b"], 10, 50, stats)
    assert elapsed > 0
    # 5 payloads: two backpressured and retried, one answered 500 and dropped
    assert stats["backpressure"] == 2
    assert stats["responses"] == {"429": 2, "202": 4, "500": 1}
    assert len(_Answers.seen) == 7
    with pytest.raises(ValueError, match="wire format"):
        wire.drive(answers, "thrift", [b"a"], 1, 1)


class _Refusing:
    """A collector that refuses its first ``refusals`` payloads (the gRPC
    server answers ``RESOURCE_EXHAUSTED``) and takes the rest."""

    overload = None

    def __init__(self, refusals: int) -> None:
        self.refusals, self.taken = refusals, []
        self.lock = threading.Lock()

    def accept_spans_bytes(self, data, encoding):
        with self.lock:
            if self.refusals:
                self.refusals -= 1
                raise RuntimeError("queue full")
            self.taken.append(data)


def test_drive_over_grpc_retries_resource_exhausted():
    collector = _Refusing(2)
    with wire.GrpcCollector(collector) as srv:
        stats = {}
        wire.drive(srv.port, "grpc", [b"", b""], 4, 12, stats)
        assert stats == {"backpressure": 2, "responses": {"RESOURCE_EXHAUSTED": 2, "OK": 3}}
        assert len(collector.taken) == 3
        assert wire.report(srv.port, b"") == ("OK", {})

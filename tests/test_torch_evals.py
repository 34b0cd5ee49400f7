"""The port's BASELINE evals (``zipkin_tpu_torch.evals``) against the
reference's ``evals/run_configs.py`` and the JAX package, on the CPU.

- Each corpus generator equals the reference's bit for bit at several
  offsets: ``_dur_of`` and ``_link_corpus_batch`` imported from the
  reference, config3's and config4's closures rebuilt here from the
  reference's own lines.
- The port's fixtures encode to the same JSON v2 bytes as
  ``tests/fixtures.py``'s.
- Configs 1-3 pass at a small ``AggConfig`` and a few batches, and their
  planes equal a one-shard ``ShardedAggregator``'s fed the reference's
  corpus: HLL registers, histograms, counters and link matrices bit for
  bit, HLL estimates within 1e-6 (a float32 harmonic sum in another
  order), digest p50/p99 ranks within 0.002 of the reference's. Each config's JSON line carries the reference's keys.
- config4 with ``EVAL_SMALL`` and config0 pass; a corrupted link truth
  fails config2; the CLI refuses to start without a card unless given
  ``--device cpu``, and refuses a config it does not know. (Configs 5-9
  and config4's durable and resume modes are in
  ``tests/test_torch_evals_{gates,flood,resume}.py``.)
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import tests.torch_cpu  # noqa: F401  (one intra-op thread a test process)
import evals.run_configs as ref
import jax.numpy as jnp
from tests import fixtures as jfixtures
from zipkin_tpu.model import json_v2 as jjson
from zipkin_tpu.ops import tdigest as jtdigest
from zipkin_tpu.parallel.mesh import make_mesh
from zipkin_tpu.parallel.sharded import ShardedAggregator
from zipkin_tpu.tpu import columnar as jcol
from zipkin_tpu.tpu.state import AggConfig as JConfig
from zipkin_tpu_torch.evals import fixtures
from zipkin_tpu_torch.evals import run_configs as rc
from zipkin_tpu_torch.model import json_v2
from zipkin_tpu_torch.parallel.aggregator import TorchAggregator
from zipkin_tpu_torch.tpu.state import AggConfig

ROOT = pathlib.Path(__file__).resolve().parent.parent
JCFG = JConfig(max_services=64, max_keys=256, hll_precision=10, digest_centroids=32,
               digest_buffer=1 << 13, ring_capacity=1 << 13)
CFG = AggConfig(**dataclasses.asdict(JCFG))
BATCH = min(rc.BATCH, CFG.digest_buffer, CFG.rollup_segment)  # the port's batch at CFG
SPANS = {"config1": 60_000, "config2": 40_000, "config3": 4 * BATCH}


def assert_columns_equal(port, want, what: str) -> None:
    assert port._fields == want._fields
    for name, a, b in zip(port._fields, port, want):
        assert a.dtype == b.dtype, (what, name)
        np.testing.assert_array_equal(a, b, err_msg=f"{what} {name}")


# --- generators, bit for bit ------------------------------------------------

@pytest.mark.parametrize("lo", [0, 12_345, 1 << 20, (1 << 32) - 70_000])
def test_dur_of_matches_reference(lo):
    i = np.arange(lo, lo + 65_536, dtype=np.uint32)
    k = i % np.uint32(200)
    got, want = rc._dur_of(k, i // np.uint32(200)), ref._dur_of(k, i // np.uint32(200))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("lo_pair,n_pairs,pad", [(0, 32_768, 32_768), (4_999_000, 1_000, 32_768),
                                                 (77, 300, 0)])
def test_link_corpus_batch_matches_reference(lo_pair, n_pairs, pad):
    ts_min = int(fixtures.TODAY_US // 60_000_000)
    cols, truth = rc._link_corpus_batch(lo_pair, n_pairs, 30, ts_min, pad_pairs=pad)
    jcols, jtruth = ref._link_corpus_batch(lo_pair, n_pairs, 30, ts_min, pad_pairs=pad)
    assert_columns_equal(cols, jcols, f"pairs from {lo_pair}")
    for a, b in zip(truth, jtruth):
        np.testing.assert_array_equal(a, b)


def ref_hll_cols_at(batch: int, n_services: int):
    """The reference's config3 ``cols_at`` closure (evals/run_configs.py
    config3), on the JAX package's columns."""
    u0 = np.zeros(batch, np.uint32)
    hi32 = jcol._hash2_np(u0, u0)
    valid = np.ones(batch, bool)
    zi32 = np.zeros(batch, np.int32)
    zb = np.zeros(batch, bool)
    lane = np.arange(batch, dtype=np.uint64)

    def cols_at(done: int):
        i64 = np.uint64(done + 1) + lane
        tl0 = (i64 & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        tl1 = (i64 >> np.uint64(32)).astype(np.uint32)
        svc = (i64 % np.uint64(n_services)).astype(np.int32) + 1
        return jcol.SpanColumns(
            trace_h=jcol._hash2_np(jcol._hash2_np(tl0, tl1), hi32),
            tl0=tl0, tl1=tl1, s0=tl0, s1=u0, p0=u0, p1=u0,
            shared=zb, kind=zi32, svc=svc, rsvc=zi32,
            key=(i64 % np.uint64(200)).astype(np.int32) + 1,
            err=zb, dur=(tl0 % np.uint32(10_000)) + np.uint32(1),
            has_dur=valid, ts_min=np.full(batch, 29_000_000, np.uint32),
            valid=valid,
        )

    return cols_at


@pytest.mark.parametrize("done", [0, 65_536, 99_942_400, (1 << 32) - 1_000, 5 << 32])
def test_hll_corpus_matches_reference(done):
    assert_columns_equal(rc._hll_corpus(65_536, 32)(done), ref_hll_cols_at(65_536, 32)(done),
                         f"ids from {done + 1}")


def ref_replay_corpus(batch: int, rotate_every: int):
    """The reference's config4 template and ``patched`` (evals/run_configs.py
    config4), on the JAX package's spans."""
    template = []
    for s in jfixtures.lots_of_spans(batch, seed=400, services=40, span_names=80):
        ep = dataclasses.replace(s.local_endpoint, service_name=s.local_service_name + "-roto0000")
        rep = (dataclasses.replace(s.remote_endpoint,
                                   service_name=s.remote_service_name + "-roto0000")
               if s.remote_endpoint is not None else None)
        template.append(dataclasses.replace(
            s, trace_id="feedface" + s.trace_id[8:], name=(s.name or "op") + "-roto0000",
            local_endpoint=ep, remote_endpoint=rep))
    payload_t = jjson.encode_span_list(template)
    probe_tid_t = template[0].trace_id

    def patched(it: int):
        tag = f"{0x10000000 + it:08x}".encode()
        rot = f"rt{it // rotate_every:06x}".encode()
        return (payload_t.replace(b"feedface", tag).replace(b"roto0000", rot),
                probe_tid_t.replace("feedface", tag.decode()))

    return template, payload_t, patched


def test_replay_corpus_matches_reference():
    corpus = rc._replay_corpus(2048, 3)
    template, payload_t, patched = ref_replay_corpus(2048, 3)
    assert corpus["payload"] == payload_t
    for it in (0, 1, 2, 3, 7, 1000, 0x0FFFFFFF):
        assert corpus["patched"](it) == patched(it), it
    assert corpus["distinct_per_batch"] == len({s.trace_id for s in template})
    assert corpus["probe_n"] == sum(1 for s in template if s.trace_id == template[0].trace_id)
    assert corpus["sel_service"] == template[0].local_service_name.replace("roto0000", "rt000000")


# --- fixtures ---------------------------------------------------------------

def test_fixtures_encode_like_the_reference():
    assert (fixtures.TODAY, fixtures.TODAY_US) == (jfixtures.TODAY, jfixtures.TODAY_US)
    assert json_v2.encode_span_list(fixtures.TRACE) == jjson.encode_span_list(jfixtures.TRACE)
    for kw in (dict(seed=0), dict(seed=400, services=40, span_names=80), dict(seed=7, services=3)):
        assert json_v2.encode_span_list(fixtures.lots_of_spans(700, **kw)) == \
            jjson.encode_span_list(jfixtures.lots_of_spans(700, **kw)), kw


# --- configs 1-3 against the reference's planes -------------------------------

def reference_keys(config: str) -> set:
    """The keys of the reference's ``_emit(config=...)`` line for ``config``."""
    tree = ast.parse((ROOT / "evals" / "run_configs.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(node.func, "id", None) == "_emit":
            kw = {k.arg: k.value for k in node.keywords}
            if isinstance(kw.get("config"), ast.Constant) and kw["config"].value == config:
                return set(kw)
    raise AssertionError(f"no _emit line for {config}")


def run_port(name: str, monkeypatch, capsys):
    """Run the port's ``name`` on the CPU at CFG; (passed, its JSON line,
    its aggregator)."""
    made = []

    class Kept(TorchAggregator):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(rc, "TorchAggregator", Kept)
    monkeypatch.setenv({"config1": "EVAL_SPANS", "config2": "EVAL_LINK_SPANS",
                        "config3": "EVAL_HLL"}[name], str(SPANS[name]))
    capsys.readouterr()
    ok = rc.ALL[name]("cpu", CFG)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["config"] == name and line["passed"] is ok
    assert reference_keys(name) <= set(line), reference_keys(name) - set(line)
    (agg,) = made
    return ok, line, agg


def ref_aggregator(batches) -> ShardedAggregator:
    agg = ShardedAggregator(JCFG, mesh=make_mesh(1))
    for cols in batches:
        agg.ingest(cols)
    agg.block_until_ready()
    return agg


def assert_planes_equal(port: TorchAggregator, want: ShardedAggregator) -> None:
    for name, a, b in zip(("hist", "hll", "counters"), port.merged_sketches(), want.merged_sketches()):
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    # equal registers; the estimate's float32 harmonic sum runs in another
    # order than XLA's (one ulp)
    np.testing.assert_allclose(port.cardinalities(), want.cardinalities(), rtol=1e-6)


def test_config1_passes_and_its_planes_match_the_reference(monkeypatch, capsys):
    ok, line, agg = run_port("config1", monkeypatch, capsys)
    assert ok and line["keys_checked"] == 200 and line["recompiles_in_window"] == 0
    # the reference's corpus and vocab ids (evals/run_configs.py config1)
    vocab = jcol.Vocab(JCFG.max_services, JCFG.max_keys)
    for s in range(10):
        vocab.services.intern(f"svc{s:02d}")
    kid_of = np.array([vocab.key_id(k % 10 + 1, vocab.span_names.intern(f"op{k:03d}"))
                       for k in range(200)], np.int32)

    def batches(total):
        for done in range(0, total, BATCH):
            i = np.arange(done, done + BATCH, dtype=np.uint32)
            k = i % np.uint32(200)
            valid = np.arange(BATCH) < min(BATCH, total - done)
            u0 = np.zeros(BATCH, np.uint32)
            yield jcol.SpanColumns(
                trace_h=jcol._hash2_np(i + np.uint32(1), u0), tl0=i + np.uint32(1), tl1=u0,
                s0=i + np.uint32(1), s1=u0, p0=u0, p1=u0, shared=np.zeros(BATCH, bool),
                kind=np.zeros(BATCH, np.int32), svc=(k.astype(np.int32) % 10) + 1,
                rsvc=np.zeros(BATCH, np.int32), key=kid_of[k], err=np.zeros(BATCH, bool),
                dur=ref._dur_of(k, i // np.uint32(200)), has_dur=valid,
                ts_min=np.full(BATCH, 29_000_000, np.uint32), valid=valid)

    want = ref_aggregator(batches(SPANS["config1"]))
    assert_planes_equal(agg, want)
    qs = np.array([0.5, 0.99], np.float32)
    got, _ = agg.quantiles(qs, source="digest")  # the read config1 gates
    exp = np.asarray(jtdigest.quantile(jnp.asarray(want.merged_digest()), jnp.asarray(qs)))
    n_k = SPANS["config1"] // 200
    for k in range(200):
        d = np.sort(ref._dur_of(np.full(n_k, k, np.uint32), np.arange(n_k)).astype(np.float64))
        for j in range(2):
            rank = lambda v: np.searchsorted(d, float(v)) / n_k  # noqa: E731
            assert abs(rank(got[kid_of[k], j]) - rank(exp[kid_of[k], j])) <= 0.002, (k, j)


def test_config2_passes_and_its_links_match_the_reference(monkeypatch, capsys):
    ok, line, agg = run_port("config2", monkeypatch, capsys)
    assert ok and line["mismatches"] == 0 and line["oracle_mismatches"] == 0
    assert line["oracle_sampled_traces"] > 0 and line["recompiles_in_window"] == 0
    shares = [line[f"host_{k}_share"] for k in ("generation", "ingest_call", "truth", "oracle")]
    assert all(x >= 0 for x in shares) and 0 < sum(shares) <= 1.0
    ts_min = int(jfixtures.TODAY_US // 60_000_000)
    n_pairs_total = SPANS["config2"] // 2
    want = ref_aggregator(
        ref._link_corpus_batch(lo, min(BATCH // 2, n_pairs_total - lo), 30, ts_min,
                               pad_pairs=BATCH // 2)[0]
        for lo in range(0, n_pairs_total, BATCH // 2))
    assert_planes_equal(agg, want)
    for a, b in zip(agg.dependency_matrices(0, 2**31), want.dependency_matrices(0, 2**31)):
        np.testing.assert_array_equal(a, b)
    assert agg.ctx_stats["ctx_advances"] > 0  # the links went through the ring's rollups


def test_config2_fails_on_a_corrupted_truth(monkeypatch, capsys):
    """One flipped error flag in the closed-form truth (the device gets
    the true corpus): the gate must see it."""
    real = rc._link_corpus_batch

    def corrupted(lo_pair, *a, **kw):
        cols, (a_, b_, err) = real(lo_pair, *a, **kw)
        if lo_pair == 0:
            err = err.copy()
            err[1] = not err[1]
        return cols, (a_, b_, err)

    monkeypatch.setattr(rc, "_link_corpus_batch", corrupted)
    ok, line, _ = run_port("config2", monkeypatch, capsys)
    assert not ok and line["mismatches"] == 1


def test_config3_passes_and_its_registers_match_the_reference(monkeypatch, capsys):
    ok, line, agg = run_port("config3", monkeypatch, capsys)
    assert ok and line["ids"] == SPANS["config3"] and line["recompiles_in_window"] == 0
    cols_at = ref_hll_cols_at(BATCH, 32)
    want = ref_aggregator(cols_at(done) for done in range(0, SPANS["config3"], BATCH))
    assert_planes_equal(agg, want)
    assert abs(line["estimate"] - float(want.cardinalities()[JCFG.global_hll_row])) <= 1


# --- config4, config0, the refusals -------------------------------------------

def test_config4_small_passes_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setenv("EVAL_SMALL", "1")
    monkeypatch.setenv("EVAL_REPLAY_SPANS", str(12 * 16_384))  # 4 warm-up steps, then 8 batches
    capsys.readouterr()
    assert rc.config4("cpu")
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert reference_keys("config4") <= set(line), reference_keys("config4") - set(line)
    assert line["spans"] == 12 * 16_384 and line["query_rounds"] == 1
    assert line["distinct_identity_gate"]["passed"] and line["recompiles_in_window"] == 0
    # the CPU records no device time and gates nothing on a wall clock
    assert line["slo_gate"] == "none_on_cpu" and line["slo_program_device_under_50ms"] is None
    assert {"spmd_flush", "spmd_rollup", "spmd_edges_fresh"} <= set(line["programs_missing_device_time"])


def test_config0_passes(capsys):
    assert rc.config0("cpu")
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == {
        "config": "config0", "passed": True}


def test_config4_refuses_without_the_native_parser(monkeypatch):
    """Without the native parser config4's realism gates would stay
    disarmed and pass; it raises instead of replaying another way."""
    monkeypatch.setenv("EVAL_SMALL", "1")
    monkeypatch.setattr(rc.native, "available", lambda: False)
    with pytest.raises(RuntimeError, match="native JSON parser"):
        rc.config4("cpu")


@pytest.mark.parametrize("times,missing,ok", [
    ({"spmd_card": 1.0, "spmd_flush": 6.0, "spmd_rollup": 9.0}, [], True),
    ({"spmd_card": 51.0, "spmd_flush": 6.0, "spmd_rollup": 9.0}, [], False),
    ({"spmd_card": 1.0, "spmd_flush": 151.0, "spmd_rollup": 9.0}, [], False),
    ({"spmd_card": 1.0, "spmd_flush": 6.0}, [], False),
    ({"spmd_card": 1.0, "spmd_flush": 6.0, "spmd_rollup": 9.0}, ["spmd_edges_fresh"], False),
    ({"spmd_flush": 6.0, "spmd_rollup": 9.0}, [], False),
])
def test_program_gate(times, missing, ok):
    """Every program under 50 ms, the amortized ones under their bounds
    and present; a program without its device time fails the gate."""
    assert rc.program_gate(times, missing) is ok


def test_program_device_ms_flags_a_call_without_its_device_time():
    before = {"spmd_card": (3, 3, 3.0), "spmd_flush": (1, 1, 5.0)}
    after = {"spmd_card": (5, 5, 5.0), "spmd_flush": (2, 1, 5.0), "spmd_step": (9, 9, 9.0),
             "spmd_rollup": (1, 1, 8.5), "hll_update_step": (4, 4, 1.0)}
    assert rc.program_device_ms(before, after) == (
        {"spmd_card": 1.0, "spmd_step": 1.0, "spmd_rollup": 8.5}, ["spmd_flush"])


def cli(*args, env_extra=None):
    env = {k: v for k, v in os.environ.items() if not k.startswith("EVAL_")}
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "-m", "zipkin_tpu_torch.evals.run_configs", *args],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)


def test_cli_refuses_without_a_card_and_runs_on_the_cpu_when_asked():
    out = cli("config0", env_extra={"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 2 and "no CUDA device is available" in out.stderr and not out.stdout
    out = cli("--device", "cpu", "config0")
    assert out.returncode == 0, out.stderr
    lines = [json.loads(x) for x in out.stdout.splitlines()]
    assert lines[0] == {"config": "config0", "passed": True}
    assert lines[1]["launches"]["total"] == {"hll_update": 0, "hll_update_step": 0,
                                             "ring_append": 0, "link_chase": 0}
    assert cli("--device", "cpu", "config10").returncode == 2

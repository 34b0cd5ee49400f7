"""The port's flight recorder (``zipkin_tpu_torch/obs``) against the JAX
package's: the stage catalogue, the same record sequence giving equal
snapshots, the recorder's own contracts (tests/test_obs_recorder.py's
specs on the port), every ``obs.record*`` literal of the port in the
catalogue, and the obs modules loading no torch."""

from __future__ import annotations

import ast
import pathlib
import random
import subprocess
import sys
import threading

import pytest

import tests.torch_cpu  # noqa: F401  (one intra-op thread a test process)
from zipkin_tpu import obs as ref_obs
from zipkin_tpu.obs.recorder import StageRecorder as RefRecorder
from zipkin_tpu_torch import obs as port_obs
from zipkin_tpu_torch.obs.recorder import StageRecorder, bucket_index, bucket_le_us

PORT = pathlib.Path(__file__).resolve().parent.parent / "zipkin_tpu_torch"


def test_stage_catalogue_equals_the_reference():
    assert port_obs.STAGES == ref_obs.STAGES
    assert port_obs.DEFAULT_BUDGETS_US == ref_obs.DEFAULT_BUDGETS_US
    assert port_obs.NUM_BUCKETS == ref_obs.NUM_BUCKETS
    for dur in (0.0, 4e-7, 6e-7, 1e-6, 0.001, 0.123456, 1.0, 60.0, 1e9):
        assert bucket_index(dur) == ref_obs.bucket_index(dur)
    assert [bucket_le_us(b) for b in range(31)] == [ref_obs.bucket_le_us(b) for b in range(31)]


def _drive(rec, plan):
    events = []
    rec.set_slow_hook(lambda ev: events.append((ev["stage"], ev["durUs"], ev["budgetUs"])))
    for stage, dur, relayed in plan:
        (rec.record_relayed if relayed else rec.record)(stage, dur)
    rec.set_slow_hook(None)
    return events


def test_same_records_give_equal_snapshots():
    rng = random.Random(9)
    plan = [(rng.choice(ref_obs.STAGES), rng.lognormvariate(-7, 3), rng.random() < 0.2)
            for _ in range(3000)]
    got, want = StageRecorder(slow_ring_size=16), RefRecorder(slow_ring_size=16)
    for rec in (got, want):
        rec.set_budget_scale(0.01)
    assert _drive(got, plan) == _drive(want, plan)
    a, b = got.snapshot(), want.snapshot()
    assert (a.counts, a.sums, a.maxes, a.generation) == (b.counts, b.sums, b.maxes, b.generation)
    for sa, sb in zip(a.stages(), b.stages()):
        assert (sa.stage, sa.count, sa.p50_us, sa.p99_us, sa.max_us) == (
            sb.stage, sb.count, sb.p50_us, sb.p99_us, sb.max_us)
    strip = lambda evs: [(e["stage"], e["durUs"], e["budgetUs"]) for e in evs]
    assert strip(got.slow_events()) == strip(want.slow_events())
    assert len(got.slow_events()) == 16  # the bounded ring


def test_threaded_writers_never_tear():
    rec = StageRecorder()
    plan = [(port_obs.STAGES[i], (i + 1) * 7) for i in range(4)]
    stop, errors = threading.Event(), []

    def writer(stage, us):
        for _ in range(3000):
            rec.record(stage, us / 1e6)

    def reader():
        while not stop.is_set():
            snap = rec.snapshot()
            for stage, us in plan:
                st = snap.stage(stage)
                if st.sum_us != st.count * us or sum(1 for c in st.buckets if c) > 1:
                    errors.append(stage)

    threads = [threading.Thread(target=writer, args=p) for p in plan]
    rd = threading.Thread(target=reader)
    rd.start()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    stop.set()
    rd.join(timeout=60)
    assert not rd.is_alive() and errors == []
    snap = rec.snapshot()
    assert [snap.stage(s).count for s, _ in plan] == [3000] * 4
    assert snap.locals_seen == 4


def test_budget_crossing_rings_and_hooks_and_relayed_skips_them():
    rec = StageRecorder(slow_ring_size=4)
    rec.set_budget_scale(0.0)
    seen = []
    rec.set_slow_hook(lambda ev: seen.append(ev["stage"]))
    for _ in range(6):
        rec.record("wal_fsync", 0.010)
    assert len(rec.slow_events()) == 4 and len(seen) == 6
    rec.set_slow_hook(lambda ev: ev.update(traceId="cafe"))
    rec.record("wal_fsync", 0.010)
    assert rec.slow_events()[-1]["traceId"] == "cafe"
    seen.clear()
    rec.set_slow_hook(lambda ev: seen.append(ev["stage"]))
    rec.record_relayed("parse", 0.010)
    assert rec.snapshot().stage("parse").count == 1 and seen == []
    rec.set_enabled(False)
    rec.record("parse", 1.0)
    rec.record_relayed("parse", 1.0)
    assert rec.snapshot().stage("parse").count == 1
    assert rec.measure_overhead(n=200) > 0
    assert rec.snapshot().stage("parse").count == 1  # the scratch recorder took them


def _record_literals():
    """(file, line, stage literal or None) of every ``obs.record(...)`` and
    ``obs.record_relayed(...)`` call in the port."""
    out = []
    for path in sorted(PORT.rglob("*.py")):
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)):
                continue
            fn = node.func
            if fn.attr not in ("record", "record_relayed"):
                continue
            if not (isinstance(fn.value, ast.Name) and fn.value.id in ("obs", "rec")):
                continue
            arg = node.args[0] if node.args else None
            lit = arg.value if isinstance(arg, ast.Constant) and isinstance(arg.value, str) else None
            out.append((path.relative_to(PORT.parent).as_posix(), node.lineno, lit))
    return out


def test_every_record_literal_in_the_port_is_a_stage():
    calls = _record_literals()
    assert not [c for c in calls if c[2] is None], "a record call without a stage literal"
    assert not [c for c in calls if c[2] not in port_obs.STAGE_INDEX]
    stamped = {c[2] for c in calls}
    # the stages this slice stamps (querytrace relays query_lock_wait and
    # query_wall through a recorder handle)
    for stage in ("http_boundary", "parse", "pack", "route", "device_dispatch", "rollup",
                  "ctx_advance", "wal_append", "wal_fsync", "snapshot", "sampler_tick",
                  "archive_write", "query_fresh", "query_cached", "readpack_transfer",
                  "mp_record", "mp_shm_copy", "mp_vocab_replay", "mp_lut_remap",
                  "mp_device_feed", "coalesce", "accuracy_rollup", "query_lock_wait",
                  "query_wall"):
        assert stage in stamped, stage


@pytest.mark.parametrize("module", ["stages", "recorder", "querytrace", "windows", "slo",
                                    "incidents", "selfspans", "shadow", "accuracy", "device"])
def test_obs_modules_load_no_torch(module):
    """What a spawned parse worker may import: every obs module loads
    without torch (the device observatory imports it at its first CUDA
    call)."""
    code = (f"import sys, zipkin_tpu_torch.obs.{module}; "
            "sys.exit(1 if 'torch' in sys.modules or 'jax' in sys.modules else 0)")
    assert subprocess.run([sys.executable, "-c", code], cwd=PORT.parent, timeout=120).returncode == 0

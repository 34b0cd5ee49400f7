"""config4's durable and resume modes and the resume driver
(``zipkin_tpu_torch.evals``) against the reference's ``evals/`` and the
JAX package, on the CPU, at config4's small config (``EVAL_SMALL``).

- Durable mode (``EVAL_REPLAY_DURABLE``) passes with its ``durability``
  reported, and a cold boot from its dirs holds the run's integer planes;
  ``chip_smoke.durable_boot`` passes on those dirs at the line's span count
  and fails at another.
- Resume mode (``EVAL_RESUME_DIR``): a window whose deadline trips raises
  ``SystemExit(75)`` after writing the cursor with the reference's keys;
  the next window's boot restores the victim's planes bit for bit, resumes
  batch indexing from the cursor and passes with its distinct-identity gate
  on the cumulative count; its final HLL and histogram planes equal those
  of one uninterrupted port store fed the same payloads and those of the
  reference's store (the reference's corpus, ``ref_replay_corpus``).
- ``python -m zipkin_tpu_torch.evals.resume_driver --device cpu`` relaunches
  a tripped window to completion (1 restore, cumulative spans equal to the
  target), and refuses to start with no card and no ``--device``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke
import tests.torch_cpu  # noqa: F401  (one intra-op thread a test process)
from tests.test_torch_evals import ROOT, ref_replay_corpus, reference_keys
from zipkin_tpu.parallel.mesh import make_mesh
from zipkin_tpu.tpu.state import AggConfig as JConfig
from zipkin_tpu.tpu.store import TpuStorage
from zipkin_tpu_torch.evals import run_configs as rc
from zipkin_tpu_torch.tpu.store import TorchStorage

B = min(rc.BATCH, rc.SMALL.rollup_segment, rc.SMALL.digest_buffer)  # config4's batch at SMALL
WARM = 4 * B  # a window's warm-up ingests the template once a step variant


def planes(store) -> dict:
    hist, hll_regs, _ = store.agg.merged_sketches()
    return {"hist": np.asarray(hist).copy(), "hll": np.asarray(hll_regs).copy(),
            "spans": int(store.agg.host_counters["spans"])}


def assert_planes_equal(got: dict, want: dict, what: str) -> None:
    assert got["spans"] == want["spans"], what
    for name in ("hist", "hll"):
        assert got[name].dtype == want[name].dtype, (what, name)
        np.testing.assert_array_equal(got[name], want[name], err_msg=f"{what} {name}")


@pytest.fixture
def kept(monkeypatch):
    """Every resume adapter config4 builds, with its planes at boot."""
    made = []

    class Kept(rc.DurableStorage):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.boot_planes = planes(self)
            made.append(self)

    monkeypatch.setattr(rc, "DurableStorage", Kept)
    monkeypatch.setenv("EVAL_SMALL", "1")
    return made


def line_of(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_config4_durable_mode_passes_and_its_dirs_hold_the_run(kept, monkeypatch, tmp_path, capsys):
    monkeypatch.setenv("EVAL_REPLAY_DURABLE", str(tmp_path))
    monkeypatch.setenv("EVAL_REPLAY_SPANS", str(WARM + 8 * B))
    monkeypatch.setenv("EVAL_SNAPSHOT_EVERY_BATCHES", "3")
    capsys.readouterr()
    assert rc.config4("cpu")
    line = line_of(capsys)
    assert reference_keys("config4") <= set(line), reference_keys("config4") - set(line)
    assert line["spans"] == WARM + 8 * B and line["recompiles_in_window"] == 0
    assert line["window"] is None and line["restore"] is None
    dur = line["durability"]
    assert dur["snapshots_taken"] == 8 // 3 + 1
    assert dur["wal_bytes_final"] > 0 and dur["snapshot_bytes_final"] > 0
    (victim,) = kept
    reborn = rc.DurableStorage(config=rc.SMALL, device="cpu", batch_size=B,
                               checkpoint_dir=str(tmp_path / "snap"), wal_dir=str(tmp_path / "wal"))
    try:
        assert_planes_equal(planes(reborn), planes(victim), "reborn vs the durable run")
    finally:
        reborn.close()
    # chip_smoke's phase q3 holds its durable run's dirs to the line the same way
    boot = chip_smoke.durable_boot(str(tmp_path), line["spans"], cfg=rc.SMALL, device="cpu")
    assert boot["spans"] == line["spans"] and boot["restore"]["restoreMs"] > 0
    with pytest.raises(AssertionError, match="phase q3"):
        chip_smoke.durable_boot(str(tmp_path), line["spans"] + 1, cfg=rc.SMALL, device="cpu")


def uninterrupted(payloads, store) -> dict:
    """``store`` fed config4's two windows' payloads in one run: the
    template (the warm-up, four times), batch 0, the template again,
    batches 1 and 2."""
    for data in payloads:
        n = store.ingest_json_fast(data)
        assert n is not None and n[0] == B
    store.agg.block_until_ready()
    return planes(store)


def test_config4_resume_mode_trips_restores_and_matches_the_reference(
        kept, monkeypatch, tmp_path, capsys):
    monkeypatch.setenv("EVAL_RESUME_DIR", str(tmp_path))
    monkeypatch.setenv("EVAL_REPLAY_SPANS", str(2 * WARM + 3 * B))
    corpus = rc._replay_corpus(B, 256)
    per_batch = corpus["distinct_per_batch"]

    # window 1: the deadline trips at the first batch
    monkeypatch.setenv("EVAL_WINDOW_DEADLINE_S", "1e-9")
    capsys.readouterr()
    with pytest.raises(SystemExit) as e:
        rc.config4("cpu")
    assert e.value.code == 75
    trip = line_of(capsys)
    cursor = json.loads((tmp_path / "eval_cursor.json").read_text())
    assert cursor == {"next_batch": 1, "distinct_traces": per_batch, "windows": 1,
                      "spans": WARM + B}
    assert (trip["window"], trip["window_tripped"], trip["window_exit"]) == (1, "deadline", 75)
    assert trip["cursor"] == cursor and trip["recompiles_in_window"] == 0
    assert trip["supervisor"]["supervisorTripped"] == "deadline"
    victim = planes(kept[0])

    # window 2: restores, resumes at batch 1 and runs to the target
    monkeypatch.setenv("EVAL_WINDOW_DEADLINE_S", "0")
    assert rc.config4("cpu")
    line = line_of(capsys)
    assert reference_keys("config4") <= set(line), reference_keys("config4") - set(line)
    resumed = kept[1]
    assert_planes_equal(resumed.boot_planes, victim, "the restored boot vs the tripped window")
    assert line["window"] == 2 and line["resumed_from_spans"] == WARM + B
    assert line["restore"]["restoreMs"] > 0 and line["recompiles_in_window"] == 0
    assert line["cursor"] == {"next_batch": 3, "distinct_traces": 3 * per_batch, "windows": 2,
                              "spans": 2 * WARM + 3 * B}
    gate = line["distinct_identity_gate"]
    assert gate["passed"] and gate["distinct_trace_ids"] == 4 * per_batch
    assert line["durability"]["snapshots_taken"] == 1
    got = planes(resumed)

    # one uninterrupted run of the same payloads, in the port and the reference
    template = [corpus["payload"]] * 4
    port_feed = template + [corpus["patched"](0)[0]] + template + \
        [corpus["patched"](i)[0] for i in (1, 2)]
    one = TorchStorage(config=rc.SMALL, device="cpu", pad_to_multiple=B)
    try:
        assert_planes_equal(got, uninterrupted(port_feed, one), "resumed vs uninterrupted")
    finally:
        one.close()
    _, payload_t, patched = ref_replay_corpus(B, 256)
    ref_template = [payload_t] * 4
    ref_feed = ref_template + [patched(0)[0]] + ref_template + [patched(i)[0] for i in (1, 2)]
    assert ref_feed == port_feed
    ref = TpuStorage(config=JConfig(**{f: getattr(rc.SMALL, f) for f in (
        "max_services", "max_keys", "hll_precision", "digest_centroids", "digest_buffer",
        "ring_capacity", "link_buckets", "hist_slices")}), mesh=make_mesh(1), pad_to_multiple=B)
    try:
        assert_planes_equal(got, uninterrupted(ref_feed, ref), "resumed vs the reference")
    finally:
        ref.close()


def driver(*args, env_extra=None):
    env = {k: v for k, v in os.environ.items() if not k.startswith("EVAL_")}
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "-m", "zipkin_tpu_torch.evals.resume_driver", *args],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)


def test_resume_driver_relaunches_a_tripped_window_to_the_target(tmp_path):
    # each window trips at its first batch: the first ends at WARM + B, the
    # second's warm-up and one batch reach the target, so it completes
    target = 2 * WARM + 2 * B
    out = driver("--device", "cpu", env_extra={
        "EVAL_SMALL": "1", "EVAL_REPLAY_SPANS": str(target), "EVAL_RESUME_DIR": str(tmp_path),
        "EVAL_WINDOW_DEADLINE_S": "1e-9"})
    assert out.returncode == 0, out.stderr[-4000:]
    docs = [json.loads(x) for x in out.stdout.splitlines() if x.startswith("{")]
    windows = [d for d in docs if d.get("config") == "config4"]
    assert [w["window"] for w in windows] == [1, 2] and windows[0]["window_exit"] == 75
    assert windows[1]["passed"] and windows[1]["resumed_from_spans"] == WARM + B
    summary = docs[-1]
    assert summary["artifact"] == "config4_resume_driver"
    assert (summary["completed"], summary["passed"], summary["windows"], summary["restores"]) == \
        (True, True, 2, 1)
    assert summary["cumulative_spans"] == target
    assert summary["distinct_trace_ids"] == windows[1]["cursor"]["distinct_traces"]


def test_resume_driver_refuses_without_a_card():
    out = driver(env_extra={"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 2 and "no CUDA device is available" in out.stderr
    assert not out.stdout

"""A cell is data: a new traffic mix and a new configuration run by name,
with no edit to the harness; a store option the harness cannot build is
refused rather than run as something less."""

import json
import time

import pytest

from portbench import drive, run
from portbench.tests.small import shrink


def test_a_new_mix_and_config_run_without_an_edit(tmp_path):
    config = run.load_json(run.HERE / "configs" / "zipkin-default.json")
    mix = run.load_json(run.HERE / "traffic" / "lens.json")
    shrink(config, mix)
    config["agg_config"].update(digest_centroids=32, hist_slices=4)
    mix.update(hops=8)
    mix["reads"].update(clients=1, kinds={"deps": 2, "cardinalities": 1})
    (tmp_path / "portbench" / "configs").mkdir(parents=True)
    (tmp_path / "portbench" / "traffic").mkdir()
    (tmp_path / "portbench" / "configs" / "probe.json").write_text(json.dumps(config))
    (tmp_path / "portbench" / "traffic" / "deep.json").write_text(json.dumps(mix))
    bench = run.load_json(run.ROOT / "BENCHMARK.json")
    bench["configs"] = [{"name": "probe", "file": "portbench/configs/probe.json"}]
    bench["workloads"] = [{"name": "probe.deep", "config": "probe", "traffic": "deep",
                           "chips": 1}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    b, cell, cfg, m = run.load_cell(tmp_path, "probe.deep")
    assert cfg["agg_config"]["digest_centroids"] == 32 and m["hops"] == 8
    out = run.run_cell(cell, cfg, m, 3_000_000_017, 2.0, False, "cpu",
                       run.cell_metrics(b, "probe.deep", False), t_process=time.perf_counter())
    assert out["correct"] is True, out["checks"]
    assert set(out["run"]["read_ms_by_kind"]) == {"deps", "cardinalities"}
    assert {"read_gap", "read_card_relgap"} <= set(out["checks"])


def test_read_kinds_follow_their_shares():
    mix = {"reads": {"kinds": {"deps": 2, "quantiles": 1, "cardinalities": 3}}}
    assert drive.read_cycle(mix) == ["deps", "quantiles", "cardinalities", "deps",
                                     "cardinalities", "cardinalities"]


@pytest.mark.parametrize("change", [{"store": {"wal": True}}, {"store": {"archive": True}},
                                    {"store": {"snapshot_every": 448}},
                                    {"agg_config": {"sampling": True}}])
def test_a_store_the_harness_cannot_build_is_refused(change):
    config = run.load_json(run.HERE / "configs" / "zipkin-default.json")
    for group, opts in change.items():
        config[group] = dict(config[group], **opts)
    with pytest.raises(ValueError, match="harness"):
        drive.build_store(config, "cpu")

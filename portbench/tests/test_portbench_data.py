"""Every configuration, traffic mix and per-layer metric that
BENCHMARK.json names loads by name, and the file keeps the contract's
shape."""

import re

import pytest

from portbench import run
from portbench.tests.small import bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_top_level_keys():
    assert set(bench()) == {"command", "paths", "run_seconds", "configs", "workloads",
                            "end_to_end", "per_layer"}


@pytest.mark.parametrize("cell", [w["name"] for w in bench()["workloads"]])
def test_cell_loads_by_name(cell):
    b = bench()
    w = run.find_cell(b, cell)
    assert NAME.match(w["name"]) and w["chips"] == 1
    _, _, config, mix = run.load_cell(run.ROOT, cell)
    assert {"agg_config", "store", "limits", "min_points"} <= set(config)
    assert {"batch_spans", "pool_batches", "feed", "reads", "trace"} <= set(mix)
    names = {m["name"] for m in run.cell_metrics(b, cell, False)}
    assert "setup_s" in names and len(names) >= 2
    assert run.cell_metrics(b, cell, True)


@pytest.mark.parametrize("metric", sorted(p.name[:-3] for p in (run.HERE / "metrics").glob("*.py")))
def test_metric_reader_loads_and_reads_nothing_from_nothing(metric):
    read = run.metric_reader(metric)
    ctx = {"trace": None, "ingest_call_s": [], "read_service_s": {},
           "hll_traffic": [], "batch_spans": 65536, "ring_capacity": 1 << 18,
           "ring_lane_bytes": (91, 92), "timetier": True}
    assert read(ctx) is None


def test_every_config_file_loads():
    for path in (run.HERE / "configs").glob("*.json"):
        doc = run.load_json(path)
        assert {"agg_config", "store", "limits", "min_points", "reduced"} <= set(doc)
    for path in (run.HERE / "traffic").glob("*.json"):
        assert "batch_spans" in run.load_json(path)


def test_config_files_are_distinct_and_under_paths():
    b = bench()
    files = [c["file"] for c in b["configs"]]
    assert len(set(files)) == len(files)
    for c in b["configs"]:
        assert c["file"].startswith("portbench/configs/") and NAME.match(c["name"])
        doc = run.load_json(run.ROOT / c["file"])
        assert set(c["reduced"]) <= set(doc)


def test_every_config_used_and_every_metric_named():
    b = bench()
    files = {p.name[:-3] for p in (run.HERE / "metrics").glob("*.py")}
    assert {m["name"] for m in b["per_layer"]} <= files
    used = {w["config"] for w in b["workloads"]}
    assert used == {c["name"] for c in b["configs"]}
    cells = {w["name"] for w in b["workloads"]}
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25

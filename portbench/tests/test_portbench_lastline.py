"""A run's last line: the contract's keys, each metric with its value and
unit, the compared numbers last, each beside its limit."""

import json
import math

from portbench.tests.small import line, run_small

REQUIRED = ("correct", "attempted", "failed", "metrics", "device")


def test_last_line_keys_and_checks():
    out = line(run_small("default.feed"))
    assert list(out)[:5] == list(REQUIRED)
    assert list(out)[-1] == "checks"
    assert set(out) <= set(REQUIRED) | {"breakdown", "run", "checks"}
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
    assert set(out["metrics"]) == {"ingest_spans_per_s", "setup_s"}
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and math.isfinite(m["value"]) and m["value"] > 0
    assert set(out["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    for name, c in out["checks"].items():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"], name
    json.dumps(out)


def test_lens_last_line_reports_the_reads():
    out = line(run_small("default.lens"))
    assert out["correct"] is True
    assert set(out["metrics"]) == {"ingest_spans_per_s", "setup_s"}
    assert set(out["run"]["read_ms_by_kind"]) == {"deps", "quantiles", "windowed",
                                                  "cardinalities"}
    assert out["run"]["reads_checked"] > 0 and "read_gap" in out["checks"]

"""The control (the reference one batch behind, a store that breaks
read-after-write, with its digests in bfloat16) comes out not correct in
every cell, on each number it can read; the cells as they run come out
correct."""

import pytest

from portbench.tests.small import run_small

EXACT = ("counts_gap", "hist_gap", "hll_gap", "links_gap", "tt_gap", "digest_gap")
CELLS = ["default.feed", "default.lens", "default.wire-json"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    out = run_small(cell, control=True)
    assert out["correct"] is False
    for name in EXACT + ("card_relgap",):
        assert out["checks"][name]["value"] > out["checks"][name]["limit"], name
    # at this size the bfloat16 digests stray less than at the cell's own
    # (PERF.md gives the card's readings); sound runs read 0 here
    assert out["checks"]["digest_rank_gap"]["value"] > 0
    if cell == "default.lens":
        assert out["checks"]["read_gap"]["value"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_correct(cell):
    out = run_small(cell)
    assert out["correct"] is True, out["checks"]
    assert out["checks"]["digest_rank_gap"]["value"] == 0

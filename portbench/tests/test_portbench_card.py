"""One short run of each cell on the card (skips without one)."""

import json
import subprocess
import sys

import pytest

from portbench import run


@pytest.mark.card
@pytest.mark.parametrize("cell", ["default.feed"])
def test_cell_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the cells run on the card only")
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", cell, "--seed",
                          "2147483999", "--seconds", "5", "--trace", "0"], cwd=run.ROOT,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert last["correct"] is True, last["checks"]

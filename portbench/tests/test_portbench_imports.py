"""Nothing the benchmark loads is JAX or the JAX package (top-level names
compared whole, so the port's package passes), and the reference loads
nothing of the program."""

import subprocess
import sys

from portbench import run

FORBIDDEN = {"jax", "jaxlib", "flax", "zipkin_tpu"}

RUN_CELL = """
import sys
from portbench import run
from portbench.tests.small import run_small
for name in ("default.feed", "default.lens"):
    run_small(name, seconds=1.0)
for m in run.load_json(run.ROOT / "BENCHMARK.json")["per_layer"]:
    run.metric_reader(m["name"])
import portbench.trace, portbench.roofline
print(" ".join(sorted({m.split(".")[0] for m in sys.modules})))
"""

REFERENCE = """
import sys
import portbench.reference.model, portbench.reference.sketch, portbench.reference.digest
import portbench.compare, portbench.generator
print(" ".join(sorted({m.split(".")[0] for m in sys.modules})))
"""


def top_level(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(out.stdout.split())


def test_a_run_loads_no_jax():
    names = top_level(RUN_CELL)
    assert "zipkin_tpu_torch" in names
    assert not names & FORBIDDEN, names & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    names = top_level(REFERENCE)
    assert not names & (FORBIDDEN | {"zipkin_tpu_torch"}), names


def test_forbidden_check_compares_whole_names(monkeypatch):
    monkeypatch.setattr(sys, "modules", {"zipkin_tpu_torch": sys, "zipkin_tpu_torch.ops": sys,
                                         "jaxtyping": sys, "numpy": sys})
    assert run.loaded_forbidden() == []
    monkeypatch.setattr(sys, "modules", {"zipkin_tpu.ops": sys, "jax": sys})
    assert run.loaded_forbidden() == ["jax", "zipkin_tpu"]

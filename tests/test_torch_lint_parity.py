"""The port's ZT-lint held against the reference's.

- **Unchanged rules** (ZT00, ZT04, ZT08's taxonomy half, ZT09–ZT14): every
  fixture of ``tests/test_lint_checkers.py`` (loaded by path: ``tests/``
  is no package) is linted by both linters, the port's copy written under
  the port's file names (``zipkin_tpu/tpu/ring.py`` becomes
  ``zipkin_tpu_torch/tpu/ring.py``) with its ``zipkin_tpu`` imports
  renamed; both give the same ``(rule, line)`` list.
- **Retargeted rules** (ZT01–ZT03, ZT05–ZT07 and ZT08's traced half):
  each JAX-form fixture and its torch translation, line for line, give
  the same ``(rule, line)`` list under their own linters.
- **Markers**: every marked def of the reference carries the same marker
  on its counterpart in the port (:data:`MARKER_EXCEPTIONS` lists the
  counterparts that moved, with the reason).
- **Pragmas**: every ``zt-lint: disable`` of the port matches a pragma
  with the same rule in the reference's counterpart def, or is listed in
  :data:`DEPARTURES` with the reason the port departs.
"""

from __future__ import annotations

import ast
import importlib.util
import pathlib
import re
import textwrap

import pytest

import tests.torch_cpu  # noqa: F401  (one intra-op thread a test process)
from zipkin_tpu.lint import run_paths as ref_run_paths
from zipkin_tpu.lint.core import Module as RefModule
from zipkin_tpu_torch.lint import run_paths as port_run_paths

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF_TESTS = ROOT / "tests" / "test_lint_checkers.py"

UNCHANGED = {"ZT00", "ZT04", "ZT09", "ZT10", "ZT11", "ZT12", "ZT13", "ZT14"}
RETARGETED = {"ZT01", "ZT02", "ZT03", "ZT05", "ZT06", "ZT07", "ZT08"}

# the port's counterpart of a reference module / class
FILE_RENAMES = {
    "parallel/sharded.py": "parallel/aggregator.py",
    "ops/pallas_hll.py": "ops/hll_kernel.py",
}
CLASS_RENAMES = {"ShardedAggregator": "TorchAggregator", "TpuStorage": "TorchStorage"}

# reference marker -> (port counterpart def, why it moved)
MARKER_EXCEPTIONS = {
    ("server/app.py", "ZipkinServer._ingest", "ingest-boundary"): (
        "ZipkinServer.post_spans",
        "the port's server is http.server, not aiohttp: the POST handler "
        "method that reaches the collector is post_spans",
    ),
}

# port pragma (file, def, rule) with no counterpart in the reference
DEPARTURES = {
    ("convert.py", "_leaves", "ZT01"): (
        "the port's own snapshot conversion: a snapshot copies every leaf "
        "once, as the reference's state_arrays does with one np.asarray a "
        "leaf (a list comprehension its taint pass did not follow)"
    ),
    ("convert.py", "state_from_numpy", "ZT01"): (
        "a snapshot restore uploads each leaf once, at boot"
    ),
}


# -- the reference's fixtures, loaded by path -----------------------------


def _load_reference_tests():
    spec = importlib.util.spec_from_file_location("ref_lint_checkers", REF_TESTS)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reference_fixtures():
    """(test name, index, source str or {rel: source}, file name) of every
    fixture a reference checker test lints."""
    mod = _load_reference_tests()
    tree = ast.parse(REF_TESTS.read_text())
    out = []
    for fn in tree.body:
        if not (isinstance(fn, ast.FunctionDef) and fn.name.startswith("test_")):
            continue
        index = 0
        for call in ast.walk(fn):
            if not (
                isinstance(call, ast.Call)
                and isinstance(call.func, ast.Name)
                and call.func.id in ("lint", "lint_tree", "assert_rule_owned")
                and len(call.args) >= 2
            ):
                continue
            arg = call.args[1]
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                src = arg.value
            elif isinstance(arg, ast.Name) and hasattr(mod, arg.id):
                src = getattr(mod, arg.id)
            elif isinstance(arg, ast.Dict):
                src = ast.literal_eval(arg)
            else:
                continue
            name = "mod.py"
            for k in call.keywords:
                if k.arg == "name" and isinstance(k.value, ast.Constant):
                    name = k.value.value
            if call.func.id == "assert_rule_owned" and len(call.args) >= 4:
                name = call.args[3].value
            out.append((fn.name, index, src, name))
            index += 1
    return out


FIXTURES = _reference_fixtures()


def _port_text(src: str) -> str:
    return re.sub(r"\bzipkin_tpu\b", "zipkin_tpu_torch", src)


def _port_files(src, name):
    files = src if isinstance(src, dict) else {name: src}
    return {_port_text(rel): _port_text(s) for rel, s in files.items()}


def _run(run_paths, base, files, **kwargs):
    for rel, src in files.items():
        p = base / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))
    result = run_paths([str(base)], root=base, **kwargs)
    assert not result.errors, result.errors
    return result


def _pairs(result, keep):
    return sorted((f.rule, f.line) for f in result.findings if f.rule in keep)


def _traced(src) -> bool:
    text = src if isinstance(src, str) else "\n".join(src.values())
    return bool(re.search(r"\bjit\b|shard_map", text))


def test_every_reference_fixture_is_loaded():
    assert len(FIXTURES) >= 90
    assert {t for t, *_ in FIXTURES} >= {
        "test_zt11_flags_unstamped_protected_write",
        "test_zt13_flags_cross_module_acquire_two_calls_deep",
        "test_zt14_follows_to_thread_callable_reference",
    }


@pytest.mark.parametrize(
    "test_name,index,src,name", FIXTURES, ids=[f"{t}-{i}" for t, i, _, _ in FIXTURES]
)
def test_unchanged_rules_agree_on_reference_fixtures(tmp_path, test_name, index, src, name):
    ref_files = src if isinstance(src, dict) else {name: src}
    keep = set(UNCHANGED)
    if not _traced(src):
        keep.add("ZT08")  # the taxonomy half; the traced half is retargeted
    ref = _run(ref_run_paths, tmp_path / "ref", ref_files)
    port = _run(port_run_paths, tmp_path / "port", _port_files(src, name))
    assert _pairs(port, keep) == _pairs(ref, keep)


# -- retargeted rules: JAX fixture and torch translation ------------------

# (reference test, fixture index) -> torch translation, line for line
TRANSLATIONS = {
    ("test_zt01_flags_device_pull_outside_chokepoint", 0): """
    import torch
    import numpy as np

    class Agg:
        def read(self):
            return self.states[0].hist.cpu()
""",
    ("test_zt01_ignores_host_input_coercion", 0): """
        import torch
        import numpy as np

        def coerce(qs):
            return np.asarray(qs, np.float32)
        """,
    ("test_zt01_ignores_jax_device_metadata", 0): """
        import torch
        import numpy as np

        def make_mesh():
            return np.asarray(torch.cuda.device_count())
        """,
    ("test_zt01_flags_item_and_float_of_device_values", 0): """
        import torch
        import numpy as np

        class Agg:
            def peek(self):
                total = torch.sum(self.states[0].counters)
                return float(total), self.states[0].pend_pos.item()
        """,
    ("test_zt02_flags_two_pulls_per_method", 0): """
    import torch
    import numpy as np

    class Agg:
        def read(self):
            a = self.states[0].hist.cpu()
            b = self.states[0].hll.cpu()
            return a, b
""",
    ("test_zt02_allows_single_packed_pull", 0): """
        import torch

        class Agg:
            def read(self):
                return self._pull(self._merge(self.states))
        """,
    ("test_zt03_flags_jit_factory_without_cache", 0): """
    import torch

    def build(config):
        return torch.compile(lambda state: state)
""",
    ("test_zt03_allows_lru_cached_factory", 0): """
        import functools

        import torch

        @functools.lru_cache(maxsize=None)
        def build(config):
            return torch.compile(lambda state: state)
        """,
    ("test_zt03_jit_decorator_is_not_a_construction_site", 0): """
        import functools

        import torch

        @functools.partial(torch.compile, dynamic=True)
        def step(x, interpret=False):
            return x
        """,
    ("test_zt03_flags_jit_in_loop_and_varying_scalar", 0): """
        import torch

        step = torch.compile(lambda s, n: s)

        def replay(state, batches):
            for n in batches:
                state = step(state, n)
            return state

        def rebuild(sizes):
            fns = []
            for _ in sizes:
                fns.append(torch.cuda.CUDAGraph())
            return fns
        """,
    ("test_zt05_flags_read_after_donation", 0): """
    import torch

    step = torch.compile(lambda s, x: s.add_(x))  # zt-in-place: s — adds x into the state

    def run(state, x):
        out = step(state, x)
        return out, state.sum()
""",
    ("test_zt05_allows_rebinding_the_donated_name", 0): """
        import torch

        step = torch.compile(lambda s, x: s.add_(x))  # zt-in-place: s — adds x into the state

        def run(state, x):
            state = step(state, x)
            return state.sum()
        """,
    ("test_zt06_flags_blocking_sync_in_serving_code", 0): """
    import torch

    def serve(agg):
        torch.cuda.synchronize()
""",
    ("test_zt07_flags_sort_reachable_from_fresh_entrypoint", 0): """
    import torch
    import numpy as np

    def _resolve(keys):
        return torch.sort(keys).values

    def edges_fresh(states, ctxs, lo, hi):
        order = _resolve(states[0].ring_keys)
        return order
""",
    ("test_zt07_flags_from_scratch_rebuilder_call", 0): """
        import torch
        from zipkin_tpu_torch.ops import linker

        def fresh_link_context(config, state):
            return linker.link_context(state.ring)
        """,
    ("test_zt07_ignores_sorts_on_the_rollup_path", 0): """
        import torch

        def advance(state, seg):
            return u32.lexsort(state.ring_keys)

        def rollup_step(config, state):
            return advance(state, config.rollup_segment)
        """,
    ("test_zt07_ignores_cumsum_on_fresh_path", 0): """
        import torch
        import numpy as np

        def delta_resolve(x, cs, seg):
            return torch.cumsum(cs.run_starts, 0)
        """,
}


def _mechanical(src: str) -> str:
    """The traced-half fixtures in torch form: a jitted def is a compiled
    one, a shard_map'd one a graphed callable (line for line)."""
    out = src.replace("from jax.experimental.shard_map import shard_map",
                      "from torch.cuda import make_graphed_callables")
    out = out.replace("shard_map(", "make_graphed_callables(")
    out = re.sub(r"\bjax\.jit\b", "torch.compile", out)
    out = re.sub(r"^(\s*)import jax$", r"\1import torch", out, flags=re.M)
    return _port_text(out)


def _retargeted_cases():
    cases = []
    for test_name, index, src, name in FIXTURES:
        key = (test_name, index)
        if key in TRANSLATIONS:
            cases.append((test_name, index, src, TRANSLATIONS[key], name))
        elif test_name.startswith("test_zt08") and _traced(src):
            cases.append((test_name, index, src, _mechanical(src), name))
        elif test_name.startswith(("test_zt06_", "test_zt07_")) and "jax" not in src:
            # host-only fixtures (the windowed fence): the same source
            cases.append((test_name, index, src, _port_text(src), name))
    return cases


RETARGETED_CASES = _retargeted_cases()


def test_every_retargeted_fixture_has_a_translation():
    covered = {(t, i) for t, i, *_ in RETARGETED_CASES}
    missing = [
        (t, i) for t, i, src, _ in FIXTURES
        if re.match(r"test_zt0[1235-7]_", t) and (t, i) not in covered
        and t != "test_zt06_exempts_benchmarks_and_tests"
    ]
    assert missing == []
    assert len(RETARGETED_CASES) >= 30


@pytest.mark.parametrize(
    "test_name,index,src,torch_src,name", RETARGETED_CASES,
    ids=[f"{t}-{i}" for t, i, *_ in RETARGETED_CASES],
)
def test_retargeted_rules_agree_on_translations(tmp_path, test_name, index, src,
                                                torch_src, name):
    ref = _run(ref_run_paths, tmp_path / "ref", {name: src})
    port = _run(port_run_paths, tmp_path / "port", {_port_text(name): torch_src})
    assert _pairs(port, RETARGETED) == _pairs(ref, RETARGETED)


@pytest.mark.parametrize("name", ["benchmarks/bench.py", "tests/test_x.py"])
def test_zt06_exemptions_agree(tmp_path, name):
    src = TRANSLATIONS[("test_zt06_flags_blocking_sync_in_serving_code", 0)]
    ref_src = _load_reference_tests().ZT06_POSITIVE
    ref = _run(ref_run_paths, tmp_path / "ref", {name: ref_src})
    port = _run(port_run_paths, tmp_path / "port", {name: src})
    assert _pairs(port, {"ZT06"}) == _pairs(ref, {"ZT06"}) == []


# -- markers and pragmas --------------------------------------------------

_MARKER_RE = re.compile(
    r"#\s*zt-(dispatch-critical|mirror-served|reader-process|ingest-boundary|"
    r"tenant-admission)\b"
)
_BODY_KINDS = {"ingest-boundary", "tenant-admission"}


def _defs(path: pathlib.Path):
    """(class-qualified name, def node) of every def in a module."""
    out = []

    def walk(body, prefix):
        for n in body:
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out.append((prefix + n.name, n))
                walk(n.body, prefix + n.name + ".")
            elif isinstance(n, ast.ClassDef):
                walk(n.body, prefix + n.name + ".")
            elif isinstance(n, (ast.If, ast.Try, ast.With)):
                walk(list(getattr(n, "body", [])) + list(getattr(n, "orelse", [])), prefix)

    walk(ast.parse(path.read_text()).body, "")
    return out


def _marked(pkg: str):
    """{(rel file, def, marker kind)}: a marker on the def's header lines,
    in the comment lines right above it, or (the admission kinds, as ZT14
    reads them) anywhere in its body."""
    out = set()
    base = ROOT / pkg
    for path in sorted(base.rglob("*.py")):
        rel = path.relative_to(base).as_posix()
        if rel.startswith("lint/"):
            continue
        lines = path.read_text().splitlines()
        for qual, node in _defs(path):
            end = node.body[0].lineno if node.body else node.lineno + 1
            spots = list(range(node.lineno, end))
            i = node.lineno - 1
            while i >= 1 and lines[i - 1].strip().startswith("#"):
                spots.append(i)
                i -= 1
            for ln in spots:
                m = _MARKER_RE.search(lines[ln - 1])
                if m:
                    out.add((rel, qual, m.group(1)))
            for ln in range(end, (node.end_lineno or end) + 1):
                m = _MARKER_RE.search(lines[ln - 1])
                if m and m.group(1) in _BODY_KINDS:
                    out.add((rel, qual, m.group(1)))
    return out


def _counterpart(rel: str, qual: str):
    return (FILE_RENAMES.get(rel, rel),
            ".".join(CLASS_RENAMES.get(p, p) for p in qual.split(".")))


def test_every_reference_marker_has_its_counterpart():
    ref, port = _marked("zipkin_tpu"), _marked("zipkin_tpu_torch")
    assert len(ref) >= 39
    missing = []
    for rel, qual, kind in sorted(ref):
        prel, pqual = _counterpart(rel, qual)
        moved = MARKER_EXCEPTIONS.get((rel, qual, kind))
        if moved is not None:
            pqual = moved[0]
        if (prel, pqual, kind) not in port:
            missing.append((rel, qual, kind))
    assert missing == []


def _pragmas(pkg: str):
    """{(rel file, def, rule)} of every pragma (the def whose span holds
    the line the pragma governs; '-' at module scope)."""
    out = set()
    base = ROOT / pkg
    for path in sorted(base.rglob("*.py")):
        rel = path.relative_to(base).as_posix()
        if rel.startswith("lint/"):
            continue
        src = path.read_text()
        if "zt-lint" not in src:
            continue
        module = RefModule(path, rel, src)
        defs = _defs(path)
        for pragma in module.pragmas:
            target = module._pragma_target(pragma.line)
            owner = "-"
            best = None
            for qual, node in defs:
                if node.lineno <= target <= node.end_lineno and (
                    best is None or node.lineno > best.lineno
                ):
                    owner, best = qual, node
            for rule in pragma.rules:
                out.add((rel, owner, rule))
    return out


def test_every_port_pragma_matches_the_reference_or_is_a_listed_departure():
    ref = {(_counterpart(rel, qual), rule) for rel, qual, rule in _pragmas("zipkin_tpu")}
    port = _pragmas("zipkin_tpu_torch")
    assert port, "the port carries no pragma at all"
    unlisted = sorted(
        (rel, qual, rule) for rel, qual, rule in port
        if ((rel, qual), rule) not in ref and (rel, qual, rule) not in DEPARTURES
    )
    assert unlisted == []
    # every listed departure still exists (a stale row would hide nothing)
    assert set(DEPARTURES) <= port

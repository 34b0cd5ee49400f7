"""The port's ZT-lint, rule by rule, in torch form: one positive and one
negative fixture per rule (ZT00–ZT14). Every positive finding is proved
to come from its own checker: linted again with that rule ignored (ZT00,
which cannot be ignored, with its checker taken out of the registry), it
disappears. Then the retargeted rules' torch shapes one by one: each
device->host coercion and shape-syncing op of ZT01, the multi-pull count
of ZT02, the rebuild hazards and cached factories of ZT03, the in-place
markers of ZT05, the CUDA syncs of ZT06, the sort set of ZT07 and the
capture regions of ZT08, and the taint pass's view of the port's state
(``self.states[i]``) and tensor annotations.
"""

from __future__ import annotations

import textwrap

import pytest

import tests.torch_cpu  # noqa: F401  (one intra-op thread a test process)
from zipkin_tpu_torch.lint import core, run_paths


def lint_files(tmp_path, files, **kwargs):
    for rel, src in files.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))
    return run_paths([str(tmp_path)], root=tmp_path, **kwargs)


def lint(tmp_path, source, name="mod.py", **kwargs):
    return lint_files(tmp_path, {name: source}, **kwargs)


def rules(result):
    return sorted(f.rule for f in result.findings)


def _files(fixture, name):
    return dict(fixture) if isinstance(fixture, dict) else {name: fixture}


# rule -> (positive, negative, file name the rule keys on)
FIXTURES = {
    "ZT00": (
        """
        import threading

        LOCK = threading.Lock()  # zt-lint: disable=ZT04
        """,
        """
        import threading

        LOCK = threading.Lock()  # zt-lint: disable=ZT04 — module-level, written once
        """,
        "mod.py",
    ),
    "ZT01": (
        """
        import torch

        class Agg:
            def read(self):
                return self.states[0].hist.cpu()
        """,
        """
        import numpy as np
        import torch

        def coerce(qs):
            return np.asarray(qs, np.float32)
        """,
        "mod.py",
    ),
    "ZT02": (
        """
        import torch

        class Agg:
            def read(self):
                a = self.states[0].hist.cpu()
                b = self.states[0].hll.cpu()
                return a, b
        """,
        """
        import torch

        class Agg:
            def read(self):
                return self._pull(self._p["spmd_merge"](self.states))
        """,
        "mod.py",
    ),
    "ZT03": (
        """
        import torch

        def build(fn):
            return torch.compile(fn)
        """,
        """
        import functools

        import torch

        @functools.lru_cache(maxsize=None)
        def build(fn):
            return torch.compile(fn)
        """,
        "mod.py",
    ),
    "ZT04": (
        """
        import threading

        class Counter:
            def __init__(self):
                self._lock = threading.Lock()
                self.count = 0

            def bump(self):
                with self._lock:
                    self.count += 1

            def reset(self):
                self.count = 0
        """,
        """
        import threading

        class Counter:
            def __init__(self):
                self._lock = threading.Lock()
                self.count = 0

            def bump(self):
                with self._lock:
                    self.count += 1

            def reset(self):
                with self._lock:
                    self.count = 0
        """,
        "mod.py",
    ),
    "ZT05": (
        """
        import torch

        def step(state, x):  # zt-in-place: state — adds into the state's plane
            state.add_(x)
            return state

        def run(state, x):
            out = step(state, x)
            return out, state.sum()
        """,
        """
        import torch

        def step(state, x):  # zt-in-place: state — adds into the state's plane
            state.add_(x)
            return state

        def run(state, x):
            state = step(state, x)
            return state.sum()
        """,
        "mod.py",
    ),
    "ZT06": (
        """
        import torch

        def serve(agg):
            torch.cuda.synchronize()
        """,
        """
        import torch

        class Agg:
            def block_until_ready(self):
                torch.cuda.synchronize()
        """,
        "mod.py",
    ),
    "ZT07": (
        """
        import torch

        def fresh_link_context(config, state):
            return torch.argsort(state.r_trace_h)
        """,
        """
        import torch

        def rollup_step(config, state):
            return torch.argsort(state.r_trace_h)

        def fresh_link_context(config, state):
            return torch.cumsum(state.r_valid, 0)
        """,
        "mod.py",
    ),
    "ZT08": (
        """
        import torch

        from zipkin_tpu_torch import obs

        def step(x):
            obs.record("device_dispatch", 0.0)
            return x

        def capture(g, x):
            with torch.cuda.graph(g):
                step(x)
        """,
        """
        import torch

        from zipkin_tpu_torch import obs

        def step(x):
            obs.record("device_dispatch", 0.0)
            return x

        def capture(g, x):
            step(x)
        """,
        "mod.py",
    ),
    "ZT09": (
        """
        def remap(rows):  # zt-dispatch-critical: the dispatch core's remap
            for r in rows:
                r += 1
        """,
        """
        def remap(rows):
            for r in rows:
                r += 1
        """,
        "mod.py",
    ),
    "ZT10": (
        """
        class Mirror:
            def serve(self, key):  # zt-mirror-served: epoch-pinned read
                with self.agg.lock:
                    return key
        """,
        """
        class Mirror:
            def serve(self, key):  # zt-mirror-served: epoch-pinned read
                with self._demand_lock:
                    return key
        """,
        "mod.py",
    ),
    "ZT11": (
        """
        _S_GEN = 0
        _S_TS0 = 1

        class Ring:
            def publish(self, hdr, ts):
                hdr[_S_TS0] = ts
        """,
        """
        _S_GEN = 0
        _S_TS0 = 1

        class Ring:
            def publish(self, hdr, ts):
                hdr[_S_GEN] += 1
                hdr[_S_TS0] = ts
                hdr[_S_GEN] += 1
        """,
        "zipkin_tpu_torch/tpu/ring.py",
    ),
    "ZT12": (
        """
        import os

        def commit(path, blob):
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(blob)
            os.replace(tmp, path)
        """,
        """
        import os

        def _fsync_dir(d):
            fd = os.open(d, os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)

        def commit(path, blob):
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(blob)
                os.fsync(f.fileno())
            os.replace(tmp, path)
            _fsync_dir(".")
        """,
        "zipkin_tpu_torch/tpu/wal.py",
    ),
    "ZT13": (
        {
            "app/serve.py": """
                from app import mid

                def snapshot():  # zt-mirror-served: epoch-pinned read surface
                    return mid.resolve()
            """,
            "app/mid.py": """
                def resolve():
                    return _read()

                def _read():
                    with AGG.lock:
                        return 1
            """,
        },
        {
            "app/serve.py": """
                from app import mid

                def snapshot():  # zt-mirror-served: epoch-pinned read surface
                    return mid.resolve()
            """,
            "app/mid.py": """
                def resolve():
                    return dict(EPOCH.view)
            """,
        },
        None,
    ),
    "ZT14": (
        {
            "app/http.py": """
                from app import fanout

                def ingest(body):  # zt-ingest-boundary: HTTP spans POST
                    return fanout.submit(body)

                def accept(body):
                    # zt-tenant-admission: tenant budget before dispatch
                    return len(body)
            """,
            "app/fanout.py": """
                def submit(body):
                    return len(body)
            """,
        },
        {
            "app/http.py": """
                from app import coll

                def ingest(body):  # zt-ingest-boundary: HTTP spans POST
                    return coll.accept(body)
            """,
            "app/coll.py": """
                def accept(body):
                    # zt-tenant-admission: tenant budget before dispatch
                    return len(body)
            """,
        },
        None,
    ),
}


@pytest.mark.parametrize("rule", sorted(FIXTURES))
def test_positive_fixture_is_owned_by_its_rule(tmp_path, rule, monkeypatch):
    positive, _negative, name = FIXTURES[rule]
    files = _files(positive, name)
    assert rule in rules(lint_files(tmp_path / "on", files))
    if rule == "ZT00":
        # ZT00 cannot be ignored: take its checker out of the registry
        registry = {k: v for k, v in core._REGISTRY.items() if k != "ZT00"}
        monkeypatch.setattr(core, "_REGISTRY", registry)
        off = lint_files(tmp_path / "off", files)
    else:
        off = lint_files(tmp_path / "off", files, ignore={rule})
    assert rule not in rules(off)


@pytest.mark.parametrize("rule", sorted(FIXTURES))
def test_negative_fixture_is_clean(tmp_path, rule):
    _positive, negative, name = FIXTURES[rule]
    assert rules(lint_files(tmp_path, _files(negative, name))) == []


# -- ZT01 / ZT02: every coercion and shape sync of the torch form ---------


@pytest.mark.parametrize(
    "expr",
    [
        "self.states[0].hist.cpu()",
        "self.states[0].hist.numpy()",
        "self.states[0].counters[0].item()",
        "self.states[0].counters.tolist()",
        "np.asarray(self.states[0].hist)",
        "np.array(self.states[0].hist)",
        "int(self.states[0].pend_pos)",
        "float(self.states[0].digest.sum())",
        "bool(self.states[0].r_valid.any())",
        "self.states[0].hist.to('cpu')",
        "self.states[0].hist.to(torch.device('cpu'))",
        "torch.nonzero(self.states[0].r_valid)",
        "self.states[0].r_valid.nonzero()",
        "torch.where(self.states[0].r_valid)",
        "torch.unique(self.states[0].r_svc)",
        "torch.masked_select(self.states[0].r_svc, self.states[0].r_valid)",
        "torch.arange(4).repeat_interleave(self.states[0].counters)",
    ],
)
def test_zt01_flags_each_torch_host_pull(tmp_path, expr):
    result = lint(
        tmp_path,
        f"""
        import numpy as np
        import torch

        class Agg:
            def read(self):
                return {expr}
        """,
        select={"ZT01"},
    )
    assert rules(result) == ["ZT01"], expr


@pytest.mark.parametrize(
    "expr",
    [
        "self.states[0].hist.shape[0]",
        "int(self.states[0].hist.shape[0])",
        "self.states[0].hist.numel()",
        "torch.cuda.device_count()",
        "np.asarray(torch.cuda.get_device_name(0))",
        "torch.from_numpy(host).numpy()",
        "torch.arange(4).repeat_interleave(4)",
        "self.states[0].hist.repeat_interleave(2, output_size=8)",
        "torch.where(self.states[0].r_valid, 1, 0)",
        "readpack.pull(packed)[0].item()",
    ],
)
def test_zt01_ignores_host_metadata_and_static_shapes(tmp_path, expr):
    result = lint(
        tmp_path,
        f"""
        import numpy as np
        import torch

        class Agg:
            def read(self, host, packed):
                return {expr}
        """,
        select={"ZT01"},
    )
    assert rules(result) == [], expr


@pytest.mark.parametrize(
    "stmt,flagged",
    [
        ("return torch.tensor(qs, device=dev)", True),
        ("return torch.as_tensor(qs, device='cuda')", True),
        ("return torch.from_numpy(host).to(dev)", True),
        ("return torch.from_numpy(host).cuda()", True),
        ("t = torch.from_numpy(host).to(torch.int32)\n    return t.to(dev)", True),
        ("return torch.from_numpy(host).to(dev, non_blocking=True)", False),
        ("return torch.from_numpy(host).to(torch.float32)", False),
        ("return torch.tensor(qs, device='cpu')", False),
        ("return torch.as_tensor(self.states[0].hist, device=dev)", False),
        ("t = torch.from_numpy(host).to(dev)\n    return t.to(torch.int64)", True),
        ("return x.to(dev)", False),
    ],
)
def test_zt01_flags_blocking_uploads(tmp_path, stmt, flagged):
    src = (
        "import torch\n\n\n"
        "def up(self, qs, host, x, dev):\n    " + stmt + "\n"
    )
    result = lint(tmp_path, src, select={"ZT01", "ZT02"})
    assert rules(result) == (["ZT01"] if flagged else []), stmt
    if flagged:
        assert "blocking upload" in result.findings[0].message


@pytest.mark.parametrize(
    "stmt,flagged",
    [
        ("state.r_rolled[pos] = False", True),
        ("add[0] = n", True),
        ("add[2] = 1.5", True),
        ("add[1] = state.pend_pos.sum()", False),
        ("add[0:1].fill_(n)", False),
        ("state.r_rolled.index_fill_(0, pos, False)", False),
        ("entry[1] = n", False),
        ("table[n] = state.hll", False),
    ],
)
def test_zt01_flags_host_values_stored_into_device_tensors(tmp_path, stmt, flagged):
    src = (
        "import torch\n\n\n"
        "def step(state, pos, n: int):\n"
        "    add = torch.zeros(4, dtype=torch.int64, device=state.hll.device)\n"
        "    entry = [torch.zeros(4), 0]\n"
        "    table = {}\n"
        "    " + stmt + "\n"
        "    return add, entry, table\n"
    )
    result = lint(tmp_path, src, select={"ZT01", "ZT02"})
    assert rules(result) == (["ZT01"] if flagged else []), stmt
    if flagged:
        assert "stored into a device tensor" in result.findings[0].message


def test_zt01_taints_tensor_annotations_and_state_lists(tmp_path):
    result = lint(
        tmp_path,
        """
        import torch

        def live_count(batch: SpanColumns) -> int:  # zt-device: batch — a fixture
            return int(batch.valid.sum().item())

        def first(x: torch.Tensor):
            return x[0].item()

        def shards(agg):
            return [s.hll.cpu() for s in agg.states]

        def each(agg):
            out = []
            for s in agg.states:
                out.append(s.hll.cpu())
            return out

        def host_count(batch: SpanColumns) -> int:
            return int(batch.valid.sum())
        """,
        select={"ZT01"},
    )
    assert [f.line for f in result.findings] == [5, 8, 11, 16]


def test_zt01_exempts_the_readpack_chokepoint(tmp_path):
    src = """
        import torch

        def device_get(buf: torch.Tensor):
            return buf.cpu().numpy()
    """
    assert rules(lint(tmp_path, src, name="zipkin_tpu_torch/readpack.py")) == []
    assert rules(lint(tmp_path / "x", src, name="zipkin_tpu_torch/other.py")) == [
        "ZT01"
    ]


def test_zt01_sees_a_pull_behind_a_cross_module_helper(tmp_path):
    result = lint_files(
        tmp_path,
        {
            "pkg/helpers.py": """
                import torch

                def total(state):
                    return torch.sum(state.hist)
            """,
            "pkg/read.py": """
                import torch

                from pkg.helpers import total

                def read(hist):
                    return total(hist).item()
            """,
        },
        select={"ZT01"},
    )
    assert [(f.path, f.line) for f in result.findings] == [("pkg/read.py", 7)]


def test_zt02_counts_chokepoint_pulls_and_coercions_together(tmp_path):
    result = lint(
        tmp_path,
        """
        import torch

        class Agg:
            def read(self):
                (a,) = self._pull(self._p["spmd_card"](self.states))
                n = int(self.states[0].pend_pos)
                return a, n
        """,
        select={"ZT02"},
    )
    assert rules(result) == ["ZT02"]
    assert "2 host pulls" in result.findings[0].message


def test_zt02_flags_a_return_tuple_of_copies(tmp_path):
    result = lint(
        tmp_path,
        """
        import torch

        def read(a, b):
            return a.cpu(), b.cpu()
        """,
        select={"ZT02"},
    )
    assert rules(result) == ["ZT02"]


# -- ZT03: rebuild hazards ------------------------------------------------


def test_zt03_flags_graph_build_and_compile_in_a_loop(tmp_path):
    result = lint(
        tmp_path,
        """
        import ctypes

        import torch

        def step_graphs(sizes):
            graphs = []
            for _ in sizes:
                graphs.append(torch.cuda.CUDAGraph())
            return graphs

        def load(path):
            return ctypes.CDLL(path)

        def rebuild():
            return kernels.build(["hll_update"])
        """,
        select={"ZT03"},
    )
    assert [f.line for f in result.findings] == [9, 13, 16]


def test_zt03_accepts_the_kernel_loaders_memo(tmp_path):
    # kernels.load: a per-name cache under a lock, tested before building;
    # native._load: a global singleton with the same test
    result = lint(
        tmp_path,
        """
        import ctypes
        import threading

        _lock = threading.Lock()
        _libs = {}
        _lib = None

        def load(name):
            with _lock:
                lib = _libs.get(name)
                if lib is None:
                    lib = ctypes.CDLL(str(build([name])[name]))
                    _libs[name] = lib
                return lib

        def _load():
            global _lib
            if _lib is not None:
                return _lib
            _lib = ctypes.CDLL("libx.so")
            return _lib
        """,
        select={"ZT03"},
    )
    assert rules(result) == []


def test_zt03_accepts_the_step_graphs_memo(tmp_path):
    # tpu/graphs.py: one graph per key in a mapping the instance holds,
    # tested before the capture; a graph built on every call is still found
    result = lint(
        tmp_path,
        """
        import torch

        class StepGraphs:
            def __init__(self):
                self._graphs = {}

            def step(self, key, program):
                captured = self._graphs.get(key)
                if captured is None:
                    graph = torch.cuda.CUDAGraph()
                    self._graphs[key] = graph
                    return
                captured.replay()

            def every_call(self, key):
                graph = torch.cuda.CUDAGraph()
                self._graphs[key] = graph
                return graph
        """,
        select={"ZT03"},
    )
    assert [f.line for f in result.findings] == [17]


def test_zt03_flags_varying_scalars_into_a_compiled_callable(tmp_path):
    result = lint(
        tmp_path,
        """
        import torch

        step = torch.compile(lambda s, n: s)
        dyn = torch.compile(lambda s, n: s, dynamic=True)

        def replay(state, batches):
            for n in batches:
                state = step(state, n)
                state = dyn(state, n)
            return step(state, int(state.sum()))
        """,
        select={"ZT03"},
    )
    assert [f.line for f in result.findings] == [9, 11]


# -- ZT05: in-place programs ----------------------------------------------


def test_zt05_resolves_marked_defs_across_modules_by_keyword(tmp_path):
    result = lint_files(
        tmp_path,
        {
            "pkg/ingest.py": """
                import torch

                def ingest_step(config, state, batch, live=None):  # zt-in-place: state — scatters into the planes
                    return state
            """,
            "pkg/agg.py": """
                import torch

                from pkg import ingest

                def run(cfg, s, b):
                    out = ingest.ingest_step(cfg, state=s, batch=b)
                    return out, s.hist.sum()

                def ok(cfg, s, b):
                    s = ingest.ingest_step(cfg, s, b)
                    return s.hist.sum()
            """,
        },
        select={"ZT05"},
    )
    assert [(f.path, f.line) for f in result.findings] == [("pkg/agg.py", 8)]


def test_zt05_binding_marker_covers_a_program_table(tmp_path):
    result = lint(
        tmp_path,
        """
        import torch

        class Agg:
            def __init__(self, programs):
                # zt-in-place: states — every step program updates the
                # states in place
                self._step = programs

            def good(self, batches):
                self.states = self._step[(False, False)](self.states, batches)

            def bad(self, batches):
                out = self._step[(False, False)](self.states, batches)
                return out, self.states
        """,
        select={"ZT05"},
    )
    assert [f.line for f in result.findings] == [15]


def test_zt05_marker_must_name_a_parameter_and_a_reason(tmp_path):
    result = lint(
        tmp_path,
        """
        def step(state, x):  # zt-in-place: missing — no such parameter
            return state

        def other(state):  # zt-in-place: state
            return state
        """,
    )
    assert rules(result) == ["ZT05", "ZT05"]


# -- ZT06: CUDA syncs -------------------------------------------------------


@pytest.mark.parametrize(
    "stmt",
    [
        "torch.cuda.synchronize()",
        "torch.cuda.synchronize(dev)",
        "torch.cuda.current_stream(dev).synchronize()",
        "ev.synchronize()",
        "stream.synchronize()",
    ],
)
def test_zt06_flags_each_cuda_sync(tmp_path, stmt):
    src = f"""
        import torch

        def serve(dev, ev, stream):
            {stmt}
    """
    assert rules(lint(tmp_path, src)) == ["ZT06"]
    for exempt in ("benchmarks/b.py", "evals/e.py", "tests/test_x.py"):
        assert rules(lint(tmp_path / "ex", src, name=exempt)) == []


# -- ZT07: the sort set ---------------------------------------------------


@pytest.mark.parametrize(
    "expr",
    [
        "torch.sort(state.r_trace_h).values",
        "state.r_trace_h.sort().values",
        "torch.argsort(state.r_trace_h)",
        "state.r_trace_h.argsort()",
        "torch.msort(state.r_trace_h)",
        "torch.unique(state.r_svc)",
        "u32.lexsort([state.r_tl0, state.r_tl1])",
        "linker.link_context(ring_link_input(state))",
    ],
)
def test_zt07_flags_each_sort_on_the_fresh_path(tmp_path, expr):
    result = lint(
        tmp_path,
        f"""
        import torch

        def fresh_link_context(config, state):
            return _helper(state)

        def _helper(state):
            return {expr}
        """,
        select={"ZT07"},
    )
    assert rules(result) == ["ZT07"], expr
    assert "via _helper()" in result.findings[0].message


def test_zt07_lexsort_body_is_not_scanned_only_its_callers(tmp_path):
    result = lint_files(
        tmp_path,
        {
            "pkg/u32.py": """
                import torch

                def lexsort(lanes):
                    return torch.sort(lanes[0], stable=True).indices
            """,
            "pkg/read.py": """
                import torch

                from pkg import u32

                def delta_resolve(x, cs, seg):
                    # zt-lint: disable=ZT07 — sorts only the 2·Δ delta lanes
                    return u32.lexsort([x])
            """,
        },
        select={"ZT07"},
    )
    assert rules(result) == []
    assert len(result.suppressed) == 1


# -- ZT08: capture regions --------------------------------------------------


def test_zt08_flags_hooks_reached_from_graphed_or_compiled_callables(tmp_path):
    result = lint(
        tmp_path,
        """
        import torch

        from zipkin_tpu_torch import obs
        from zipkin_tpu_torch.obs.device import OBSERVATORY

        def inner(x):
            OBSERVATORY.observe("hll_update_step", 0.0)
            return x

        def graphed(x):
            return inner(x)

        @torch.compile
        def compiled(x):
            obs.record("device_dispatch", 0.0)
            return x

        def build(x):
            return torch.cuda.make_graphed_callables(graphed, (x,))

        def capture(g, x):
            with torch.cuda.graph(g):
                obs.record("device_dispatch", 0.0)
        """,
        select={"ZT08"},
    )
    assert [f.line for f in result.findings] == [8, 16, 24]


def test_zt08_sees_capture_begin_end_regions_and_the_step_programs(tmp_path):
    # the port's one capture site records between capture_begin and
    # capture_end around a program parameter (tpu/graphs.py), and the
    # programs it captures are the closures of a def marked zt-captured
    # (shard_program); an unmarked def's closures are host code
    result = lint(
        tmp_path,
        """
        import torch

        from zipkin_tpu_torch import obs
        from zipkin_tpu_torch.obs.device import OBSERVATORY

        def step(x):
            obs.record("device_dispatch", 0.0)
            return x

        def capture(graph, program, x):
            graph.capture_begin(capture_error_mode="thread_local")
            step(x)
            program(x)
            OBSERVATORY.observe("hll_update_step", 0.0)
            graph.capture_end()
            obs.record("device_dispatch", 0.0)

        def step_programs(cfg):  # zt-captured: the step programs a graph captures
            def program(state, bits):
                obs.record("device_dispatch", 0.0)
            return program

        def host_programs(cfg):
            def program(state, bits):
                obs.record("device_dispatch", 0.0)
            return program
        """,
        select={"ZT08"},
    )
    assert [f.line for f in result.findings] == [8, 15, 21]


def test_zt08_taxonomy_half_flags_unknown_and_dynamic_stages(tmp_path):
    result = lint(
        tmp_path,
        """
        from zipkin_tpu_torch import obs

        def host(stage):
            obs.record("no_such_stage", 0.0)
            obs.record(stage, 0.0)
            obs.record("device_dispatch", 0.0)
        """,
        select={"ZT08"},
    )
    assert [f.line for f in result.findings] == [5, 6]


def test_suppressed_findings_carry_the_lines_their_pragma_governs(tmp_path):
    # a pragma on a def header governs the whole def; one on a line, that
    # line alone (the census on the card explains a sync by these spans)
    result = lint(
        tmp_path,
        """
        import torch

        def scoped(x: torch.Tensor):  # zt-lint: disable=ZT01 — a fixture
            a = x.cpu()
            return a

        def one_line(x: torch.Tensor):
            # zt-lint: disable=ZT01 — a fixture
            a = x.item()
            return a
        """,
        select={"ZT01"},
    )
    assert result.findings == []
    doc = result.to_dict()
    spans = sorted((f["line"], f["pragma"]["line"], tuple(f["pragma"]["governs"]))
                   for f in doc["suppressed"])
    assert spans == [(5, 4, (4, 6)), (10, 9, (10, 10))]

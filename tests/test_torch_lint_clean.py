"""The port's tree passes the port's ZT-lint (``python -m
zipkin_tpu_torch.lint``), in process, with the engine's contract: one
shared call graph a run within a 60 s budget, parses reused across runs,
the JSON document and the stats line of the CLI, a reason on every
pragma, and an import that loads nothing but the standard library. Then
the repairs of the lint's first whole-tree run: each is a lock the
finding named, now held, or a host sync taken off a scan.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import tests.torch_cpu  # noqa: F401  (one intra-op thread a test process)
from zipkin_tpu_torch.lint import all_checkers, run_paths

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "zipkin_tpu_torch"


def test_port_tree_lints_clean():
    result = run_paths([str(PKG)], root=ROOT)
    assert not result.errors, result.errors
    assert result.findings == [], "\n".join(f.render() for f in result.findings)
    # the pragmas the port carries are what the parity test lists
    assert len(result.suppressed) > 0


def test_lint_package_lints_itself_with_zero_suppressions():
    result = run_paths([str(PKG / "lint")], root=ROOT)
    assert not result.errors
    assert result.findings == []
    assert result.suppressed == []


def test_full_rule_catalog_registered():
    assert sorted(all_checkers()) == [f"ZT{i:02d}" for i in range(15)]


def test_one_shared_call_graph_within_budget(monkeypatch):
    from zipkin_tpu_torch.lint import callgraph

    builds = []
    orig_init = callgraph.CallGraph.__init__

    def counting_init(self, modules):
        builds.append(True)
        orig_init(self, modules)

    monkeypatch.setattr(callgraph.CallGraph, "__init__", counting_init)
    result = run_paths([str(PKG)], root=ROOT)
    assert builds == [True]
    assert result.stats["functions"] > 500, result.stats
    assert result.stats["edges"] > 1000, result.stats
    assert result.stats["elapsed_ms"] < 60_000, result.stats


def test_module_cache_reuses_parses_across_runs():
    from zipkin_tpu_torch.lint import core

    target = [str(PKG / "lint")]
    run_paths(target, root=ROOT)
    before = {k: id(v[2]) for k, v in core._MODULE_CACHE.items()}
    run_paths(target, root=ROOT)
    after = {k: id(v[2]) for k, v in core._MODULE_CACHE.items()}
    shared = set(before) & set(after)
    assert shared, "cache empty after a run"
    assert all(before[k] == after[k] for k in shared)


def test_cli_json_format(capsys):
    from zipkin_tpu_torch.lint.cli import main

    rc = main([str(PKG / "lint"), "--format", "json"])
    doc = json.loads(capsys.readouterr().out)
    assert rc == 0
    assert doc["exit_code"] == 0
    assert doc["findings"] == []
    assert doc["stats"]["files"] > 0
    assert doc["stats"]["functions"] > 0
    assert set(doc) == {
        "findings", "suppressed", "baselined", "errors", "stats", "exit_code",
    }


def test_cli_stats_line_and_rule_listing(capsys):
    from zipkin_tpu_torch.lint.cli import build_parser, main

    assert build_parser().prog == "python -m zipkin_tpu_torch.lint"
    assert build_parser().parse_args([]).paths == ["zipkin_tpu_torch"]
    rc = main([str(PKG / "lint"), "--stats"])
    err = capsys.readouterr().err
    assert rc == 0
    assert "zt-lint stats:" in err
    assert "call edge(s)" in err
    assert main(["--list-rules"]) == 0
    listed = [line.split()[0] for line in capsys.readouterr().out.splitlines()]
    assert listed == [f"ZT{i:02d}" for i in range(15)]


def test_every_port_suppression_carries_a_reason():
    from zipkin_tpu_torch.lint.core import PRAGMA_RE

    bad = []
    for path in sorted(PKG.rglob("*.py")):
        for i, line in enumerate(path.read_text().splitlines(), 1):
            m = PRAGMA_RE.search(line)
            if m and not m.group("reason").strip(" \t-—:()"):
                bad.append(f"{path}:{i}")
    assert bad == []


def test_the_lint_loads_only_the_standard_library():
    code = (
        "import sys, pathlib\n"
        "import zipkin_tpu_torch.lint as lint\n"
        "lint.all_checkers()\n"
        "r = lint.run_paths([sys.argv[1]], root=pathlib.Path(sys.argv[2]))\n"
        "assert r.stats['files'] > 0\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('torch', 'numpy', 'jax', 'zipkin_tpu'))\n"
        "print(bad)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code, str(PKG / "lint"), str(ROOT)],
        capture_output=True, text=True, cwd=ROOT, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


# -- repairs of the first whole-tree run ----------------------------------


class _Held:
    """A lock wrapper that knows whether this thread is inside it."""

    def __init__(self, lock):
        self.lock, self.depth = lock, 0

    def __enter__(self):
        self.lock.__enter__()
        self.depth += 1
        return self

    def __exit__(self, *exc):
        self.depth -= 1
        return self.lock.__exit__(*exc)

    def __getattr__(self, name):
        return getattr(self.lock, name)


def _watch_writes(obj, attr: str, lock_attr: str):
    """Record, for each later write of ``obj.attr``, whether it happened
    inside ``obj.<lock_attr>``."""
    held = _Held(getattr(obj, lock_attr))
    setattr(obj, lock_attr, held)
    cls = type(obj)
    slot = next((k.__dict__[attr] for k in cls.__mro__ if attr in k.__dict__), None)
    writes = []
    if slot is not None:
        def get(self):
            return slot.__get__(self, cls)

        def put(self, value):
            writes.append(held.depth > 0)
            slot.__set__(self, value)
        ns = {"__slots__": (), attr: property(get, put)}
    else:
        def get(self):
            return self.__dict__[attr]

        def put(self, value):
            writes.append(held.depth > 0)
            self.__dict__[attr] = value
        ns = {attr: property(get, put)}
    obj.__class__ = type(cls.__name__, (cls,), ns)
    return writes


def test_program_stats_reset_zeroes_the_drop_count_under_the_queue_lock():
    from zipkin_tpu_torch.obs.device import ProgramStats

    stats = ProgramStats("hll_update_step")
    stats.events_dropped = 3
    writes = _watch_writes(stats, "events_dropped", "_qlock")
    stats.reset()
    assert stats.events_dropped == 0
    assert writes == [True]


def test_storage_clear_resets_the_read_cache_version_under_its_lock():
    from zipkin_tpu_torch.tpu.state import AggConfig
    from zipkin_tpu_torch.tpu.store import TorchStorage

    store = TorchStorage(
        device="cpu", pad_to_multiple=256,
        config=AggConfig(max_services=16, max_keys=64, hll_precision=8,
                         digest_centroids=16, ring_capacity=1 << 10),
    )
    try:
        writes = _watch_writes(store, "_read_cache_version", "_read_cache_lock")
        store.clear()
        assert store._read_cache_version == -1
        assert writes == [True]
    finally:
        store.close()


def test_server_restart_resets_its_drain_flags_under_the_idle_lock():
    from zipkin_tpu_torch.server.app import ZipkinServer
    from zipkin_tpu_torch.server.config import ServerConfig

    server = ZipkinServer(ServerConfig(host="127.0.0.1", port=0, storage_type="mem"),
                          seal_interval_s=0)
    drain = _watch_writes(server, "_draining", "_idle")
    server.start()
    try:
        assert drain == [True]
        assert server.admit()
        server.release()
    finally:
        server.stop()


def test_segmented_min_scan_keeps_its_value_range_on_the_device(monkeypatch):
    from zipkin_tpu_torch.ops import linker

    g = torch.Generator().manual_seed(7)
    vals = torch.randint(-(1 << 40), 1 << 40, (512,), generator=g)
    flags = torch.rand(512, generator=g) < 0.1
    flags[0] = True
    expect = []
    for lo, hi in zip(*[list(x) for x in _runs(flags)]):
        expect.append(torch.cummin(vals[lo:hi], 0).values)
    expect = torch.cat(expect)

    def no_item(self):
        raise AssertionError("a host sync inside the scan")

    monkeypatch.setattr(torch.Tensor, "item", no_item)
    got = linker._seg_min_scan(vals, flags)
    assert torch.equal(got, expect)


def _runs(flags):
    starts = [i for i, f in enumerate(flags.tolist()) if f]
    return starts, starts[1:] + [len(flags)]


def test_segmented_min_scan_reverse_matches_a_loop():
    from zipkin_tpu_torch.ops import linker

    g = torch.Generator().manual_seed(11)
    vals = torch.randint(0, 1 << 20, (300,), generator=g, dtype=torch.int32)
    flags = torch.rand(300, generator=g) < 0.05
    flags[-1] = True
    got = linker._seg_min_scan(vals, flags, reverse=True)
    rv, rf = torch.flip(vals, [0]), torch.flip(flags, [0])
    want = []
    for lo, hi in zip(*_runs(rf)):
        want.append(torch.cummin(rv[lo:hi], 0).values)
    want = torch.flip(torch.cat(want), [0])
    assert got.dtype == vals.dtype
    assert torch.equal(got, want)


@pytest.mark.parametrize("n", [0, 1])
def test_segmented_min_scan_edge_sizes(n):
    from zipkin_tpu_torch.ops import linker

    vals = torch.arange(n, dtype=torch.int64)
    flags = torch.ones(n, dtype=torch.bool)
    assert torch.equal(linker._seg_min_scan(vals, flags), vals)


def _no_host_scalar_stores(monkeypatch):
    """Make ``x[i] = <Python number>`` raise: on the card such a store
    copies the number up and waits for the stream."""
    orig = torch.Tensor.__setitem__

    def setitem(self, index, value):
        if isinstance(value, (bool, int, float)):
            raise AssertionError(f"a host scalar stored into a tensor: [{index!r}] = {value!r}")
        return orig(self, index, value)

    monkeypatch.setattr(torch.Tensor, "__setitem__", setitem)


def test_ingest_step_stores_no_host_scalar(monkeypatch):
    from zipkin_tpu_torch.parallel.aggregator import TorchAggregator
    from zipkin_tpu_torch.tpu.columnar import route_fused
    from zipkin_tpu_torch.tpu.state import CTR_BATCHES, CTR_SPANS, AggConfig
    from zipkin_tpu_torch.workload import generate

    cfg = AggConfig(max_services=16, max_keys=64, hll_precision=8, digest_centroids=16,
                    ring_capacity=1 << 10, digest_buffer=512)
    agg = TorchAggregator(cfg, device="cpu")
    cols = generate(512, seed=3, services=8).cols
    want_spans = int(cols.valid.sum())
    _no_host_scalar_stores(monkeypatch)
    for lo in range(0, 512, 256):
        part = route_fused(_slice(cols, lo, lo + 256), 1)
        agg.ingest_fused(part, n_spans=0, n_dur=0, n_err=0)
    monkeypatch.undo()
    counters = agg.states[0].counters
    assert int(counters[CTR_SPANS]) == want_spans
    assert int(counters[CTR_BATCHES]) == 2
    assert bool(agg.states[0].r_rolled.any()) is False


def _slice(cols, lo, hi):
    from zipkin_tpu_torch.workload import slice_columns

    return slice_columns(cols, lo, hi)


def test_link_chase_and_run_starts_store_no_host_scalar(monkeypatch):
    from zipkin_tpu_torch.ops import linker

    parent = torch.tensor([-1, 0, 1, 2, -1, 4, 5, 3])
    kind = torch.tensor([1, 0, 2, 0, 1, 0, 0, 2])
    anc_want, root_want = linker.chase_ancestors(parent, kind)
    lanes = [torch.tensor([1, 1, 2, 2, 2, 3]), torch.tensor([0, 0, 0, 1, 1, 1])]
    starts_want = linker._run_starts(lanes)
    _no_host_scalar_stores(monkeypatch)
    anc, root = linker.chase_ancestors(parent, kind)
    starts = linker._run_starts(lanes)
    monkeypatch.undo()
    assert torch.equal(anc, anc_want) and torch.equal(root, root_want)
    assert torch.equal(starts, starts_want)
    assert starts.tolist() == [True, False, True, True, False, True]
    assert anc.tolist() == [-1, 0, 0, 2, -1, 4, 4, 2]


def test_watch_writes_sees_an_unlocked_write():
    # the helper itself: a write outside the lock is recorded as such
    class Box:
        def __init__(self):
            self.lock = threading.Lock()
            self.v = 0

    box = Box()
    writes = _watch_writes(box, "v", "lock")
    box.v = 1
    with box.lock:
        box.v = 2
    assert writes == [False, True]
    assert box.v == 2


def _no_blocking_uploads(monkeypatch, moves: bool = True):
    """Make a host-to-device copy that waits for the stream raise:
    ``torch.tensor``/``torch.as_tensor`` with a ``device=``, and (with
    ``moves``) ``Tensor.to``/``.cuda`` onto a device without
    ``non_blocking=True``. On the card a pageable upload returns only when
    the work queued before it is done (the CPU, where the copy is a no-op,
    still shows the call). ``moves=False`` where the code under test also
    moves device tensors between cards, which this cannot tell apart."""
    def fence(name, orig, moves):
        def wrapped(*args, **kwargs):
            if moves(args, kwargs) and kwargs.get("non_blocking") is not True:
                raise AssertionError(f"a blocking upload: {name}(device=...)")
            return orig(*args, **kwargs)
        return wrapped

    def onto_device(args, kwargs):
        dest = list(args[1:2]) + [kwargs.get("device")]
        return any(isinstance(d, (str, torch.device)) for d in dest)

    for name in ("tensor", "as_tensor"):
        monkeypatch.setattr(torch, name, fence(f"torch.{name}", getattr(torch, name),
                                               lambda a, k: k.get("device") is not None))
    if moves:
        monkeypatch.setattr(torch.Tensor, "to", fence("Tensor.to", torch.Tensor.to, onto_device))
        monkeypatch.setattr(torch.Tensor, "cuda", fence("Tensor.cuda", torch.Tensor.cuda,
                                                        lambda a, k: True))


def test_quantile_reads_take_one_pull_and_no_blocking_upload(monkeypatch):
    from zipkin_tpu_torch import readpack
    from zipkin_tpu_torch.parallel.aggregator import TorchAggregator
    from zipkin_tpu_torch.tpu.columnar import route_fused
    from zipkin_tpu_torch.tpu.state import AggConfig
    from zipkin_tpu_torch.workload import generate

    cfg = AggConfig(max_services=16, max_keys=64, hll_precision=8, digest_centroids=16,
                    ring_capacity=1 << 10, digest_buffer=512)
    agg = TorchAggregator(cfg, device="cpu")
    cols = generate(256, seed=5, services=8).cols
    agg.ingest_fused(route_fused(cols, 1), n_spans=0, n_dur=0, n_err=0)
    qs = [0.5, 0.9, 0.99]
    want = agg.quantiles(qs), agg.sketch_overview(qs)
    _no_blocking_uploads(monkeypatch, moves=False)  # the shard merges move partials
    n0 = readpack.transfer_count()
    q, n = agg.quantiles(qs)
    assert readpack.transfer_count() - n0 == 1
    overview = agg.sketch_overview(qs)
    assert readpack.transfer_count() - n0 == 2
    monkeypatch.undo()
    np.testing.assert_array_equal(q, want[0][0])
    np.testing.assert_array_equal(n, want[0][1])
    for got, exp in zip(overview, want[1]):
        np.testing.assert_array_equal(got, exp)
    assert q.shape == (cfg.max_keys, len(qs))


def test_wire_image_upload_does_not_block(monkeypatch):
    from zipkin_tpu_torch import u32

    arr = np.arange(12, dtype=np.uint32).reshape(3, 4) * np.uint32(0x9E3779B1)
    _no_blocking_uploads(monkeypatch)
    t = u32.from_numpy(arr, "cpu")
    monkeypatch.undo()
    assert t.dtype == torch.int64
    np.testing.assert_array_equal(t.numpy(), arr.astype(np.int64))

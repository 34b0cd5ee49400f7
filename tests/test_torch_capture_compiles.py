"""A step-graph capture is the port's compile, as the reference's jit cache
entry is (``zipkin_tpu/obs/device.py``'s compiles and recompiles,
``zipkin_tpu/tpu/store.py``'s ``deviceCompiles``/``deviceRecompiles``):
every capture of a step variant counts a compile of that variant's
``spmd_step*`` program in the device observatory, and a capture that a
step has to make after the boot captures (``capture_steps``: a lane count
off the ladder) counts a recompile. A CUDA graph captures only on a card,
so the capture runs here on the stand-in graph of
``tests/test_torch_step_graph.py``."""

from __future__ import annotations

import pytest

import tests.torch_cpu  # noqa: F401  (one intra-op thread a test process)
from tests.test_torch_step_graph import CFG, _recorded, _stand_in_cuda
from zipkin_tpu_torch.obs.device import OBSERVATORY
from zipkin_tpu_torch.parallel.aggregator import TorchAggregator, shard_program
from zipkin_tpu_torch.tpu.columnar import route_fused
from zipkin_tpu_torch.tpu.store import TorchStorage
from zipkin_tpu_torch.workload import generate, slice_columns


@pytest.fixture
def observed():
    was = OBSERVATORY.enabled
    OBSERVATORY.set_enabled(True)
    yield
    OBSERVATORY.set_enabled(was)


def _wire(n: int, seed: int):
    return route_fused(slice_columns(generate(n, seed=seed).cols, 0, n), 1)[0]


def _stats(agg):
    return {v: agg._step[v].program_stats for v in agg._step}


def test_a_capture_is_a_compile_and_a_step_capture_after_boot_a_recompile(monkeypatch, observed):
    _stand_in_cuda(monkeypatch)
    store = TorchStorage(config=CFG, device="cpu", pad_to_multiple=64)
    agg = store.agg
    stats = _stats(agg)
    state = agg.states[0]
    plain = (False, False)
    program = _recorded(shard_program(CFG, *plain))
    before = store.ingest_counters()
    try:
        # a boot capture (as capture_steps makes on a card): a compile
        agg.graphs.capture(plain, 0, state, 64, program)
        assert (stats[plain].compiles, stats[plain].recompiles) == (1, 0)
        # a step at a captured lane count replays; before boot a step that
        # has to capture compiles but does not recompile
        agg.graphs.step(plain, 0, state, _wire(64, 1), program)
        agg.graphs.step(plain, 0, state, _wire(128, 2), program)
        assert (stats[plain].compiles, stats[plain].recompiles) == (2, 0)
        # the store's boot captures are done (nothing to capture on the CPU)
        assert store.capture_steps([64]) == 0
        agg.graphs.step(plain, 0, state, _wire(64, 3), program)
        agg.graphs.step(plain, 0, state, _wire(128, 4), program)
        assert (stats[plain].compiles, stats[plain].recompiles) == (2, 0)
        # a lane count nobody captured, inside a step after boot: a recompile
        agg.graphs.step(plain, 0, state, _wire(192, 5), program)
        assert (stats[plain].compiles, stats[plain].recompiles) == (3, 1)
        assert stats[plain].compile_wall_s > 0.0
        assert all(s.compiles == 0 for v, s in stats.items() if v != plain)
        assert agg.graphs.captures == 3
        after = store.ingest_counters()
        assert after["deviceCompiles"] - before["deviceCompiles"] == 3
        assert after["deviceRecompiles"] - before["deviceRecompiles"] == 1
        row = OBSERVATORY.programs()["spmd_step"]
        assert row["compiles"] >= 3 and row["recompiles"] >= 1
    finally:
        # the observatory is process-global: leave no count for later tests
        for s in stats.values():
            s.reset()
        store.close()


def test_captures_count_nothing_while_the_observatory_is_off(monkeypatch):
    _stand_in_cuda(monkeypatch)
    was = OBSERVATORY.enabled
    agg = TorchAggregator(CFG, device="cpu")
    plain = (False, False)
    program = _recorded(shard_program(CFG, *plain))
    stats = _stats(agg)[plain]
    try:
        OBSERVATORY.set_enabled(False)
        agg.capture_steps([64])
        agg.graphs.step(plain, 0, agg.states[0], _wire(64, 6), program)
        assert agg.graphs.captures == 1 and stats.compiles == stats.recompiles == 0
        OBSERVATORY.set_enabled(True)
        agg.graphs.step(plain, 0, agg.states[0], _wire(128, 7), program)
        assert agg.graphs.captures == 2 and (stats.compiles, stats.recompiles) == (1, 1)
    finally:
        OBSERVATORY.set_enabled(was)
        stats.reset()

"""The static-shape, in-place ingest step and the captured-graph plumbing
around it, on the CPU.

- ``ingest.ingest_step`` (no host live count; the ring append through
  ``ops/ring_kernel.py``, pad lanes dropped) against the reference's
  jitted ``ingest_step``, every integer leaf bit for bit after every
  batch: pads in the middle, an all-pad batch, a full batch, a ring wrap,
  sampling on and off;
- every state leaf keeps its storage (``data_ptr``) through the step, the
  flush, the rollup, ``set_sampler_tables`` and a snapshot restore — a
  captured CUDA graph replays the addresses it saw;
- an index past ``digest_buffer`` raises on the CPU, and the aggregator's
  flush invariant keeps every step below it;
- :class:`StepGraphs`' replay, launch and invalidation bookkeeping, with a
  stand-in graph (a CUDA graph captures only on a card): a graph is
  captured before it first runs, so a capture that fails leaves the state
  and the aggregator's bookkeeping as they were;
- a capture and a device-wide sync take turns (``graphs.CAPTURE_LOCK``):
  a sync on another thread while a stream captures would break the
  capture and leave its pool marked as recording;
- the boot captures' lane ladder, and the per-device words' memo.
"""

from __future__ import annotations

import contextlib
import dataclasses
import tempfile
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_cpu  # noqa: F401  (one intra-op thread a test process)
from zipkin_tpu.tpu import ingest as jing
from zipkin_tpu.tpu.state import AggConfig as JConfig
from zipkin_tpu.tpu.state import init_state as jinit_state
from zipkin_tpu_torch import convert, kernels, u32
from zipkin_tpu_torch.ops import hll_kernel, ring_kernel
from zipkin_tpu_torch.parallel.aggregator import TorchAggregator, shard_program, unfuse_columns
from zipkin_tpu_torch.tpu import ingest as ing
from zipkin_tpu_torch.tpu import graphs as graphs_mod
from zipkin_tpu_torch.tpu import snapshot
from zipkin_tpu_torch.tpu.columnar import fuse_columns, route_fused
from zipkin_tpu_torch.tpu.graphs import Captured, StepGraphs, addresses
from zipkin_tpu_torch.tpu.state import CTR_SAMPLED_KEPT, AggConfig, AggState, init_state
from zipkin_tpu_torch.workload import generate, slice_columns

JBASE = dict(
    max_services=16, max_keys=64, hll_precision=6, digest_centroids=8,
    digest_buffer=1024, ring_capacity=256, link_buckets=4, bucket_minutes=10,
    hist_slices=3, hist_slice_minutes=5, time_buckets=4, time_bucket_minutes=3,
    time_digest_centroids=4,
)
CFG = AggConfig(**JBASE)


def _valid(pattern: str, n: int, rng) -> np.ndarray:
    return {"full": np.ones(n, bool), "all_pad": np.zeros(n, bool),
            "pads_in_the_middle": np.r_[np.ones(n // 3, bool), np.zeros(n // 3, bool),
                                        rng.random(n - 2 * (n // 3)) < 0.7]}[pattern]


def _batch(cols, lo: int, pattern: str, rng, n: int = 96):
    """A 96-lane host batch whose valid lanes follow ``pattern`` (an
    invalid lane is a pad: the packer zeroes it)."""
    sub = slice_columns(cols, lo, lo + n)
    valid = _valid(pattern, n, rng) & sub.valid
    return type(sub)(*(np.where(valid, f, 0).astype(f.dtype) for f in sub))


@pytest.mark.parametrize("sampling", [False, True])
def test_static_shape_step_equals_the_references_step(sampling):
    jcfg = JConfig(**JBASE, sampling=sampling)
    cfg = AggConfig(**dataclasses.asdict(jcfg))
    rng = np.random.default_rng(7 + sampling)
    cols = generate(1200, seed=5, services=12, names_per_service=4, minutes=20).cols
    jstep = jax.jit(lambda s, b: jing.ingest_step(jcfg, s, b))
    jstate = jinit_state(jcfg)
    if sampling:  # tables that drop some lanes and keep others
        s, k = cfg.max_services, cfg.max_keys
        tables = dict(s_rate=rng.integers(0, 1 << 16, s, dtype=np.uint32),
                      s_tail=rng.integers(0, 1 << 12, k, dtype=np.uint32),
                      s_link=rng.integers(0, 8, (s, s), dtype=np.uint32))
        jstate = jstate._replace(**{f: jnp.asarray(v) for f, v in tables.items()})
    (state,) = convert.state_from_numpy([np.asarray(a)[None] for a in jstate], cfg, device="cpu")
    leaves0 = addresses(state)
    patterns = ["pads_in_the_middle", "full", "all_pad", "full", "pads_in_the_middle",
                "full", "full", "pads_in_the_middle"]  # the ring of 256 wraps twice
    lo, live = 0, 0
    for step, pattern in enumerate(patterns):
        sub = _batch(cols, lo, pattern, rng)
        lo += 96
        live += int(sub.valid.sum())
        jstate = jstep(jstate, sub)
        out = ing.ingest_step(cfg, state, unfuse_columns(u32.from_numpy(fuse_columns(sub), "cpu")))
        assert out is state and addresses(state) == leaves0
        for name, got in zip(AggState._fields, convert.state_to_numpy([state])):
            want = np.asarray(getattr(jstate, name))[None]
            if name in ("digest", "tb_digest"):
                np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=f"{name} after step {step}")
            else:
                np.testing.assert_array_equal(got, want, err_msg=f"{name} after {pattern} step {step}")
    assert live > cfg.ring_capacity * 2
    kept = int(np.asarray(jstate.counters)[CTR_SAMPLED_KEPT])
    assert (0 < kept < live) if sampling else kept == 0


def _drive(agg: TorchAggregator, cols, lanes: int, steps: int, start: int = 0) -> int:
    lo = start
    for _ in range(steps):
        agg.ingest(slice_columns(cols, lo, lo + lanes, pad_to=lanes))
        lo += lanes
    return lo


def test_every_leaf_keeps_its_storage_through_the_programs_and_a_restore():
    from zipkin_tpu_torch.tpu.store import TorchStorage

    cfg = dataclasses.replace(CFG, sampling=True)
    store = TorchStorage(config=cfg, device="cpu", pad_to_multiple=64)
    agg = store.agg
    st = agg.states[0]
    leaves0 = addresses(st)
    cols = generate(4096, seed=9, services=12, names_per_service=4, minutes=20).cols
    lo = _drive(agg, cols, 128, 12)  # past the flush and the rollup cadence (1024, 128)
    assert agg.ctx_stats["ctx_advances"] >= 2 and addresses(agg.states[0]) == leaves0
    ing.flush_digest(cfg, st)
    ing.rollup_step(cfg, st)
    agg.flush_now()
    agg.rollup_now()
    rng = np.random.default_rng(1)
    agg.set_sampler_tables(rng.integers(0, 1 << 16, cfg.max_services, dtype=np.uint32),
                           rng.integers(0, 1 << 20, cfg.max_keys, dtype=np.uint32),
                           rng.integers(0, 8, (cfg.max_services,) * 2, dtype=np.uint32))
    assert agg.states[0] is st and addresses(st) == leaves0
    assert int(st.s_link.sum()) > 0
    with tempfile.TemporaryDirectory() as d:
        snapshot.save(store, d)
        saved = convert.state_to_numpy(agg.states)
        _drive(agg, cols, 128, 3, start=lo)
        assert snapshot.maybe_restore(store, d)
    assert agg.states[0] is st and addresses(st) == leaves0
    for name, got, want in zip(AggState._fields, convert.state_to_numpy(agg.states), saved):
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_an_index_past_the_digest_buffer_raises_and_the_aggregator_never_reaches_it(monkeypatch):
    state = init_state(CFG, "cpu")
    cols = generate(512, seed=2, services=12, names_per_service=4).cols
    batch = unfuse_columns(u32.from_numpy(fuse_columns(slice_columns(cols, 0, 128)), "cpu"))
    state.pend_pos.fill_(CFG.digest_buffer - 64)
    with pytest.raises((IndexError, RuntimeError)):
        ing.ingest_step(CFG, state, batch)

    seen = []
    append = ing._digest_append

    def watched(config, st, key, *a, **k):
        seen.append(int(st.pend_pos) + key.shape[0])
        return append(config, st, key, *a, **k)

    monkeypatch.setattr(ing, "_digest_append", watched)
    agg = TorchAggregator(CFG, device="cpu")
    cols = generate(6000, seed=4, services=12, names_per_service=4, minutes=20).cols
    lo, rng = 0, np.random.default_rng(0)
    ident_svc = np.arange(1 << 16, dtype=np.uint32)
    ident_key = np.arange(CFG.max_keys, dtype=np.uint32)
    while lo + 300 < cols.size:
        sizes = rng.integers(10, 60, rng.integers(1, 3))
        parts = []
        for n in sizes:
            parts.append((fuse_columns(slice_columns(cols, lo, lo + int(n)))[None], ident_svc, ident_key))
            lo += int(n)
        v = cols.valid[lo - int(sizes.sum()):lo]
        agg.ingest_fused_multi(parts, int(v.sum()), 0, 0, pad_to_multiple=32)
    assert len(seen) > 40 and max(seen) <= CFG.digest_buffer
    assert agg.ctx_stats["ctx_advances"] >= 2


class _StandIn:
    """A captured graph's stand-in: counts its replays."""

    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_step_graphs_replay_counts_launches_and_refuses_swapped_leaves():
    agg = TorchAggregator(CFG, device="cpu")
    state = agg.states[0]
    wire = route_fused(slice_columns(generate(64, seed=1).cols, 0, 64), 1)[0]
    graphs = StepGraphs()
    key = ((False, False), wire.shape[-1], 0)
    fake = _StandIn()
    graphs._graphs[key] = Captured(fake, {ring_kernel.append: 1, hll_kernel.update_step: 1},
                                   addresses(state))
    before = (ring_kernel.append.launches, hll_kernel.update_step.launches)
    graphs.step((False, False), 0, state, wire, program=None)
    graphs.step((False, False), 0, state, wire, program=None)
    assert fake.replays == 2 and graphs.replays == 2
    assert (ring_kernel.append.launches, hll_kernel.update_step.launches) == \
        (before[0] + 2, before[1] + 2)
    # the replay's input is the wire image's bits
    assert torch.equal(graphs._inputs[(wire.shape[-1], 0)], u32.upload_bits(wire, "cpu"))
    swapped = state._replace(counters=state.counters.clone())
    with pytest.raises(RuntimeError, match="swapped"):
        graphs.step((False, False), 0, swapped, wire, program=None)
    graphs.drop()
    assert len(graphs) == 0 and not graphs._inputs


def test_replacing_the_states_drops_the_graphs():
    agg = TorchAggregator(CFG, device="cpu")
    agg.graphs._graphs["k"] = Captured(_StandIn(), {}, ())
    agg.states = list(agg.states)
    assert len(agg.graphs) == 0


def test_a_capture_records_launches_instead_of_counting_them():
    before = ring_kernel.append.launches
    with kernels.recording_launches() as tally:
        kernels.count_launch(ring_kernel.append)
        kernels.count_launch(ring_kernel.append)
        with pytest.raises(RuntimeError, match="already recording"):
            with kernels.recording_launches():
                pass
    assert tally == {ring_kernel.append: 2} and ring_kernel.append.launches == before
    kernels.add_launches(tally)
    kernels.count_launch(ring_kernel.append)
    assert ring_kernel.append.launches == before + 3


class _RecordingGraph:
    """A CUDA graph's stand-in for the CPU: while it captures, the stand-in
    program below records its step instead of running it; a replay runs
    what was recorded."""

    capturing = None

    def __init__(self):
        self.recorded = []

    def capture_begin(self, pool=None, capture_error_mode=None):
        assert capture_error_mode == "thread_local"
        _RecordingGraph.capturing = self

    def capture_end(self):
        _RecordingGraph.capturing = None

    def replay(self):
        for thunk in self.recorded:
            thunk()


def _stand_in_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _RecordingGraph)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "Stream", lambda d: object())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: (0, 1))


def _recorded(program, fail_in_capture: bool = False):
    def run(state, bits):
        graph = _RecordingGraph.capturing
        if graph is None:
            return program(state, bits)
        if fail_in_capture:
            raise RuntimeError("operation not permitted when stream is capturing")
        graph.recorded.append(lambda: program(state, bits))
    return run


def test_a_failed_capture_leaves_the_state_and_keeps_no_graph(monkeypatch):
    _stand_in_cuda(monkeypatch)
    agg = TorchAggregator(CFG, device="cpu")
    state = agg.states[0]
    before = [t.clone() for t in state]
    wire = route_fused(slice_columns(generate(64, seed=3).cols, 0, 64), 1)[0]
    graphs = StepGraphs()
    program = shard_program(CFG, False, False)
    warmups = ring_kernel.append.launches, getattr(ring_kernel.append, "warmups", 0)
    with pytest.raises(RuntimeError, match="capturing"):
        graphs.step((False, False), 0, state, wire, _recorded(program, fail_in_capture=True))
    # the warm-up ran on a scratch copy, the capture raised: nothing of
    # the state changed and no graph is kept
    assert all(torch.equal(a, b) for a, b in zip(before, state))
    assert len(graphs) == 0 and graphs.captures == 0 and graphs.replays == 0
    # a capture that works records the step, and its first replay runs it
    # (the warm-up is once a process for these shapes)
    graphs.step((False, False), 0, state, wire, _recorded(program))
    assert len(graphs) == 1 and graphs.captures == 1 and graphs.replays == 1
    want = init_state(CFG, "cpu")
    program(want, u32.upload_bits(wire, "cpu"))
    assert all(torch.equal(a, b) for a, b in zip(want, state))
    assert ring_kernel.append.launches == warmups[0]  # the plain twin ran: no kernel launched
    # the aggregator's bookkeeping comes after its step: a step that raises
    # leaves it as it was
    pend, version, counters = agg._pend_lanes, agg.write_version, dict(agg.host_counters)

    def failing(*a):
        raise RuntimeError("capture failed")

    agg._step[(False, False)] = failing
    with pytest.raises(RuntimeError, match="capture failed"):
        agg.ingest_fused(route_fused(slice_columns(generate(64, seed=3).cols, 0, 64), 1), 64, 0, 0)
    assert (agg._pend_lanes, agg.write_version, agg.host_counters) == (pend, version, counters)


def test_a_capture_and_a_device_sync_take_turns(monkeypatch):
    _stand_in_cuda(monkeypatch)
    held = []

    class _Checking(_RecordingGraph):
        def capture_begin(self, pool=None, capture_error_mode=None):
            held.append(graphs_mod.CAPTURE_LOCK.locked())
            super().capture_begin(pool, capture_error_mode)

        def capture_end(self):
            held.append(graphs_mod.CAPTURE_LOCK.locked())
            super().capture_end()

    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Checking)
    state = TorchAggregator(CFG, device="cpu").states[0]
    wire = route_fused(slice_columns(generate(64, seed=5).cols, 0, 64), 1)[0]
    graphs = StepGraphs()
    graphs.step((False, False), 0, state, wire, _recorded(shard_program(CFG, False, False)))
    assert held == [True, True] and not graphs_mod.CAPTURE_LOCK.locked()

    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda d=None: synced.append(graphs_mod.CAPTURE_LOCK.locked()))
    on_card = types.SimpleNamespace(mesh=[torch.device("cuda", 0)])
    with graphs_mod.CAPTURE_LOCK:  # another thread's capture in progress
        t = threading.Thread(target=TorchAggregator.block_until_ready, args=(on_card,))
        t.start()
        t.join(0.2)
        assert t.is_alive() and not synced
    t.join(10)
    assert not t.is_alive() and synced == [True]


def test_a_warm_up_counts_its_launches_apart():
    before = ring_kernel.append.launches, getattr(ring_kernel.append, "warmups", 0)
    with kernels.warming_up():
        kernels.count_launch(ring_kernel.append)
    kernels.count_launch(ring_kernel.append)
    assert (ring_kernel.append.launches, ring_kernel.append.warmups) == (before[0] + 1, before[1] + 1)


def test_capture_steps_captures_nothing_on_the_cpu_and_the_ladder_is_lane_buckets():
    from zipkin_tpu_torch.tpu.store import TorchStorage

    store = TorchStorage(config=CFG, device="cpu", pad_to_multiple=64)
    cap = store.agg.lane_cap
    lanes = store.step_lanes()
    assert lanes == sorted({ing.lane_bucket(n, 64, cap) for n in range(1, cap + 1)})
    assert lanes[0] == 64 and lanes[-1] == cap
    assert store.capture_steps() == 0 and len(store.agg.graphs) == 0
    with pytest.raises(ValueError, match="lanes a shard"):
        store.agg.capture_steps([cap + 1])


def test_device_words_are_one_zeroed_set_per_key_and_device():
    a = kernels.device_words(("test", 3), "cpu", 8)
    assert a.dtype == torch.int32 and a.shape == (8,) and not a.any()
    a[0] = 5
    assert kernels.device_words(("test", 3), torch.device("cpu"), 8) is a
    assert kernels.device_words(("test", 4), "cpu", 8) is not a

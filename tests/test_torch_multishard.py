"""TorchAggregator over a shard mesh against ShardedAggregator over the
8-virtual-device CPU mesh (the reference's ``shard_map`` programs and its
psum / pmax / all-gather merges).

The port's mesh repeats the CPU (``make_mesh(S, devices=["cpu"] * S)``);
the reference's is ``make_mesh(S)``. The same seeded traffic (the port's
``workload.generate``) goes through both in 1,024-span host batches that
each routes trace-affine itself, plus one coalesced step of routed
images through ``ingest_fused_multi``. Then:

- bit for bit: the merged histograms, HLL registers and counters (all of
  them, ``CTR_BATCHES`` included, which grows by S a step), the dependency
  matrices and compacted edges (fresh and rolled-only), the windowed
  histograms, the time tier's epochs, registers, calls and errors, and the
  counts of every quantile read;
- the digest reads (``merged_digest``, digest quantiles, the overview's
  quantiles, the tier digest) within the tolerance the port's one-shard
  parity tests use: weights exact, means and quantiles rtol 1e-5 (cluster
  sums accumulate in another order than XLA's); hist quantiles rtol 1e-6
  (the same float32 interpolation over exact counts, its ops in another
  order) and HLL estimates rtol 1e-6 (a float32 harmonic sum in another
  order), as the one-shard tests hold them;
- the port at 8 shards against the port at 1 shard on the merges that are
  shard-invariant, as the reference's ``TestShardedParity`` asserts;
- a reference 8-shard state carried into the port through ``convert``.

The small config of ``tests/test_multichip.py`` carries the S = 8 and S = 2
comparisons; a tiny ring (``TINY``) at S = 2 makes the in-step flush and
rollup fire, the ring wrap and the rolled-only read path serve, and is
compared leaf by leaf.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

import tests.torch_cpu  # noqa: F401  (one intra-op thread a test process)
from zipkin_tpu.parallel.mesh import make_mesh as jax_mesh
from zipkin_tpu.parallel.sharded import ShardedAggregator
from zipkin_tpu.tpu.state import AggConfig as JConfig
from zipkin_tpu_torch import convert, readpack
from zipkin_tpu_torch.obs.device import OBSERVATORY
from zipkin_tpu_torch.parallel.aggregator import TorchAggregator
from zipkin_tpu_torch.parallel.mesh import make_mesh
from zipkin_tpu_torch.tpu.columnar import route_fused
from zipkin_tpu_torch.tpu.state import CTR_BATCHES, AggConfig, AggState
from zipkin_tpu_torch.workload import BASE_MINUTE, generate, slice_columns

JCFG = JConfig(max_services=64, max_keys=256, hll_precision=9, digest_centroids=32,
               ring_capacity=1 << 13)
CFG = AggConfig(**dataclasses.asdict(JCFG))
JTINY = JConfig(
    max_services=16, max_keys=64, hll_precision=6, digest_centroids=8,
    digest_buffer=512, ring_capacity=512, link_buckets=4, bucket_minutes=10,
    hist_slices=3, hist_slice_minutes=5, time_buckets=4, time_bucket_minutes=3,
    time_digest_centroids=4,
)
TINY = AggConfig(**dataclasses.asdict(JTINY))
QS = [0.5, 0.9, 0.99]
FLOAT_LEAVES = {"digest", "tb_digest"}
FULL = (0, (1 << 32) - 1)
WINDOWS = [FULL, (BASE_MINUTE, BASE_MINUTE + 6), (BASE_MINUTE + 20, BASE_MINUTE + 35)]
IDENT_SVC = np.arange(1 << 16, dtype=np.uint32)


def cpu_mesh(n):
    return make_mesh(n, devices=["cpu"] * n)


def traffic(n=3072, seed=3, services=40, names=5, minutes=40):
    return generate(n, seed=seed, services=services, names_per_service=names, minutes=minutes)


def feed(aggs, cols, n_shards, cfg, batch=1024):
    """1,024-span host batches through ``ingest`` (each routes); the
    second-to-last batch arrives as two routed chunk images coalesced into
    one step through ``ingest_fused_multi``. Returns the step count."""
    ident_key = np.arange(cfg.max_keys, dtype=np.uint32)
    starts = list(range(0, cols.size, batch))
    for i, lo in enumerate(starts):
        hi = min(lo + batch, cols.size)
        if i == len(starts) - 2:
            mid = lo + (hi - lo) // 2
            live = cols.valid[lo:hi]
            ts = cols.ts_min[lo:hi][live]
            counts = (int(live.sum()), int((live & cols.has_dur[lo:hi]).sum()),
                      int((live & cols.err[lo:hi]).sum()), (int(ts.min()), int(ts.max())))
            for agg in aggs:
                parts = [(route_fused(slice_columns(cols, a, b), n_shards), IDENT_SVC, ident_key)
                         for a, b in ((lo, mid), (mid, hi))]
                agg.ingest_fused_multi(parts, *counts)
        else:
            sub = slice_columns(cols, lo, hi)
            for agg in aggs:
                agg.ingest(sub)
    return len(starts)


def assert_digest_close(g, w, what):
    assert g.dtype == w.dtype and g.shape == w.shape, what
    np.testing.assert_array_equal(g[..., 1], w[..., 1], err_msg=f"{what} weights")
    np.testing.assert_allclose(g[..., 0], w[..., 0], rtol=1e-5, err_msg=f"{what} means")


def assert_exact(g, w, what):
    assert g.dtype == w.dtype and g.shape == w.shape, (what, g.dtype, w.dtype, g.shape, w.shape)
    np.testing.assert_array_equal(g, w, err_msg=what)


def assert_reads_match(port, ref, windows=WINDOWS, tt_epochs=None):
    """Every aggregate read of the port against the reference's."""
    for g, w, name in zip(port.merged_sketches(), ref.merged_sketches(),
                          ("hist", "hll", "counters")):
        assert_exact(g, w, f"merged {name}")
    (pq, pn), (rq, rn) = port.quantiles(QS, "hist"), ref.quantiles(QS, "hist")
    np.testing.assert_allclose(pq, rq, rtol=1e-6, err_msg="hist quantiles")
    assert_exact(pn, rn, "hist counts")
    (pq, pn), (rq, rn) = port.quantiles(QS, "digest"), ref.quantiles(QS, "digest")
    np.testing.assert_allclose(pq, rq, rtol=1e-5, err_msg="digest quantiles")
    assert_exact(pn, rn, "digest counts")
    np.testing.assert_allclose(port.cardinalities(), ref.cardinalities(), rtol=1e-6)
    (pq, pn, pe), (rq, rn, re) = port.sketch_overview(QS), ref.sketch_overview(QS)
    np.testing.assert_allclose(pq, rq, rtol=1e-5, err_msg="overview quantiles")
    assert_exact(pn, rn, "overview counts")
    np.testing.assert_allclose(pe, re, rtol=1e-6, err_msg="overview estimates")
    assert_digest_close(port.merged_digest(), ref.merged_digest(), "merged digest")
    for lo, hi in windows:
        assert port.window_fully_rolled(lo, hi) == ref.window_fully_rolled(lo, hi)
        for g, w in zip(port.dependency_edges(lo, hi), ref.dependency_edges(lo, hi)):
            assert_exact(g, w, f"edges {lo}-{hi}")
        for g, w in zip(port.dependency_matrices(lo, hi), ref.dependency_matrices(lo, hi)):
            assert_exact(g, w, f"matrices {lo}-{hi}")
        assert_exact(port.windowed_histograms(lo, hi), ref.windowed_histograms(lo, hi),
                     f"windowed histograms {lo}-{hi}")
        (pq, pn), (rq, rn) = (port.quantiles(QS, ts_lo_min=lo, ts_hi_min=hi),
                              ref.quantiles(QS, ts_lo_min=lo, ts_hi_min=hi))
        np.testing.assert_allclose(pq, rq, rtol=1e-6, err_msg=f"windowed quantiles {lo}-{hi}")
        assert_exact(pn, rn, f"windowed counts {lo}-{hi}")
    for lo_ep, hi_ep in tt_epochs or [(0, (1 << 31) - 1)]:
        got, want = port.tt_read(lo_ep, hi_ep), ref.tt_read(lo_ep, hi_ep)
        for name, g, w in zip(("epochs", "hll", "digest", "calls", "errs"), got, want):
            if name == "digest":
                assert_digest_close(g, w, f"tt digest {lo_ep}-{hi_ep}")
            else:
                assert_exact(g, w, f"tt {name} {lo_ep}-{hi_ep}")


def assert_leaves_match(got, want, what):
    """Stacked per-shard leaves: integer leaves exact, digests within the
    tolerance."""
    for name, g, w in zip(AggState._fields, got, want):
        if name in FLOAT_LEAVES:
            assert_digest_close(g, w, f"{name} {what}")
        else:
            assert_exact(g, w, f"{name} {what}")


class _Fed:
    """One class-scoped pair fed the same traffic."""

    def __init__(self, n_shards, cfg=CFG, jcfg=JCFG, **gen):
        self.n_shards = n_shards
        self.port = TorchAggregator(cfg, mesh=cpu_mesh(n_shards))
        self.ref = ShardedAggregator(jcfg, mesh=jax_mesh(n_shards))
        self.traffic = traffic(**gen)
        self.steps = feed([self.port, self.ref], self.traffic.cols, n_shards, cfg)


@pytest.fixture(scope="class")
def eight():
    return _Fed(8)


@pytest.fixture(scope="class")
def two():
    return _Fed(2)


class TestEightShards:
    def test_mesh_and_states_live_on_the_mesh(self, eight):
        port = eight.port
        assert port.n_shards == eight.ref.n_shards == 8 and len(port.states) == 8
        assert all(s.hll.device.type == "cpu" for s in port.states)
        assert not hasattr(port, "state")  # one layout: the per-shard list

    def test_counters_step_every_shard(self, eight):
        _, _, ctr = eight.port.merged_sketches()
        assert ctr[CTR_BATCHES] == 8 * eight.steps
        assert eight.port.host_counters == eight.ref.host_counters
        # every shard stepped, one with no live lane of a step included
        per_shard = [int(s.counters[CTR_BATCHES]) for s in eight.port.states]
        assert per_shard == [eight.steps] * 8

    def test_reads_match_reference(self, eight):
        assert_reads_match(eight.port, eight.ref)

    def test_state_leaves_match_reference(self, eight):
        got, want = eight.port.state_arrays(), eight.ref.state_arrays()
        assert all(g.shape[0] == 8 for g in got)
        assert_leaves_match(got, want, "8 shards")

    def test_bookkeeping_matches_reference(self, eight):
        port, ref = eight.port, eight.ref
        assert (port._pend_lanes, port._lanes_since_rollup, port._tt_max_epoch) == \
               (ref._pend_lanes, ref._lanes_since_rollup, ref._tt_max_epoch)
        assert [(lo, hi, list(c)) for lo, hi, c in port._resident] == \
               [(lo, hi, list(c)) for lo, hi, c in ref._resident]

    def test_reads_make_one_transfer_each(self, eight):
        port = eight.port
        for fn in (port.merged_sketches, port.merged_digest, port.cardinalities,
                   lambda: port.quantiles(QS, "digest"), lambda: port.sketch_overview(QS),
                   lambda: port.dependency_edges(*FULL), lambda: port.tt_read(0, 1 << 30)):
            t0, r0 = readpack.transfer_count(), port.read_stats["host_transfers"]
            fn()
            assert readpack.transfer_count() - t0 == 1
            assert port.read_stats["host_transfers"] - r0 == 1

    def test_eight_shards_equal_one_shard(self, eight):
        one = TorchAggregator(CFG, mesh=cpu_mesh(1))
        feed([one], eight.traffic.cols, 1, CFG)
        h1, r1, c1 = one.merged_sketches()
        h8, r8, c8 = eight.port.merged_sketches()
        assert_exact(h8, h1, "hist")
        assert_exact(r8, r1, "hll")
        assert_exact(c8[:4], c1[:4], "span counters")
        assert c8[CTR_BATCHES] == 8 * c1[CTR_BATCHES]
        for g, w in zip(eight.port.dependency_matrices(*FULL), one.dependency_matrices(*FULL)):
            assert_exact(g, w, "dependency matrices")
        for g, w in zip(eight.port.dependency_edges(*FULL), one.dependency_edges(*FULL)):
            assert_exact(g, w, "dependency edges")
        lo, hi = WINDOWS[1]
        assert_exact(eight.port.windowed_histograms(lo, hi), one.windowed_histograms(lo, hi),
                     "windowed histograms")
        assert_exact(eight.port.cardinalities(), one.cardinalities(), "cardinalities")
        e8, e1 = eight.port.tt_read(0, 1 << 30), one.tt_read(0, 1 << 30)
        for i in (0, 1, 3, 4):
            assert_exact(e8[i], e1[i], f"tt part {i}")

    def test_reference_state_carried_through_convert(self, eight):
        leaves = eight.ref.state_arrays()
        states = convert.state_from_numpy(leaves, CFG, mesh=cpu_mesh(8))
        assert len(states) == 8
        back = convert.state_to_numpy(states)
        for name, b, w in zip(AggState._fields, back, leaves):
            assert_exact(b, np.asarray(w), f"{name} round trip")
        port = TorchAggregator(CFG, mesh=cpu_mesh(8))
        port.states = states
        port.sync_pend_lanes()
        ref = eight.ref
        assert port._pend_lanes == ref._pend_lanes
        for g, w in zip(port.merged_sketches(), ref.merged_sketches()):
            assert_exact(g, w, "carried merged sketches")
        assert_digest_close(port.merged_digest(), ref.merged_digest(), "carried digest")
        for g, w in zip(port.dependency_edges(*FULL), ref.dependency_edges(*FULL)):
            assert_exact(g, w, "carried edges")
        with pytest.raises(ValueError, match="shards"):
            convert.state_from_numpy(leaves, CFG, mesh=cpu_mesh(2))


class TestTwoShards:
    def test_reads_match_reference(self, two):
        _, _, ctr = two.port.merged_sketches()
        assert ctr[CTR_BATCHES] == 2 * two.steps
        assert_reads_match(two.port, two.ref)

    def test_state_leaves_match_reference(self, two):
        assert_leaves_match(two.port.state_arrays(), two.ref.state_arrays(), "2 shards")


def test_maintenance_wrap_and_rolled_reads_match_reference_at_two_shards():
    """A tiny ring at S = 2: the in-step flush and rollup fire, each
    shard's ring wraps, the rolled-only path serves; the explicit flush,
    rollup and the sampler-table publish reach every shard."""
    cols = generate(1600, seed=11, services=12, names_per_service=4, minutes=40).cols
    port = TorchAggregator(TINY, mesh=cpu_mesh(2))
    ref = ShardedAggregator(JTINY, mesh=jax_mesh(2))
    ident_key = np.arange(TINY.max_keys, dtype=np.uint32)
    lo, step = 0, 0
    while lo < cols.size:
        hi = min(lo + (96, 120, 64)[step % 3], cols.size)
        if step % 4 == 3:
            parts = [(route_fused(slice_columns(cols, a, b), 2, pad_to_multiple=64),
                      IDENT_SVC, ident_key)
                     for a, b in ((lo, (lo + hi) // 2), ((lo + hi) // 2, hi))]
            live = cols.valid[lo:hi]
            ts = cols.ts_min[lo:hi][live]
            args = (int(live.sum()), int((live & cols.has_dur[lo:hi]).sum()),
                    int((live & cols.err[lo:hi]).sum()), (int(ts.min()), int(ts.max())))
            for agg in (port, ref):
                agg.ingest_fused_multi([(f.copy(), s, k) for f, s, k in parts], *args)
        else:
            batch = slice_columns(cols, lo, hi)
            port.ingest(batch)
            ref.ingest(batch)
        lo, step = hi, step + 1
        if step % 6 == 0:
            assert_leaves_match(port.state_arrays(), ref.state_arrays(), f"step {step}")
    assert port.ctx_stats["ctx_advances"] == ref.ctx_stats["ctx_advances"] >= 4
    assert port.host_counters == ref.host_counters
    windows = WINDOWS + [(BASE_MINUTE, BASE_MINUTE + 2)]
    ep = BASE_MINUTE // TINY.time_bucket_minutes
    assert_reads_match(port, ref, windows, tt_epochs=[(0, (1 << 31) - 1), (ep + 12, ep + 13)])
    assert port.read_stats["rolled_only_reads"] == ref.read_stats["rolled_only_reads"] > 0
    rng = np.random.default_rng(5)
    rate = rng.integers(0, 1 << 16, TINY.max_services, dtype=np.uint32)
    tail = rng.integers(1, 1 << 20, TINY.max_keys, dtype=np.uint32)
    link = rng.integers(0, 8, (TINY.max_services, TINY.max_services), dtype=np.uint32)
    for agg in (port, ref):
        agg.set_sampler_tables(rate, tail, link)
        agg.rollup_now()
        agg.flush_now()
    assert_leaves_match(port.state_arrays(), ref.state_arrays(), "after rollup, flush, tables")
    assert_reads_match(port, ref, windows)


@pytest.mark.parametrize("n_shards", [1, 8])
def test_merged_sketches_runs_under_spmd_merge_with_one_transfer(n_shards):
    """``merged_sketches`` is one ``spmd_merge`` program call and one
    packed transfer a read, at one shard and at eight."""
    agg = TorchAggregator(TINY, mesh=cpu_mesh(n_shards))
    agg.ingest(slice_columns(traffic(256, services=12, names=4).cols, 0, 256))
    stats = agg._p["spmd_merge"].program_stats
    for _ in range(3):
        c0, t0 = stats.calls, readpack.transfer_count()
        n0 = OBSERVATORY.programs()["spmd_merge"]["calls"]
        hist, regs, ctr = agg.merged_sketches()
        assert stats.calls - c0 == 1
        assert OBSERVATORY.programs()["spmd_merge"]["calls"] - n0 == 1
        assert readpack.transfer_count() - t0 == 1
    assert ctr[CTR_BATCHES] == n_shards and int(hist.sum()) > 0


def test_mesh_refuses_more_shards_than_devices_and_needs_the_card(monkeypatch):
    import torch

    assert make_mesh(3, devices=["cpu"] * 4) == [torch.device("cpu")] * 3
    with pytest.raises(ValueError, match="requested 5 devices, have 4"):
        make_mesh(5, devices=["cpu"] * 4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_mesh()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_mesh(2)
    with pytest.raises(RuntimeError):
        make_mesh(1, devices=["cuda:0"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchAggregator(TINY)


class _Log:
    """A WAL hook that keeps every record's image bytes and counts."""

    def __init__(self):
        self.records = []

    def __call__(self, fused, n_spans, n_dur, n_err, ts_range, extra=None):
        f = np.ascontiguousarray(fused, np.uint32)
        self.records.append((f.shape, f.tobytes(), n_spans, n_dur, n_err,
                             None if ts_range is None else tuple(int(x) for x in ts_range),
                             None if extra is None else sorted(extra.items())))
        return len(self.records)


def test_sampled_step_verdicts_and_compaction_match_reference_at_two_shards():
    """With sampling on at S = 2 the host sampler scores ``[S, 11, per]``
    images, tallies them and compacts each shard's kept lanes for the WAL
    as the reference does (``sharded.py:782-799``); the published tables
    reach every shard, so the device verdicts (``r_keep``) agree too."""
    from zipkin_tpu.sampling.reference import HostSampler as JHostSampler
    from zipkin_tpu_torch.sampling import HostSampler

    jcfg = dataclasses.replace(JTINY, sampling=True, sample_rare_min=2)
    cfg = AggConfig(**dataclasses.asdict(jcfg))
    port = TorchAggregator(cfg, mesh=cpu_mesh(2))
    ref = ShardedAggregator(jcfg, mesh=jax_mesh(2))
    port.sampler = HostSampler(cfg.max_services, cfg.max_keys, cfg.sample_rare_min)
    ref.sampler = JHostSampler(cfg.max_services, cfg.max_keys, cfg.sample_rare_min)
    port.wal_hook, ref.wal_hook = _Log(), _Log()
    rng = np.random.default_rng(9)
    rate = rng.integers(0, 1 << 16, cfg.max_services, dtype=np.uint32)
    tail = rng.integers(1, 1 << 22, cfg.max_keys, dtype=np.uint32)
    link = rng.integers(0, 4, (cfg.max_services, cfg.max_services), dtype=np.uint32)
    for agg in (port, ref):
        agg.sampler.set_tables(rate, tail, link)
        agg.set_sampler_tables(agg.sampler.rate, agg.sampler.tail, agg.sampler.link)
    cols = generate(960, seed=21, services=12, names_per_service=4, minutes=20).cols
    for lo in range(0, cols.size, 96):
        batch = slice_columns(cols, lo, min(lo + 96, cols.size))
        port.ingest(batch)
        ref.ingest(batch)
    assert port.host_counters == ref.host_counters
    assert 0 < port.host_counters["sampledKept"] < port.host_counters["spans"]
    assert len(port.wal_hook.records) == len(ref.wal_hook.records) > 0
    assert port.wal_hook.records == ref.wal_hook.records
    assert all(r[0][0] == 2 for r in port.wal_hook.records)
    assert_leaves_match(port.state_arrays(), ref.state_arrays(), "sampled, 2 shards")


def test_shards_without_live_lanes_step_as_the_reference_does():
    """A batch of one trace reaches one shard of eight: the other seven
    still step (their batch counter, pending cursor and digest lanes
    advance; their time-tier and slice epochs stay), as the reference's
    ``shard_map`` steps every shard."""
    cols = generate(256, seed=13, services=12, names_per_service=4, minutes=20).cols
    port = TorchAggregator(TINY, mesh=cpu_mesh(8))
    ref = ShardedAggregator(JTINY, mesh=jax_mesh(8))
    for lo, hi in ((0, 128), (128, 136), (136, 256)):
        batch = slice_columns(cols, lo, hi)
        port.ingest(batch)
        ref.ingest(batch)
        if hi - lo == 8:
            image = route_fused(batch, 8)
            assert int(((image[:, 10, :] & 1).sum(axis=1) > 0).sum()) == 1
    assert_leaves_match(port.state_arrays(), ref.state_arrays(), "after a one-trace batch")
    assert [int(s.counters[CTR_BATCHES]) for s in port.states] == [3] * 8
    assert_reads_match(port, ref)


def test_one_shard_state_arrays_have_the_references_shard_axis():
    """One state layout: at one shard the port's leaves carry the leading
    shard axis of one, as ``ShardedAggregator(cfg, make_mesh(1))`` gives
    them, leaf for leaf in shape and dtype, before and after the same
    batch, and ``state_clone`` gives the list of per-shard states."""
    port = TorchAggregator(TINY, device="cpu")
    ref = ShardedAggregator(JTINY, mesh=jax_mesh(1))
    batch = slice_columns(traffic(n=256, services=12, minutes=20).cols, 0, 256)
    for when in ("fresh", "after a batch"):
        if when != "fresh":
            port.ingest(batch)
            ref.ingest(batch)
        got, want = port.state_arrays(), [np.asarray(w) for w in ref.state_arrays()]
        assert len(got) == len(want) == len(AggState._fields)
        for name, g, w in zip(AggState._fields, got, want):
            assert g.shape == w.shape and g.shape[0] == 1, (when, name, g.shape, w.shape)
            assert g.dtype == w.dtype, (when, name, g.dtype, w.dtype)
        assert_leaves_match(got, want, when)
    clone, _, _ = port.state_clone()
    assert isinstance(clone, list) and len(clone) == 1 and isinstance(clone[0], AggState)
    (back,) = convert.state_from_numpy(port.state_arrays(), TINY, device="cpu")
    assert_leaves_match(convert.state_to_numpy([back]), port.state_arrays(), "round trip")

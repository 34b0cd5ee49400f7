"""TorchAggregator (device="cpu") against a one-shard ShardedAggregator.

The same seeded wire images go through both, with the time tier on, in
enough batches that the digest flush and the link rollup fire several
times and the ring wraps more than twice; some batches arrive through
``ingest_fused_multi``. Every state leaf is compared through
``convert.state_to_numpy`` and every read as it goes:

- integer leaves and reads (HLL registers, histograms, ring, rollups,
  time-tier planes, counters, epochs, pending buffer, ctx_*, edge
  matrices and triples) bit-exact;
- float32 digests: weights (integer-valued sums) exact, means rtol 1e-5
  (cluster sums accumulate in another order than XLA's einsum/scatter);
- digest quantiles rtol 1e-5 (interpolation over those means), hist
  quantiles rtol 1e-6 (same float32 ops), HLL estimates rtol 1e-6 (a
  float32 harmonic sum in another order).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

import tests.torch_cpu  # noqa: F401  (one intra-op thread a test process)
from zipkin_tpu.parallel.mesh import make_mesh
from zipkin_tpu.parallel.sharded import ShardedAggregator
from zipkin_tpu.tpu.state import AggConfig as JConfig
from zipkin_tpu_torch import convert
from zipkin_tpu_torch.parallel.aggregator import TorchAggregator
from zipkin_tpu_torch.tpu.columnar import fuse_columns
from zipkin_tpu_torch.tpu.state import LEAF_DTYPES, AggConfig, AggState
from zipkin_tpu_torch.workload import BASE_MINUTE, generate, slice_columns

JCFG = JConfig(
    max_services=16, max_keys=64, hll_precision=6, digest_centroids=8,
    digest_buffer=512, ring_capacity=512, link_buckets=4, bucket_minutes=10,
    hist_slices=3, hist_slice_minutes=5, time_buckets=4, time_bucket_minutes=3,
    time_digest_centroids=4,
)
CFG = AggConfig(**dataclasses.asdict(JCFG))
QS = [0.5, 0.9, 0.99]
FLOAT_LEAVES = {"digest", "tb_digest"}


@pytest.fixture(scope="module")
def traffic():
    return generate(1600, seed=11, services=12, names_per_service=4, minutes=40)


def assert_states_match(port: TorchAggregator, ref: ShardedAggregator, where: str) -> None:
    got = convert.state_to_numpy(port.states)
    want = ref.state_arrays()
    for name, g, w in zip(AggState._fields, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, (name, g.dtype, w.dtype, g.shape, w.shape)
        if name in FLOAT_LEAVES:
            np.testing.assert_array_equal(g[..., 1], w[..., 1], err_msg=f"{name} weights {where}")
            np.testing.assert_allclose(g[..., 0], w[..., 0], rtol=1e-5, err_msg=f"{name} {where}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{name} {where}")


def assert_reads_match(port, ref, where: str, windows) -> None:
    for source in ("hist", "digest"):
        (pq, pn), (rq, rn) = port.quantiles(QS, source), ref.quantiles(QS, source)
        np.testing.assert_allclose(pq, rq, rtol=1e-5 if source == "digest" else 1e-6,
                                   err_msg=f"{source} quantiles {where}")
        np.testing.assert_array_equal(pn, rn, err_msg=f"{source} counts {where}")
    np.testing.assert_allclose(port.cardinalities(), ref.cardinalities(), rtol=1e-6)
    pq, pn, pe = port.sketch_overview(QS)
    rq, rn, re = ref.sketch_overview(QS)
    np.testing.assert_allclose(pq, rq, rtol=1e-5)
    np.testing.assert_array_equal(pn, rn)
    np.testing.assert_allclose(pe, re, rtol=1e-6)
    pd, rd = port.merged_digest(), ref.merged_digest()
    np.testing.assert_array_equal(pd[..., 1], rd[..., 1])
    np.testing.assert_allclose(pd[..., 0], rd[..., 0], rtol=1e-5)
    for lo, hi in windows:
        assert port.window_fully_rolled(lo, hi) == ref.window_fully_rolled(lo, hi)
        for g, w in zip(port.dependency_edges(lo, hi), ref.dependency_edges(lo, hi)):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w, err_msg=f"edges {lo}-{hi} {where}")
        for g, w in zip(port.dependency_matrices(lo, hi), ref.dependency_matrices(lo, hi)):
            np.testing.assert_array_equal(g, w, err_msg=f"matrices {lo}-{hi} {where}")
        np.testing.assert_array_equal(port.windowed_histograms(lo, hi),
                                      ref.windowed_histograms(lo, hi))
        (pq, pn), (rq, rn) = port.quantiles(QS, ts_lo_min=lo, ts_hi_min=hi), \
            ref.quantiles(QS, ts_lo_min=lo, ts_hi_min=hi)
        np.testing.assert_allclose(pq, rq, rtol=1e-6)
        np.testing.assert_array_equal(pn, rn)


def test_aggregator_matches_reference_through_flush_rollup_and_wraps(traffic):
    ref = ShardedAggregator(JCFG, mesh=make_mesh(1))
    port = TorchAggregator(CFG, device="cpu")
    cols = traffic.cols
    ident_svc = np.arange(1 << 16, dtype=np.uint32)
    ident_key = np.arange(CFG.max_keys, dtype=np.uint32)
    windows = [(0, (1 << 32) - 1), (BASE_MINUTE, BASE_MINUTE + 6),
               (BASE_MINUTE + 30, BASE_MINUTE + 45)]
    lo, step = 0, 0
    while lo < cols.size:
        size = (88, 120, 64)[step % 3]
        hi = min(lo + size, cols.size)
        batch = slice_columns(cols, lo, hi, pad_to=128)
        if step % 4 == 3:  # two chunks coalesced into one step
            mid = (hi - lo) // 2
            parts = []
            for a, b in ((lo, lo + mid), (lo + mid, hi)):
                chunk = slice_columns(cols, a, b, pad_to=64)
                parts.append((fuse_columns(chunk)[None], ident_svc, ident_key))
            live = batch.valid
            ts = batch.ts_min[live]
            args = (int(live.sum()), int((live & batch.has_dur).sum()),
                    int((live & batch.err).sum()), (int(ts.min()), int(ts.max())))
            for agg in (port, ref):
                agg.ingest_fused_multi([(f.copy(), s, k) for f, s, k in parts], *args)
        else:
            port.ingest(batch)
            ref.ingest(batch)
        lo, step = hi, step + 1
        assert_states_match(port, ref, f"after step {step}")
        if step % 5 == 0:
            assert_reads_match(port, ref, f"after step {step}", windows)
            assert_states_match(port, ref, f"after reads at step {step}")
    assert port.ctx_stats["ctx_advances"] >= 4
    assert port.host_counters == ref.host_counters
    assert port.read_stats["rolled_only_reads"] == ref.read_stats["rolled_only_reads"] > 0
    port.rollup_now()
    ref.rollup_now()
    port.flush_now()
    ref.flush_now()
    assert_states_match(port, ref, "after explicit rollup + flush")
    assert_reads_match(port, ref, "at the end", windows)


def test_state_round_trips_through_convert(traffic):
    """Reference leaves -> port state -> leaves: identical arrays, the
    one-shard axis kept; the port continues from that state."""
    ref = ShardedAggregator(JCFG, mesh=make_mesh(1))
    ref.ingest(slice_columns(traffic.cols, 0, 200, pad_to=256))
    leaves = ref.state_arrays()
    states = convert.state_from_numpy(leaves, CFG, device="cpu")
    back = convert.state_to_numpy(states)
    for name, b, w in zip(AggState._fields, back, leaves):
        assert b.dtype == LEAF_DTYPES[name]
        np.testing.assert_array_equal(b, w, err_msg=name)
    port = TorchAggregator(CFG, device="cpu")
    port.states = states
    port._pend_lanes = ref._pend_lanes
    port._lanes_since_rollup = ref._lanes_since_rollup
    batch = slice_columns(traffic.cols, 200, 400, pad_to=256)
    port.ingest(batch)
    ref.ingest(batch)
    assert_states_match(port, ref, "after resuming from converted state")


def test_lane_cap_and_bucket_ladder():
    port = TorchAggregator(CFG, device="cpu")
    assert port.lane_cap == 256
    with pytest.raises(ValueError):
        port.ingest_fused(np.zeros((1, 11, 512), np.uint32), 0, 0, 0)
    from zipkin_tpu.tpu import ingest as jing
    from zipkin_tpu_torch.tpu import ingest as ing
    for lanes in (1, 255, 256, 257, 1000, 70000):
        for cap in (256, 1 << 17):
            assert ing.lane_bucket(lanes, 256, cap) == jing.lane_bucket(lanes, 256, cap)

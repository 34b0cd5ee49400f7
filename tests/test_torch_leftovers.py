"""The reference's library functions that the port's main path never
called, ported for completeness and held to the reference on seeded
inputs, integers bit for bit: ``columnar.route_columns`` (and the same
routing as ``route_fused``), ``SpanColumns.concat``/``.live``,
``Vocab.key_ids_for_service``, ``hashing.hash4``,
``segments.segment_sum_scatter``, ``faults.armed_site`` and
``tpu/ingest.py``'s ``key_quantiles``, ``key_quantiles_digest`` and
``cardinalities``."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import tests.torch_cpu  # noqa: F401  (one intra-op thread a test process)
import jax.numpy as jnp
from zipkin_tpu import faults as jfaults
from zipkin_tpu.ops import hashing as jhashing
from zipkin_tpu.ops import segments as jsegments
from zipkin_tpu.tpu import columnar as jcol
from zipkin_tpu_torch import faults
from zipkin_tpu_torch.ops import hashing, segments
from zipkin_tpu_torch.tpu import columnar


def random_columns(rng: np.random.Generator, n: int) -> dict:
    u32 = lambda: rng.integers(0, 1 << 32, n, dtype=np.uint32)  # noqa: E731
    return dict(
        trace_h=u32(), tl0=u32(), tl1=u32(), s0=u32(), s1=u32(), p0=u32(), p1=u32(),
        shared=rng.integers(0, 2, n).astype(bool),
        kind=rng.integers(0, 5, n).astype(np.int32),
        svc=rng.integers(0, 1 << 16, n).astype(np.int32),
        rsvc=rng.integers(0, 1 << 16, n).astype(np.int32),
        key=rng.integers(0, 1 << 24, n).astype(np.int32),
        err=rng.integers(0, 2, n).astype(bool),
        dur=u32(),
        has_dur=rng.integers(0, 2, n).astype(bool),
        ts_min=u32(),
        valid=rng.integers(0, 2, n).astype(bool),
    )


def both(fields: dict):
    return jcol.SpanColumns(**fields), columnar.SpanColumns(**fields)


def assert_columns_equal(ref, port):
    assert ref._fields == port._fields
    for name, a, b in zip(ref._fields, ref, port):
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("n", [0, 1, 1000, 4096])
@pytest.mark.parametrize("shards", [1, 2, 8])
def test_route_columns_matches_reference(n, shards):
    ref, port = both(random_columns(np.random.default_rng(n * 31 + shards), n))
    assert_columns_equal(jcol.route_columns(ref, shards), columnar.route_columns(port, shards))


@pytest.mark.parametrize("shards", [2, 4, 8])
def test_route_columns_is_route_fused_routing(shards):
    _, port = both(random_columns(np.random.default_rng(shards), 3000))
    via_cols = columnar.fuse_columns(columnar.route_columns(port, shards))
    np.testing.assert_array_equal(via_cols, columnar.route_fused(port, shards))


@pytest.mark.parametrize("seed", [0, 1])
def test_concat_and_live_match_reference(seed):
    rng = np.random.default_rng(seed)
    ra, pa = both(random_columns(rng, 700))
    rb, pb = both(random_columns(rng, 300))
    assert_columns_equal(ra.concat(rb), pa.concat(pb))
    assert pa.live == ra.live == int(np.count_nonzero(pa.valid))
    assert pa.concat(pb).live == ra.concat(rb).live


def test_live_refuses_a_device_batch():
    # on a batch of tensors the count would be a hidden wait for the card
    import torch

    from zipkin_tpu_torch.parallel.aggregator import unfuse_columns
    from zipkin_tpu_torch import u32

    _, port = both(random_columns(np.random.default_rng(3), 64))
    batch = unfuse_columns(u32.from_numpy(columnar.fuse_columns(port), "cpu"))
    assert isinstance(batch.valid, torch.Tensor)
    with pytest.raises(TypeError, match="host columns"):
        batch.live


def test_key_ids_for_service_matches_reference():
    rng = np.random.default_rng(5)
    ref, port = jcol.Vocab(max_services=64, max_keys=512), columnar.Vocab(max_services=64,
                                                                          max_keys=512)
    services = [f"svc-{i}" for i in range(12)]
    names = [f"op-{i}" for i in range(40)]
    for s, nm in zip(rng.choice(services, 300), rng.choice(names, 300)):
        for v in (ref, port):
            v.key_id(v.services.intern(s), v.span_names.intern(nm))
    assert port.num_keys == ref.num_keys
    for sid in range(-1, len(services) + 2):
        assert port.key_ids_for_service(sid) == ref.key_ids_for_service(sid)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hash4_matches_reference(seed):
    rng = np.random.default_rng(seed)
    lanes = [rng.integers(0, 1 << 32, 4096, dtype=np.uint32) for _ in range(4)]
    lanes[0][:4] = [0, 1, 0xFFFFFFFF, 0x9E3779B9]
    want = np.asarray(jhashing.hash4(*(jnp.asarray(x) for x in lanes)))
    got = hashing.hash4(*(torch.from_numpy(x.astype(np.int64)) for x in lanes))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
    assert int(got.min()) >= 0 and int(got.max()) < (1 << 32)


@pytest.mark.parametrize("shape", [(2000,), (2000, 3)])
def test_segment_sum_scatter_matches_reference(shape):
    rng = np.random.default_rng(len(shape))
    vals = rng.integers(-1000, 1000, shape).astype(np.int32)
    ids = rng.integers(-80, 80, shape[0]).astype(np.int32)  # negatives wrap, |id| > 64 drops
    want = np.asarray(jsegments.segment_sum_scatter(jnp.asarray(vals), jnp.asarray(ids), 64))
    got = segments.segment_sum_scatter(torch.from_numpy(vals), torch.from_numpy(ids), 64)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_segment_sum_scatter_floats_match_reference():
    rng = np.random.default_rng(9)
    vals = rng.standard_normal(500).astype(np.float32)
    ids = rng.integers(0, 16, 500).astype(np.int32)
    want = np.asarray(jsegments.segment_sum_scatter(jnp.asarray(vals), jnp.asarray(ids), 16))
    got = segments.segment_sum_scatter(torch.from_numpy(vals), torch.from_numpy(ids), 16)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


def test_armed_site_matches_reference():
    sites = [s for s in faults.SITES if s in jfaults.SITES][:3]
    assert len(sites) == 3
    try:
        for mod in (faults, jfaults):
            mod.disarm()
        assert faults.armed_site() is None and jfaults.armed_site() is None
        for i, site in enumerate(sites):
            faults.arm(site, nth=i + 2)
            jfaults.arm(site, nth=i + 2)
            assert faults.armed_site() == jfaults.armed_site() == sites[0]
        faults.arm_corrupt(sorted(faults.CORRUPT_SITES)[0])
        assert faults.armed_site() == sites[0]
    finally:
        faults.disarm()
        jfaults.disarm()
    assert faults.armed_site() is None


def test_ingest_reads_match_reference():
    """``tpu/ingest.py``'s three one-line reads on one state's leaves in
    both packages: histogram quantiles bit for bit; HLL estimates within
    1e-6 (a float32 harmonic sum in another order than XLA's); digest
    quantiles inside the digest's own rank band of each other."""
    from zipkin_tpu.tpu import ingest as jingest
    from zipkin_tpu.tpu.state import AggState as JState
    from zipkin_tpu_torch import convert
    from zipkin_tpu_torch.ops import tdigest
    from zipkin_tpu_torch.parallel.aggregator import TorchAggregator
    from zipkin_tpu_torch.tpu import ingest
    from zipkin_tpu_torch.tpu.state import AggConfig
    from zipkin_tpu_torch.workload import generate, slice_columns

    cfg = AggConfig(max_services=16, max_keys=64, hll_precision=6, digest_centroids=8,
                    digest_buffer=512, ring_capacity=512, time_buckets=0)
    agg = TorchAggregator(cfg, device="cpu")
    cols = generate(1200, seed=5, services=12, names_per_service=4).cols
    for lo in range(0, cols.size, 100):
        agg.ingest(slice_columns(cols, lo, min(lo + 100, cols.size), pad_to=128))
    agg.flush_now()
    leaves = convert.state_to_numpy(agg.states)
    state = agg.states[0]
    jstate = JState(*(jnp.asarray(leaf[0]) for leaf in leaves))
    qs = np.array([0.1, 0.5, 0.9, 0.99], np.float32)

    got = ingest.key_quantiles(state, torch.from_numpy(qs)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jingest.key_quantiles(jstate, jnp.asarray(qs))))
    np.testing.assert_allclose(ingest.cardinalities(state).numpy(),
                               np.asarray(jingest.cardinalities(jstate)), rtol=1e-6)
    got = ingest.key_quantiles_digest(state, torch.from_numpy(qs)).numpy()
    want = np.asarray(jingest.key_quantiles_digest(jstate, jnp.asarray(qs)))
    # both values of a key and quantile sit within the rank band of each
    # other among that key's durations
    key_counts = np.bincount(cols.key[cols.valid], minlength=cfg.max_keys)
    for k in np.nonzero(key_counts >= 20)[0]:
        d = np.sort(cols.dur[cols.valid & (cols.key == k)].astype(np.float64))
        for j, q in enumerate(qs):
            w = tdigest.cluster_q_width(cfg.digest_centroids, float(q))
            rank = lambda v: np.searchsorted(d, float(v)) / len(d)  # noqa: E731
            assert abs(rank(got[k, j]) - rank(want[k, j])) <= w, (k, q, got[k, j], want[k, j])

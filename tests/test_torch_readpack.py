"""The port's one-transfer read path and its state hooks.

1. ``zipkin_tpu_torch.readpack``: pack/unpack round trips for every dtype
   code at ndim 0-4, the same ZPK1 header words as the reference's
   ``readpack.pack`` and bit-equal payloads, zero-copy views.
2. Every ``TorchAggregator`` read makes exactly one
   ``readpack.device_get``, seen by both ``transfer_count()`` and
   ``read_stats["host_transfers"]`` (a flush inside a read makes none).
3. ``merged_sketches``, ``state_clone``, ``sync_pend_lanes`` and
   ``warm_programs`` against a one-shard ``ShardedAggregator``.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_cpu  # noqa: F401  (one intra-op thread a test process)
from zipkin_tpu import readpack as jreadpack
from zipkin_tpu.parallel.mesh import make_mesh
from zipkin_tpu.parallel.sharded import ShardedAggregator
from zipkin_tpu.tpu.state import AggConfig as JConfig
from zipkin_tpu_torch import convert, readpack
from zipkin_tpu_torch.parallel.aggregator import TorchAggregator
from zipkin_tpu_torch.tpu.state import AggConfig, AggState
from zipkin_tpu_torch.workload import BASE_MINUTE, generate, slice_columns

SHAPES = {0: (), 1: (7,), 2: (3, 5), 3: (2, 3, 3), 4: (2, 1, 3, 2)}
DTYPES = [np.uint8, np.uint32, np.int32, np.float32, np.bool_, np.uint64, np.int64, np.float64]


def _values(dtype, shape, rng):
    n = int(np.prod(shape, dtype=np.int64))
    if dtype == np.bool_:
        return rng.random(shape) < 0.5
    if dtype in (np.float32, np.float64):
        return rng.standard_normal(n).reshape(shape).astype(dtype)
    info = np.iinfo(dtype)
    a = rng.integers(info.min, info.max, n, dtype=dtype, endpoint=True).reshape(shape)
    if n:
        a.flat[0] = info.max  # the top bit of a u32 must survive
    return a


def _as_port(a: np.ndarray) -> torch.Tensor:
    """The port's tensor form: u32 as int64 values, u64 as int64 bits."""
    if a.dtype == np.uint32:
        return torch.from_numpy(a.astype(np.int64))
    if a.dtype == np.uint64:
        return torch.from_numpy(a.view(np.int64).copy())
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("ndim", sorted(SHAPES))
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_round_trip_every_dtype_and_ndim(dtype, ndim):
    rng = np.random.default_rng(ndim)
    a = _values(dtype, SHAPES[ndim], rng)
    buf = readpack.pack([_as_port(a), _as_port(a[..., :1] if ndim else a)], [dtype, dtype])
    assert buf.dtype == torch.int32 and buf.dim() == 1
    host = readpack.device_get(buf)
    got, second = readpack.unpack(host)
    assert got.dtype == np.dtype(dtype) and got.shape == a.shape
    np.testing.assert_array_equal(got, a)
    assert second.shape == (a[..., :1] if ndim else a).shape
    assert got.base is not None  # a view into the one buffer


def _reference_sections(rng):
    return [
        rng.integers(0, 1 << 32, (3, 5), dtype=np.uint32),
        rng.integers(-(1 << 31), 1 << 31, 9, dtype=np.int32),
        rng.standard_normal((2, 3, 4)).astype(np.float32),
        rng.integers(0, 256, 13, dtype=np.uint8),
        rng.random((2, 3)) < 0.5,
        np.uint32(0xFFFFFFFF),
        np.float32(-3.5),
    ]


@pytest.mark.parametrize("seed", [0, 1])
def test_header_and_payload_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    arrays = _reference_sections(rng)
    want = np.asarray(jreadpack.pack([jnp.asarray(a) for a in arrays]))
    got = readpack.device_get(readpack.pack([_as_port(np.asarray(a)) for a in arrays],
                                            [np.asarray(a).dtype for a in arrays]))
    header_words = 2 + 8 * len(arrays)
    np.testing.assert_array_equal(got[:header_words], want[:header_words])
    np.testing.assert_array_equal(got, want)  # every payload bit-equal too
    for g, w in zip(jreadpack.unpack(got), readpack.unpack(want)):
        np.testing.assert_array_equal(g, w)
    assert readpack.describe(got) == jreadpack.describe(want)


def test_bad_input_is_refused():
    with pytest.raises(ValueError, match="magic"):
        readpack.unpack(np.zeros(16, np.uint32))
    with pytest.raises(NotImplementedError):
        readpack.pack([torch.zeros(4)], [np.float16])
    with pytest.raises(ValueError, match="ndim"):
        readpack.pack([torch.zeros((1,) * 5)], [np.float32])
    with pytest.raises(ValueError, match="dtypes"):
        readpack.pack([torch.zeros(4)], [])


def test_unpack_is_zero_copy():
    buf = readpack.device_get(readpack.pack([torch.arange(8)], [np.uint32])).copy()
    (view,) = readpack.unpack(buf)
    buf[2 + 8] = 424242
    assert view.flat[0] == 424242


# -- the aggregator ----------------------------------------------------------

JCFG = JConfig(
    max_services=16, max_keys=64, hll_precision=6, digest_centroids=8,
    digest_buffer=512, ring_capacity=512, link_buckets=4, bucket_minutes=10,
    hist_slices=3, hist_slice_minutes=5, time_buckets=4, time_bucket_minutes=3,
    time_digest_centroids=4,
)
CFG = AggConfig(**dataclasses.asdict(JCFG))
QS = [0.5, 0.99]
OLD = (BASE_MINUTE, BASE_MINUTE + 2)
FULL = (0, (1 << 32) - 1)


def _cols():
    return generate(2400, seed=31, services=12, names_per_service=4, minutes=40).cols


def _feed(aggs, cols, lo, hi, step=100):
    for a in range(lo, hi, step):
        batch = slice_columns(cols, a, min(a + step, hi), pad_to=128)
        for agg in aggs:
            agg.ingest(batch)


@pytest.fixture(scope="module")
def loaded():
    """A port aggregator fed 2,000 spans over 33 minutes (the ring wrapped
    four times, so the first minutes are rolled only) and the rest of the
    stream for fresh reads."""
    cols = _cols()
    port = TorchAggregator(CFG, device="cpu")
    _feed([port], cols, 0, 2000)
    assert port.window_fully_rolled(*OLD)
    return port, cols


def _one_transfer(agg, fn):
    """fn() makes exactly one pull through the chokepoint, seen by both
    ledgers."""
    mod0 = readpack.transfer_count()
    agg0 = agg.read_stats["host_transfers"]
    out = fn()
    assert readpack.transfer_count() - mod0 == 1
    assert agg.read_stats["host_transfers"] - agg0 == 1
    return out


def _fresh_edges(agg, cols):
    """A write, then a dependency read: the fresh branch (the ctx is built)."""
    _feed([agg], cols, 2000, 2100)
    return agg.dependency_edges(*FULL)


READS = {
    "quantiles_digest": lambda a, c: a.quantiles(QS, "digest"),
    "quantiles_hist": lambda a, c: a.quantiles(QS, "hist"),
    "quantiles_windowed": lambda a, c: a.quantiles(QS, ts_lo_min=BASE_MINUTE + 20,
                                                   ts_hi_min=BASE_MINUTE + 40),
    "cardinalities": lambda a, c: a.cardinalities(),
    "sketch_overview": lambda a, c: a.sketch_overview(QS),
    "merged_digest": lambda a, c: a.merged_digest(),
    "merged_sketches": lambda a, c: a.merged_sketches(),
    "windowed_histograms": lambda a, c: a.windowed_histograms(BASE_MINUTE + 20, BASE_MINUTE + 40),
    "dependency_matrices": lambda a, c: a.dependency_matrices(*FULL),
    "dependency_edges_rolled": lambda a, c: a.dependency_edges(*OLD),
    "dependency_edges_fresh": _fresh_edges,
    "dependency_edges_cached": lambda a, c: a.dependency_edges(*FULL),
    "tt_read": lambda a, c: a.tt_read(a.tt_max_epoch - 2, a.tt_max_epoch),
}


@pytest.mark.parametrize("name", sorted(READS))
def test_every_read_makes_exactly_one_transfer(loaded, name):
    agg, cols = loaded
    before = agg.read_stats["rolled_only_reads"]
    if name in ("quantiles_digest", "sketch_overview", "tt_read"):
        _feed([agg], cols, 2100, 2200)  # pending points: the read flushes first
        assert agg._pend_lanes
    out = _one_transfer(agg, lambda: READS[name](agg, cols))
    if name == "dependency_edges_rolled":
        assert agg.read_stats["rolled_only_reads"] == before + 1
    assert agg._pend_lanes == 0 or name not in ("quantiles_digest", "sketch_overview", "tt_read")
    assert out is not None


@pytest.fixture(scope="module")
def pair():
    cols = _cols()
    port = TorchAggregator(CFG, device="cpu")
    ref = ShardedAggregator(JCFG, mesh=make_mesh(1))
    _feed([port, ref], cols, 0, 1300)
    return port, ref, cols


def test_merged_sketches_match_reference(pair):
    port, ref, _ = pair
    for g, w in zip(port.merged_sketches(), ref.merged_sketches()):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_state_clone_matches_reference_and_is_a_copy(pair):
    port, ref, cols = pair
    port.wal_seq = ref.wal_seq = 7
    clone, seq, counters = port.state_clone()
    rclone, rseq, rcounters = ref.state_clone()
    assert (seq, counters) == (rseq, rcounters)
    for name, g, w in zip(AggState._fields, convert.state_to_numpy(clone), rclone):
        w = np.asarray(w)
        if name in ("digest", "tb_digest"):
            np.testing.assert_array_equal(g[..., 1], w[..., 1], err_msg=name)
            np.testing.assert_allclose(g[..., 0], w[..., 0], rtol=1e-5, err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
    before = convert.state_to_numpy(clone)
    counters["spans"] = -1
    _feed([port, ref], cols, 1300, 1400)
    assert port.host_counters["spans"] > 0
    for name, a, b in zip(AggState._fields, before, convert.state_to_numpy(clone)):
        np.testing.assert_array_equal(a, b, err_msg=name)  # ingest left the clone alone
    assert all(x.data_ptr() != y.data_ptr() for x, y in zip(clone[0], port.states[0]))
    # state_arrays reads through a clone: the same leaves as the live state
    for a, b in zip(port.state_arrays(), convert.state_to_numpy(port.states)):
        np.testing.assert_array_equal(a, b)


def _bookkeeping(agg):
    return (agg._pend_lanes, agg._lanes_since_rollup, list(agg._resident),
            agg._tt_max_epoch, agg.write_version)


def test_sync_pend_lanes_matches_reference(pair):
    port, ref, cols = pair
    leaves = ref.state_arrays()
    port.states = convert.state_from_numpy(leaves, CFG, device="cpu")
    port._tt_max_epoch = ref._tt_max_epoch = -1
    port._pend_lanes = ref._pend_lanes = 0
    t0, r0 = readpack.transfer_count(), port.read_stats["host_transfers"]
    port.sync_pend_lanes()
    ref.sync_pend_lanes()
    assert readpack.transfer_count() - t0 == 1  # one packed pull
    assert port.read_stats["host_transfers"] == r0  # not a read
    got, want = _bookkeeping(port), _bookkeeping(ref)
    assert got[:2] == want[:2] and got[3] == want[3] > 0
    assert [(lo, hi, list(c)) for lo, hi, c in got[2]] == [(lo, hi, list(c)) for lo, hi, c in want[2]]
    assert port._pend_lanes > 0
    _feed([port, ref], cols, 1400, 1600)
    for name, g, w in zip(AggState._fields, port.state_arrays(), ref.state_arrays()):
        if name not in ("digest", "tb_digest"):
            np.testing.assert_array_equal(g, w, err_msg=name)


def test_warm_programs_matches_reference():
    cols = _cols()
    port = TorchAggregator(CFG, device="cpu")
    ref = ShardedAggregator(JCFG, mesh=make_mesh(1))
    batch = slice_columns(cols, 0, 100, pad_to=128)
    port.warm_programs(batch)
    ref.warm_programs(batch)
    assert port.host_counters == ref.host_counters
    assert port.host_counters["batches"] == 4
    assert port.ctx_stats["ctx_advances"] == ref.ctx_stats["ctx_advances"]
    assert _bookkeeping(port)[:2] == _bookkeeping(ref)[:2]
    for name, g, w in zip(AggState._fields, port.state_arrays(), ref.state_arrays()):
        if name in ("digest", "tb_digest"):
            np.testing.assert_array_equal(g[..., 1], w[..., 1], err_msg=name)
            np.testing.assert_allclose(g[..., 0], w[..., 0], rtol=1e-5, err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)

"""The port's ops (zipkin_tpu_torch/ops) against the JAX package's, on the
CPU, on the same seeded numpy inputs.

Integer outputs are held bit-exact. Float outputs state their tolerance
at the assert: where both sides compute the same float32 operations in
the same order they must agree exactly; where the summation order
differs (scatter-add vs XLA's scatter / einsum, torch.sum vs XLA's
reduce) means agree to a few float32 ulps (rtol 1e-6) and integer-valued
weights exactly.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_cpu  # noqa: F401  (one intra-op thread a test process)
from zipkin_tpu.ops import hashing as jhash
from zipkin_tpu.ops import histogram as jhist
from zipkin_tpu.ops import hll as jhll
from zipkin_tpu.ops import pallas_hll
from zipkin_tpu.ops import segments as jseg
from zipkin_tpu.ops import tdigest as jtd
from zipkin_tpu_torch import u32
from zipkin_tpu_torch.ops import hashing, histogram, hll, hll_kernel, segments, tdigest

EDGE_U32 = np.array([0, 1, 2, 3, 0x7FFFFFFF, 1 << 31, (1 << 31) + 1,
                     0xFFFFFFFE, 0xFFFFFFFF], np.uint32)


def _u32_inputs(seed: int, n: int = 4096) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.concatenate([EDGE_U32, rng.integers(0, 1 << 32, n, dtype=np.uint32)])


def _t(a: np.ndarray) -> torch.Tensor:
    """numpy -> CPU tensor under the port's dtype policy."""
    if a.dtype == np.uint32:
        return u32.from_numpy(a, "cpu")
    if a.dtype in (np.int32, np.int64):
        return torch.from_numpy(a.astype(np.int64))
    return torch.from_numpy(a.copy())


def _n(t: torch.Tensor) -> np.ndarray:
    return t.numpy()


@pytest.mark.parametrize("seed", [0, 1])
def test_hashing_bit_exact(seed):
    x = _u32_inputs(seed)
    y = _u32_inputs(seed + 10)
    np.testing.assert_array_equal(_n(hashing.fmix32(_t(x))), np.asarray(jhash.fmix32(x)))
    np.testing.assert_array_equal(_n(hashing.hash2(_t(x), _t(y))), np.asarray(jhash.hash2(x, y)))
    np.testing.assert_array_equal(_n(hashing.floor_log2(_t(x))), np.asarray(jhash.floor_log2(x)))


def test_lexsort_is_stable_unsigned_lexicographic():
    rng = np.random.default_rng(3)
    n = 3000
    lanes = [rng.choice(np.array([0, 1, 7, 1 << 31, 0xFFFFFFFF], np.uint32), n) for _ in range(4)]
    perm = _n(u32.lexsort([_t(a) for a in lanes]))
    np.testing.assert_array_equal(perm, np.lexsort(tuple(reversed(lanes))))


def _hll_batches(rows_n, n, seeds=range(3)):
    for seed in seeds:
        rng = np.random.default_rng(seed)
        rows = rng.integers(0, rows_n, n, dtype=np.int32)
        hashes = rng.integers(0, 2**32, n, dtype=np.uint32)
        valid = rng.random(n) < 0.9
        yield rows, hashes, valid


@pytest.mark.parametrize("rows_n,precision,n", [
    (33, 8, 1000), (64, 9, 2048), (7, 8, 100), (9, 6, 200),
])
def test_hll_update_matches_xla_and_pallas(rows_n, precision, n):
    """Same cases as tests/test_pallas_hll.py: the port's update (plain
    path on CPU) equals the XLA update and the Pallas kernel run in the
    Pallas interpreter, over sequential batches."""
    port = hll.new_registers(rows_n, precision, device="cpu")
    want = jhll.new_registers(rows_n, precision)
    kern = jhll.new_registers(rows_n, precision)
    for rows, hashes, valid in _hll_batches(rows_n, n):
        port = hll.update(port, _t(rows), _t(hashes), _t(valid))
        want = jhll.update(want, rows, hashes, valid)
        kern = pallas_hll.update(kern, rows, hashes, valid, interpret=True)
    np.testing.assert_array_equal(_n(port), np.asarray(want))
    np.testing.assert_array_equal(_n(port), np.asarray(kern))


def test_hll_update_takes_the_kernels_int32_form():
    """The kernel reads i32 rows and the u32 hash bits as i32
    (``u32.bits32``); the plain path gives the same registers for that
    form as for int64 values, exactly."""
    rows_n, precision = 33, 8
    wide = hll.new_registers(rows_n, precision, device="cpu")
    narrow = hll.new_registers(rows_n, precision, device="cpu")
    for rows, hashes, valid in _hll_batches(rows_n, 1000):
        hashes[:len(EDGE_U32)] = EDGE_U32
        wide = hll.update(wide, _t(rows), _t(hashes), _t(valid))
        h32 = u32.bits32(_t(hashes))
        assert h32.dtype == torch.int32
        np.testing.assert_array_equal(h32.numpy().view(np.uint32), hashes)
        narrow = hll.update(narrow, torch.from_numpy(rows), h32, _t(valid))
    np.testing.assert_array_equal(_n(narrow), _n(wide))


def test_hll_invalid_lanes_are_inert_and_launches_not_counted_on_cpu():
    regs = hll.new_registers(16, 8, device="cpu")
    before = hll_kernel.update.launches
    out = hll.update(regs, torch.zeros(64, dtype=torch.int64),
                     torch.full((64,), 0xDEADBEEF, dtype=torch.int64),
                     torch.zeros(64, dtype=torch.bool))
    assert int(out.sum()) == 0
    assert hll_kernel.update.launches == before  # the CPU runs the plain twin


@pytest.mark.parametrize("n_distinct", [50, 3000, 200_000])
def test_hll_estimate(n_distinct):
    """Register files filled through both packages' update: equal
    registers; estimates agree to rtol 1e-6 (the harmonic sum is a
    float32 reduction whose order differs between XLA and torch)."""
    rng = np.random.default_rng(n_distinct)
    hashes = rng.integers(0, 2**32, n_distinct, dtype=np.uint32)
    rows = rng.integers(0, 5, n_distinct, dtype=np.int32)
    valid = np.ones(n_distinct, bool)
    port = hll.update(hll.new_registers(5, 11, device="cpu"), _t(rows), _t(hashes), _t(valid))
    want = jhll.update(jhll.new_registers(5, 11), rows, hashes, valid)
    np.testing.assert_array_equal(_n(port), np.asarray(want))
    np.testing.assert_allclose(_n(hll.estimate(port)), np.asarray(jhll.estimate(want)), rtol=1e-6)


def test_histogram_ops():
    rng = np.random.default_rng(5)
    n, keys = 5000, 40
    dur = np.concatenate([EDGE_U32, rng.lognormal(8, 3, n).astype(np.uint32)])
    key = rng.integers(-3, keys + 3, dur.size).astype(np.int32)
    valid = rng.random(dur.size) < 0.9
    np.testing.assert_array_equal(_n(histogram.bucket_of(_t(dur))), np.asarray(jhist.bucket_of(dur)))
    idx = np.arange(jhist.BUCKETS, dtype=np.int32)
    for got, want in zip(histogram.bucket_bounds(_t(idx)), jhist.bucket_bounds(idx)):
        np.testing.assert_array_equal(_n(got), np.asarray(want))  # same f32 ops: exact
    h = histogram.update(histogram.new_histograms(keys, device="cpu"), _t(key), _t(dur), _t(valid))
    hj = jhist.update(jhist.new_histograms(keys), key, dur, valid)
    np.testing.assert_array_equal(_n(h), np.asarray(hj))
    np.testing.assert_array_equal(_n(histogram.total_count(h)), np.asarray(jhist.total_count(hj)))
    qs = np.array([0.0, 0.5, 0.9, 0.99, 1.0], np.float32)
    # same float32 ops in the same order: within 1 ulp-level rtol 1e-6
    np.testing.assert_allclose(_n(histogram.quantile(h, _t(qs))),
                               np.asarray(jhist.quantile(hj, jnp.asarray(qs))), rtol=1e-6)


def test_segments():
    rng = np.random.default_rng(6)
    ids = np.sort(rng.integers(0, 30, 500)).astype(np.int32)
    vals = rng.integers(0, 9, 500).astype(np.float32)
    np.testing.assert_array_equal(_n(segments.segment_starts(_t(ids))),
                                  np.asarray(jseg.segment_starts(ids)))
    np.testing.assert_array_equal(_n(segments.run_start_indices(_t(ids))),
                                  np.asarray(jseg.run_start_indices(ids)))
    # integer-valued float32: every partial sum is exact on both sides
    np.testing.assert_array_equal(_n(segments.sorted_segment_cumsum(_t(vals), _t(ids))),
                                  np.asarray(jseg.sorted_segment_cumsum(vals, ids)))
    np.testing.assert_array_equal(_n(segments.sorted_segment_total(_t(vals), _t(ids))),
                                  np.asarray(jseg.sorted_segment_total(vals, ids)))


def _assert_digest_close(got: np.ndarray, want: np.ndarray) -> None:
    """Weights are integer-valued sums: exact. Means are float32 sums in
    another order: rtol 1e-6."""
    np.testing.assert_array_equal(got[..., 1], want[..., 1])
    np.testing.assert_allclose(got[..., 0], want[..., 0], rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_tdigest_compact_merge_quantile(seed):
    rng = np.random.default_rng(seed)
    slots, c, n = 12, 16, 4000
    slot = rng.integers(0, slots, n).astype(np.int32)
    vals = rng.lognormal(7, 1.5, n).astype(np.float32)
    w = (rng.random(n) < 0.8).astype(np.float32)
    vals[::97] = vals[3]  # equal means exercise the stable tie order
    part = tdigest.compact_points(_t(slot), _t(vals), _t(w), slots, c)
    jpart = jtd.compact_points(slot, vals, w, slots, c)
    _assert_digest_close(_n(part), np.asarray(jpart))

    base = tdigest.compact_points(_t(slot[::-1].copy()), _t(vals), _t(w), slots, c)
    jbase = jtd.compact_points(slot[::-1].copy(), vals, w, slots, c)
    merged = tdigest.row_merge(base, part)
    jmerged = jtd.row_merge(jbase, jpart)
    _assert_digest_close(_n(merged), np.asarray(jmerged))

    qs = np.array([0.0, 0.01, 0.5, 0.9, 0.99, 0.999, 1.0], np.float32)
    # fed the SAME digest, the interpolation is the same float32 ops
    np.testing.assert_allclose(
        _n(tdigest.quantile(torch.from_numpy(np.array(jmerged)), _t(qs))),
        np.asarray(jtd.quantile(jmerged, jnp.asarray(qs))), rtol=1e-6)
    np.testing.assert_array_equal(
        _n(tdigest._cluster_ids(_t(np.linspace(0, 1, 1001, dtype=np.float32)), c)),
        np.asarray(jtd._cluster_ids(jnp.linspace(0, 1, 1001, dtype=jnp.float32), c)))


def test_tdigest_quantile_edges():
    """jnp.interp edge rules: empty rows, single centroids, zero-width
    steps between equal cumulative weights."""
    d = np.zeros((4, 6, 2), np.float32)
    d[1, 2] = (5.0, 3.0)
    d[2, :3] = [(1.0, 1.0), (2.0, 0.0), (9.0, 2.0)]
    d[3, :] = [(float(i), 1.0) for i in range(6)]
    qs = np.array([0.0, 0.1, 0.5, 0.75, 1.0], np.float32)
    np.testing.assert_allclose(_n(tdigest.quantile(torch.from_numpy(d), _t(qs))),
                               np.asarray(jtd.quantile(d, jnp.asarray(qs))), rtol=1e-6)

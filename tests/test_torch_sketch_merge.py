"""The port's sketch merges against the reference's library functions:
``tdigest.new_digests``, ``update``, ``merge``, ``merge_many`` and
``histogram.merge``, on the cases of ``tests/test_ops_sketches.py``'s
``TestTDigest`` and ``TestHistogram.test_merge_is_addition_and_exact``,
with the same seeded numpy inputs through both packages.

Digests: weights (integer-valued sums) exact, means rtol 1e-5 (cluster
sums accumulate in another order than XLA's), quantiles rtol 1e-5 — the
tolerance of the port's other digest parity tests; each case's own
accuracy bound is asserted on the port's answer too. Histograms: exact.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_cpu  # noqa: F401  (one intra-op thread a test process)
from zipkin_tpu.ops import histogram as jhist
from zipkin_tpu.ops import tdigest as jtd
from zipkin_tpu_torch import u32
from zipkin_tpu_torch.ops import histogram, tdigest

CPU = "cpu"
# the reference's functions jitted, as its own tests run them (eager they
# take seconds a call on the CPU)
_jupdate = jax.jit(jtd.update)
_jquantile = jax.jit(jtd.quantile)
_jmerge = jax.jit(jtd.merge)


def assert_digest_close(port: torch.Tensor, ref) -> None:
    g, w = port.numpy(), np.asarray(ref)
    assert g.shape == w.shape and g.dtype == w.dtype
    np.testing.assert_array_equal(g[..., 1], w[..., 1])
    np.testing.assert_allclose(g[..., 0], w[..., 0], rtol=1e-5)


def both_update(slots, centroids, slot_ids, vals, weights):
    """(port digests, reference digests) after one update of fresh ones."""
    d_ref = jtd.new_digests(slots, centroids=centroids)
    d_port = tdigest.new_digests(slots, centroids, device=CPU)
    got = tdigest.update(d_port, torch.from_numpy(slot_ids.astype(np.int64)),
                         torch.from_numpy(vals), torch.from_numpy(weights))
    want = _jupdate(d_ref, jnp.asarray(slot_ids.astype(np.int32)), jnp.asarray(vals),
                    jnp.asarray(weights))
    return got, want


def quantiles(d_port, d_ref, qs):
    q = np.asarray(qs, np.float32)
    return (tdigest.quantile(d_port, torch.from_numpy(q)).numpy(),
            np.asarray(_jquantile(d_ref, jnp.asarray(q))))


def test_new_digests_is_zeroed_and_shaped():
    d = tdigest.new_digests(3, 16, device=CPU)
    assert d.shape == (3, 16, 2) and d.dtype == torch.float32 and not d.any()
    np.testing.assert_array_equal(d.numpy(), np.asarray(jtd.new_digests(3, centroids=16)))


def test_accuracy_streaming_matches_reference():
    rng = np.random.default_rng(5)
    d_port = tdigest.new_digests(1, 64, device=CPU)
    d_ref = jtd.new_digests(1, centroids=64)
    all_vals = []
    for _ in range(20):
        vals = np.exp(rng.normal(8, 2, 8192)).astype(np.float32)
        all_vals.append(vals)
        ones = np.ones(8192, np.float32)
        d_port = tdigest.update(d_port, torch.zeros(8192, dtype=torch.int64),
                                torch.from_numpy(vals), torch.from_numpy(ones))
        d_ref = _jupdate(d_ref, jnp.zeros(8192, jnp.int32), jnp.asarray(vals), jnp.asarray(ones))
        assert_digest_close(d_port, d_ref)
    vals = np.concatenate(all_vals)
    qs = [0.5, 0.9, 0.99]
    got, want = quantiles(d_port, d_ref, qs)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    exact = np.quantile(vals.astype(np.float64), qs)
    np.testing.assert_allclose(got[0], exact, rtol=0.05)
    assert float(d_port[..., 1].sum()) == pytest.approx(len(vals))


def test_multi_slot_isolation_matches_reference():
    slots = np.asarray([0] * 100 + [2] * 100, np.int32)
    vals = np.concatenate([np.full(100, 10.0), np.full(100, 1000.0)]).astype(np.float32)
    got, want = both_update(3, 32, slots, vals, np.ones(200, np.float32))
    assert_digest_close(got, want)
    q, qr = quantiles(got, want, [0.5])
    np.testing.assert_allclose(q, qr, rtol=1e-5)
    assert q[0, 0] == pytest.approx(10.0, rel=0.01)
    assert q[1, 0] == 0.0
    assert q[2, 0] == pytest.approx(1000.0, rel=0.01)


def _loaded(vals):
    return both_update(1, 64, np.zeros(len(vals), np.int32), vals, np.ones(len(vals), np.float32))


def test_merge_matches_combined_and_reference():
    rng = np.random.default_rng(6)
    a_vals = rng.gamma(2, 100, 20_000).astype(np.float32)
    b_vals = rng.gamma(9, 50, 20_000).astype(np.float32)
    (a, ja), (b, jb) = _loaded(a_vals), _loaded(b_vals)
    merged, jmerged = tdigest.merge(a, b), _jmerge(ja, jb)
    assert_digest_close(merged, jmerged)
    qs = [0.1, 0.5, 0.9, 0.99]
    got, want = quantiles(merged, jmerged, qs)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    exact = np.quantile(np.concatenate([a_vals, b_vals]).astype(np.float64), qs)
    np.testing.assert_allclose(got[0], exact, rtol=0.06)


@pytest.mark.parametrize("shards", [1, 2, 8])
def test_merge_many_matches_reference(shards):
    """``merge_many`` over [shards, U, C, 2]: one shard is the identity,
    more the shard-major concatenation reclustered row by row — and a
    list of per-shard digests merges the same as the stacked tensor."""
    rng = np.random.default_rng(40 + shards)
    u, c = 5, 16
    ports, refs = [], []
    for s in range(shards):
        n = 3000
        slots = rng.integers(0, u, n).astype(np.int32)
        vals = rng.lognormal(6 + s * 0.3, 1.0, n).astype(np.float32)
        w = (rng.random(n) < 0.9).astype(np.float32)
        p, r = both_update(u, c, slots, vals, w)
        ports.append(p)
        refs.append(r)
    got = tdigest.merge_many(torch.stack(ports))
    want = jtd.merge_many(jnp.stack(refs))
    assert_digest_close(got, want)
    assert_digest_close(tdigest.merge_many(ports), want)
    if shards == 1:
        np.testing.assert_array_equal(got.numpy(), ports[0].numpy())
    total = sum(float(p[..., 1].sum()) for p in ports)
    assert float(got[..., 1].sum()) == pytest.approx(total)


def test_zero_weight_lanes_inert():
    got, want = both_update(1, 16, np.zeros(8, np.int32), np.full(8, 123.0, np.float32),
                            np.zeros(8, np.float32))
    assert_digest_close(got, want)
    assert float(got[..., 1].sum()) == 0.0


def test_histogram_merge_is_addition_and_matches_reference():
    rng = np.random.default_rng(4)
    a_vals = rng.integers(1, 10**6, 10_000, np.uint32)
    b_vals = rng.integers(1, 10**6, 10_000, np.uint32)

    def load_port(vals):
        h = histogram.new_histograms(2, device=CPU)
        return histogram.update(h, torch.from_numpy((vals % 2).astype(np.int64)),
                                torch.from_numpy(vals.astype(np.int64)),
                                torch.ones(len(vals), dtype=torch.bool))

    def load_ref(vals):
        h = jhist.new_histograms(2)
        return jhist.update(h, jnp.asarray((vals % 2).astype(np.int32)), jnp.asarray(vals),
                            jnp.ones(len(vals), bool))

    merged = histogram.merge(load_port(a_vals), load_port(b_vals))
    both = load_port(np.concatenate([a_vals, b_vals]))
    np.testing.assert_array_equal(merged.numpy(), both.numpy())
    want = np.asarray(jhist.merge(load_ref(a_vals), load_ref(b_vals)))
    np.testing.assert_array_equal(merged.numpy(), want.astype(np.int64))


def test_histogram_merge_wraps_as_u32():
    """The reference's u32 add wraps; the port's int64 planes wrap with it."""
    a = np.full((1, histogram.BUCKETS), 0xFFFFFFF0, np.uint32)
    b = np.full((1, histogram.BUCKETS), 0x20, np.uint32)
    got = histogram.merge(u32.from_numpy(a, CPU), u32.from_numpy(b, CPU))
    want = np.asarray(jhist.merge(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    assert int(got.max()) == 0x10

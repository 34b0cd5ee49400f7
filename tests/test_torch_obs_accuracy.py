"""The port's accuracy plane (``zipkin_tpu_torch/obs/{shadow,accuracy}.py``
and the store's shadow tap) against the JAX package's: the same payloads
through the JAX ``TpuStorage`` on the CPU and ``TorchStorage(device="cpu")``,
each with a shadow attached, give equal shadow counters and equal accuracy
gauges — the HLL errors bit-equal from bit-equal registers, the digest
errors within their rank band — and the shadow's taps and fused image fold
keep the reference's contracts (tests/test_obs_shadow.py's specs)."""

from __future__ import annotations

import math

import numpy as np
import pytest

import tests.torch_cpu  # noqa: F401  (one intra-op thread a test process)
from zipkin_tpu.obs.accuracy import AccuracyEstimator as RefEstimator
from zipkin_tpu.obs.shadow import HostShadow as RefShadow
from zipkin_tpu.parallel.mesh import make_mesh
from zipkin_tpu.tpu.state import AggConfig as JConfig
from zipkin_tpu.tpu.store import TpuStorage
from zipkin_tpu_torch import workload
from zipkin_tpu_torch.obs.accuracy import AccuracyEstimator, _digest_quantile
from zipkin_tpu_torch.obs.shadow import HostShadow
from zipkin_tpu_torch.tpu.columnar import fuse_columns
from zipkin_tpu_torch.tpu.state import AggConfig
from zipkin_tpu_torch.tpu.store import TorchStorage

SIZES = dict(max_services=32, max_keys=256, hll_precision=10, digest_centroids=32,
             digest_buffer=1 << 13, ring_capacity=1 << 14, time_bucket_minutes=5)


def _shadow(cls, store):
    return cls(max_services=store.config.max_services, sampler_ref=lambda: store.agg.sampler,
               svc_resolver=store.vocab.services.get, link_rate=0.25, distinct_k=1024,
               bucket_minutes=store.config.time_bucket_minutes)


@pytest.fixture(scope="module")
def planes():
    traffic = workload.generate(1 << 13, seed=11, services=12, minutes=30)
    data = workload.payloads(workload.render_spans(traffic), per=1024)
    ref = TpuStorage(config=JConfig(**SIZES), mesh=make_mesh(1), pad_to_multiple=256)
    port = TorchStorage(config=AggConfig(**SIZES), device="cpu", pad_to_multiple=256)
    ref.shadow, port.shadow = _shadow(RefShadow, ref), _shadow(HostShadow, port)
    for payload in data:
        assert ref.ingest_json_fast(payload) is not None
        assert port.ingest_json_fast(payload) is not None
    ref.tt_seal()
    port.tt_seal()
    got = AccuracyEstimator(port, port.shadow, rollup_s=0.0)
    want = RefEstimator(ref, ref.shadow, rollup_s=0.0)
    yield got.rollup(), want.rollup(), got, want, port, ref
    ref.close()
    port.close()


def test_shadow_counters_equal(planes):
    *_, port, ref = planes
    got, want = port.shadow.counters(), ref.shadow.counters()
    assert got == want
    assert got["shadowSpans"] == 1 << 13 and got["shadowDroppedBatches"] == 0
    assert got["shadowWindowEpochs"] >= 2 and got["shadowLinkTraces"] > 0
    assert port.shadow.retention() == ref.shadow.retention()
    assert port.shadow.distinct_estimate() == ref.shadow.distinct_estimate()
    for svc in ref.shadow.services():
        np.testing.assert_array_equal(port.shadow.reservoir(svc).values(),
                                      ref.shadow.reservoir(svc).values())


def test_hll_gauges_bit_equal(planes):
    got, want, *_ = planes
    assert got["accuracyShadowCoverage"] == want["accuracyShadowCoverage"] == 1.0
    for key in ("accuracyHllRelErr", "accuracyHllBound", "accuracyHllDrift",
                "accuracyWindowedHllRelErr", "accuracyWindowedHllDrift",
                "accuracyLinkRecall", "accuracyRetentionBias", "accuracyRollups"):
        assert got[key] == want[key], key
    assert got["accuracyLinkRecall"] == 1.0


def test_digest_gauges_within_their_rank_band(planes):
    got, want, est, ref_est, *_ = planes
    for key in ("accuracyDigestP50RelErr", "accuracyDigestP99RelErr",
                "accuracyWindowedDigestP99RelErr"):
        # the digests differ in float summation order only; the device
        # quantile may move inside its cluster's rank band, which the
        # stated p99 bound covers
        assert abs(got[key] - want[key]) <= want["accuracyDigestP99Bound"], key
        assert got[key] <= got["accuracyDigestP99Bound"] + 0.05, key
    assert math.isclose(got["accuracyDigestP99Bound"], want["accuracyDigestP99Bound"], rel_tol=0.25)
    rows = {r["service"]: r for r in est.status()["services"]}
    ref_rows = {r["service"]: r for r in ref_est.status()["services"]}
    assert rows.keys() == ref_rows.keys() and rows
    for name, r in rows.items():
        assert r["reservoirSeen"] == ref_rows[name]["reservoirSeen"]
    assert set(est.status()) == set(ref_est.status())
    assert set(est.export_counters()) == set(ref_est.export_counters())


def test_fused_and_cols_taps_agree():
    traffic = workload.generate(1 << 11, seed=5, services=8)
    cols = traffic.cols
    a, b = HostShadow(max_services=32, link_rate=0.5), HostShadow(max_services=32, link_rate=0.5)
    a.offer_cols(cols)
    b.offer_fused(fuse_columns(cols)[None])
    assert a.drain() == b.drain() == 1
    assert a.counters() == b.counters()
    assert a.link_traces() == b.link_traces()
    ref = RefShadow(max_services=32, link_rate=0.5)
    ref.offer_cols(cols)
    ref.drain()
    assert ref.counters() == a.counters() and ref.link_traces() == a.link_traces()


def test_pending_overflow_drops_the_oldest_and_reset_clears():
    sh = HostShadow(pending_max=2)
    cols = workload.generate(64, seed=1, services=4).cols
    for _ in range(5):
        sh.offer_cols(cols)
    c = sh.counters()
    assert (c["shadowPending"], c["shadowOfferedBatches"], c["shadowDroppedBatches"]) == (2, 5, 3)
    sh.reset()
    assert sh.counters()["shadowPending"] == 0 and sh.total_seen == 0


def test_digest_quantile_is_the_reference_interpolation():
    from zipkin_tpu.obs.accuracy import _digest_quantile as ref_q

    rows = np.array([[[10.0, 1.0], [20.0, 3.0], [0.0, 0.0]], [[15.0, 2.0], [40.0, 1.0], [5.0, 1.0]]],
                    np.float32)
    for q in (0.0, 0.25, 0.5, 0.99, 1.0):
        assert _digest_quantile(rows, q) == ref_q(rows, q)


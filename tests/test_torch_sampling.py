"""The port's sampling tier against the JAX package's.

- ``device_verdict`` (port, torch) equals the JAX ``device_verdict`` and
  the port's numpy ``host_verdict`` bit for bit over seeded u32 inputs,
  edge values included (out-of-table ids, rate 0 and RATE_ONE, the
  ``s_tail`` sentinel, ``dur = 0xFFFFFFFF``);
- ``TorchAggregator(device="cpu")`` and a one-shard ``ShardedAggregator``,
  both sampling with a ``HostSampler`` and the same tables published
  twice mid-stream, hold every state leaf equal (``r_keep`` and counter
  slots 5/6 exact), the same host tallies and byte-identical WAL-hook
  records; some lanes mid-batch are invalid, so a verdict written in lane
  order instead of the ring append's order shows;
- one ``RateController.tick`` on each side publishes identical tables;
- on the port, sketches of a sampled run equal those of an unsampled run.
"""

from __future__ import annotations

import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_cpu  # noqa: F401  (one intra-op thread a test process)
from zipkin_tpu.parallel.mesh import make_mesh
from zipkin_tpu.parallel.sharded import ShardedAggregator
from zipkin_tpu.sampling import RateController as JRateController
from zipkin_tpu.sampling.device import device_verdict as jax_verdict
from zipkin_tpu.sampling.reference import HostSampler as JHostSampler
from zipkin_tpu.tpu.state import AggConfig as JConfig
from zipkin_tpu_torch import convert
from zipkin_tpu_torch.parallel.aggregator import TorchAggregator
from zipkin_tpu_torch.sampling import RATE_ONE, HostSampler, RateController, host_verdict
from zipkin_tpu_torch.sampling.device import device_verdict
from zipkin_tpu_torch.tpu.columnar import fuse_columns
from zipkin_tpu_torch.tpu.state import CTR_SAMPLED_DROPPED, CTR_SAMPLED_KEPT, AggConfig, AggState
from zipkin_tpu_torch.workload import generate, slice_columns

JCFG = JConfig(
    max_services=16, max_keys=64, hll_precision=6, digest_centroids=8,
    digest_buffer=512, ring_capacity=512, link_buckets=4, bucket_minutes=10,
    hist_slices=3, hist_slice_minutes=5, time_buckets=4, time_bucket_minutes=3,
    time_digest_centroids=4, sampling=True,
)
CFG = AggConfig(**dataclasses.asdict(JCFG))
FLOAT_LEAVES = {"digest", "tb_digest"}
FIELDS = ("trace_h", "svc", "rsvc", "key", "dur", "has_dur", "err", "valid")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_device_verdict_matches_jax_and_host_bit_for_bit(seed):
    rng = np.random.default_rng(seed)
    n, s, k = 4096, 32, 64
    f = dict(
        trace_h=rng.integers(0, 1 << 32, n, dtype=np.uint32),
        # ids past the tables' ends exercise the clip
        svc=rng.integers(0, s + 8, n).astype(np.int32),
        rsvc=rng.integers(0, s + 8, n).astype(np.int32),
        key=rng.integers(0, k + 16, n).astype(np.int32),
        dur=rng.integers(0, 1 << 32, n, dtype=np.uint32),
        has_dur=rng.random(n) < 0.8,
        err=rng.random(n) < 0.05,
        valid=rng.random(n) < 0.9,
    )
    f["dur"][::17] = 0xFFFFFFFF
    f["dur"][5::23] = 0
    rate = rng.integers(0, RATE_ONE + 1, s, dtype=np.uint32)
    rate[:4] = (0, RATE_ONE, RATE_ONE - 1, 1)
    tail = rng.integers(1, 1 << 32, k, dtype=np.uint32)
    tail[::3] = 0xFFFFFFFF  # the unreachable sentinel
    link = rng.integers(0, 10, (s, s), dtype=np.uint32)

    host = host_verdict(**f, rate=rate, tail=tail, link=link, rare_min=4)
    jax_out = np.asarray(jax_verdict(
        *(jnp.asarray(f[x]) for x in FIELDS),
        jnp.asarray(rate), jnp.asarray(tail), jnp.asarray(link), 4))
    t = {x: torch.from_numpy(f[x].astype(np.int64) if f[x].dtype != bool else f[x]) for x in FIELDS}
    port = device_verdict(
        *(t[x] for x in FIELDS),
        torch.from_numpy(rate.astype(np.int64)), torch.from_numpy(tail.astype(np.int64)),
        torch.from_numpy(link.astype(np.int64)), 4).numpy()
    np.testing.assert_array_equal(port, jax_out)
    np.testing.assert_array_equal(port, host)
    assert 0 < int(host.sum()) < int(f["valid"].sum())
    # the sentinel compare stays unsigned: a max duration meets it
    at_max = f["valid"] & f["has_dur"] & (f["dur"] == 0xFFFFFFFF)
    assert at_max.any() and port[at_max].all()


def _traffic():
    t = generate(2400, seed=5, services=12, names_per_service=4, minutes=30)
    rng = np.random.default_rng(6)
    t.cols.valid[rng.random(t.cols.size) < 0.06] = False  # holes mid-batch
    return t


def _batches(cols):
    """(lo, hi, coalesced) per step: uneven sizes, every third step as two
    chunks through ingest_fused_multi."""
    lo, step = 0, 0
    while lo < cols.size:
        hi = min(lo + (96, 120, 72)[step % 3], cols.size)
        yield lo, hi, step % 3 == 2
        lo, step = hi, step + 1


def _feed(agg, cols, lo, hi, coalesced):
    batch = slice_columns(cols, lo, hi, pad_to=128)
    if not coalesced:
        agg.ingest(batch)
        return
    ident_svc = np.arange(1 << 16, dtype=np.uint32)
    ident_key = np.arange(CFG.max_keys, dtype=np.uint32)
    mid = lo + (hi - lo) // 2
    parts = [(fuse_columns(slice_columns(cols, a, b, pad_to=64))[None], ident_svc, ident_key)
             for a, b in ((lo, mid), (mid, hi))]
    v = batch.valid
    ts = batch.ts_min[v]
    agg.ingest_fused_multi(parts, int(v.sum()), int((v & batch.has_dur).sum()),
                           int((v & batch.err).sum()), (int(ts.min()), int(ts.max())))


class WalLog:
    """A WAL hook that keeps every record as bytes."""

    def __init__(self):
        self.records = []

    def __call__(self, fused, n_spans, n_dur, n_err, ts_range, extra=None):
        f = np.ascontiguousarray(fused, np.uint32)
        self.records.append((f.shape, f.tobytes(), n_spans, n_dur, n_err,
                             None if ts_range is None else tuple(int(x) for x in ts_range),
                             None if extra is None else sorted(extra.items())))
        return len(self.records)


def _tables(rng, ref_agg, ref_sampler):
    rate = rng.integers(RATE_ONE // 8, RATE_ONE // 2, CFG.max_services, dtype=np.uint32)
    q, counts = ref_agg.quantiles([0.9], source="digest")
    tail = np.full(CFG.max_keys, 0xFFFFFFFF, np.uint32)
    have = counts > 0
    tail[have] = np.ceil(np.maximum(q[have, 0], 1.0)).astype(np.uint32)
    return rate, tail, ref_sampler.link_snapshot()


def assert_states_match(port, ref, where, skip=()):
    for name, g, w in zip(AggState._fields, port.state_arrays(), ref.state_arrays()):
        if name in skip:
            continue
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if name in FLOAT_LEAVES:
            np.testing.assert_array_equal(g[..., 1], w[..., 1], err_msg=f"{name} weights {where}")
            np.testing.assert_allclose(g[..., 0], w[..., 0], rtol=1e-5, err_msg=f"{name} {where}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{name} {where}")


@pytest.fixture(scope="module")
def sampled_pair():
    """Port and reference driven through the same sampled stream, with
    tables published twice mid-stream; returns both and their WAL logs."""
    traffic = _traffic()
    cols = traffic.cols
    ref = ShardedAggregator(JCFG, mesh=make_mesh(1))
    port = TorchAggregator(CFG, device="cpu")
    ref.sampler = JHostSampler(CFG.max_services, CFG.max_keys, CFG.sample_rare_min)
    port.sampler = HostSampler(CFG.max_services, CFG.max_keys, CFG.sample_rare_min)
    ref.wal_hook, port.wal_hook = WalLog(), WalLog()
    rng = np.random.default_rng(8)
    steps = list(_batches(cols))
    publish_at = {len(steps) // 3, 2 * len(steps) // 3}
    for i, (lo, hi, co) in enumerate(steps):
        if i in publish_at:
            rate, tail, link = _tables(rng, ref, ref.sampler)
            port.quantiles([0.9], source="digest")  # the same flush-then-read
            for agg in (ref, port):
                agg.sampler.set_tables(rate, tail, link)
                agg.set_sampler_tables(agg.sampler.rate, agg.sampler.tail, agg.sampler.link)
        _feed(ref, cols, lo, hi, co)
        _feed(port, cols, lo, hi, co)
        if i % 6 == 5:
            assert_states_match(port, ref, f"after step {i}")
    return port, ref


def test_sampled_aggregator_matches_reference(sampled_pair):
    port, ref = sampled_pair
    assert_states_match(port, ref, "at the end")
    ctr = port.state_arrays()[AggState._fields.index("counters")][0]
    kept, dropped = int(ctr[CTR_SAMPLED_KEPT]), int(ctr[CTR_SAMPLED_DROPPED])
    assert kept > 0 and dropped > 0
    assert port.host_counters == ref.host_counters
    assert (port.host_counters["sampledKept"], port.host_counters["sampledDropped"]) == (kept, dropped)
    assert port.write_version == ref.write_version


def test_wal_hook_records_are_byte_identical(sampled_pair):
    port, ref = sampled_pair
    got, want = port.wal_hook.records, ref.wal_hook.records
    assert len(got) == len(want) > 20
    markers = 0
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"WAL record {i} differs"
        markers += g[0][-1] == 0
    assert markers >= 2  # the flush-then-read of each publish logged a ttflush
    assert port.wal_seq == ref.wal_seq == len(got)


def test_r_keep_follows_the_ring_append_order():
    """Each batch's valid lanes land in the ring in order at the cursor;
    r_keep there must be the host verdict of those lanes, in that order
    (the batches have invalid lanes mid-batch, so lane order differs)."""
    cols = _traffic().cols
    agg = TorchAggregator(CFG, device="cpu")
    sampler = HostSampler(CFG.max_services, CFG.max_keys, CFG.sample_rare_min)
    rng = np.random.default_rng(3)
    sampler.set_tables(rng.integers(0, RATE_ONE, CFG.max_services, dtype=np.uint32),
                       rng.integers(1000, 20000, CFG.max_keys, dtype=np.uint32),
                       rng.integers(0, 8, (CFG.max_services,) * 2, dtype=np.uint32))
    agg.set_sampler_tables(sampler.rate, sampler.tail, sampler.link)
    want = np.zeros(CFG.ring_capacity, bool)
    cursor = 0
    for lo, hi, _ in _batches(cols):
        batch = slice_columns(cols, lo, hi, pad_to=128)
        keep = sampler.verdict_fused(fuse_columns(batch)[None])[0][batch.valid]
        want[(cursor + np.arange(keep.size)) % CFG.ring_capacity] = keep
        cursor += keep.size
        agg.ingest(batch)
        got = dict(zip(AggState._fields, convert.state_to_numpy(agg.states)))
        np.testing.assert_array_equal(got["r_keep"][0], want, err_msg=f"batch {lo}:{hi}")
    assert cursor > 3 * CFG.ring_capacity and want.any() and not want.all()


def test_rate_controller_tick_publishes_identical_tables(sampled_pair):
    port, ref = sampled_pair
    ctl_p = RateController(types.SimpleNamespace(agg=port), budget_spans_per_sec=40.0)
    ctl_r = JRateController(types.SimpleNamespace(agg=ref), budget_spans_per_sec=40.0)
    assert ctl_p.tick(2.0) and ctl_r.tick(2.0)
    for name in ("rate", "tail", "link"):
        np.testing.assert_array_equal(getattr(port.sampler, name), getattr(ref.sampler, name), err_msg=name)
    assert (port.sampler.rate < RATE_ONE).any()
    leaves = dict(zip(AggState._fields, port.state_arrays()))
    np.testing.assert_array_equal(leaves["s_rate"][0], port.sampler.rate)
    np.testing.assert_array_equal(leaves["s_tail"][0], port.sampler.tail)
    np.testing.assert_array_equal(leaves["s_link"][0], port.sampler.link)
    assert ctl_p.publishes == ctl_r.publishes == 1
    assert ctl_p.counters() == {k: v for k, v in ctl_r.counters().items()}
    assert_states_match(port, ref, "after one controller tick")
    assert port.wal_hook.records == ref.wal_hook.records  # the sctl record too


def test_sampled_sketches_equal_unsampled_on_port():
    """Sampling gates retention, never the sketches: a sampled and an
    unsampled port run of one stream differ only in r_keep, the counters
    and the table leaves."""
    cols = _traffic().cols
    off = TorchAggregator(dataclasses.replace(CFG, sampling=False), device="cpu")
    on = TorchAggregator(CFG, device="cpu")
    rate = np.full(CFG.max_services, RATE_ONE // 4, np.uint32)
    on.set_sampler_tables(rate, np.full(CFG.max_keys, 0xFFFFFFFF, np.uint32),
                          np.full((CFG.max_services,) * 2, 100, np.uint32))
    for lo, hi, co in _batches(cols):
        _feed(off, cols, lo, hi, co)
        _feed(on, cols, lo, hi, co)
    skip = {"r_keep", "counters", "s_rate", "s_tail", "s_link"}
    for name, a, b in zip(AggState._fields, off.state_arrays(), on.state_arrays()):
        if name not in skip:
            np.testing.assert_array_equal(a, b, err_msg=name)
    leaves_on = {k: v[0] for k, v in zip(AggState._fields, on.state_arrays())}
    leaves_off = {k: v[0] for k, v in zip(AggState._fields, off.state_arrays())}
    assert not leaves_off["r_keep"].any() and leaves_on["r_keep"].any()
    np.testing.assert_array_equal(leaves_off["counters"][:5], leaves_on["counters"][:5])
    assert leaves_off["counters"][CTR_SAMPLED_KEPT] == leaves_off["counters"][CTR_SAMPLED_DROPPED] == 0
    live = int(cols.valid.sum())
    assert leaves_on["counters"][CTR_SAMPLED_KEPT] + leaves_on["counters"][CTR_SAMPLED_DROPPED] == live


def test_set_sampler_tables_swaps_leaves_and_keeps_write_version():
    agg = TorchAggregator(CFG, device="cpu")
    v = agg.write_version
    rate = np.arange(CFG.max_services, dtype=np.uint32)
    tail = np.full(CFG.max_keys, 0xFFFFFFFE, np.uint32)
    link = np.eye(CFG.max_services, dtype=np.uint32)
    agg.set_sampler_tables(rate, tail, link)
    assert agg.write_version == v
    st = convert.state_to_numpy(agg.states)
    got = {k: v[0] for k, v in zip(AggState._fields, st)}
    np.testing.assert_array_equal(got["s_rate"], rate)
    np.testing.assert_array_equal(got["s_tail"], tail)
    np.testing.assert_array_equal(got["s_link"], link)

"""The port's store at S shards against the reference's ``TpuStorage`` on
``make_mesh(S)`` (the conftest's 8 virtual CPU devices), on the CPU.

The port's shards repeat the CPU: the core store takes
``mesh=make_mesh(2, devices=["cpu"] * 2)``, and so does the resume
adapter. The stores are the small ones of
``tests/test_torch_store.py`` and ``tests/test_torch_mp_ingest.py``, fed the
same spans:

- the object path (``accept``), the line-rate path (``ingest_json_fast``)
  and the fan-out tier (``MultiProcessIngester``, one worker) at S = 2:
  every leaf with its leading shard axis (integer leaves bit for bit,
  digest weights exact and means rtol 1e-5), the host counters, the vocab
  and the reads, as ``tests/test_mp_ingest.py`` runs the reference at two
  shards;
- snapshots: the reference's 2-shard file restores into a 2-shard port
  store, the port's into the reference's, and a store of another shard
  count refuses either, naming the shards;
- WAL at S = 2: both adapters log the same records, and a crashed port
  adapter's log replays into a reborn one to the victim's leaves;
- ``TPU_DEVICES``: parsed as the reference parses it, carried to the
  store's mesh, and refused past the visible cards.
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np
import pytest
import torch

import tests.torch_cpu  # noqa: F401  (one intra-op thread a test process)
from tests.fixtures import lots_of_spans
from tests.test_torch_store import JSMALL, QS, SMALL, assert_cards_match, assert_rows_match, links, to_port
from tests.test_torch_wal import batches, crash, end_of, feed, log_records
from zipkin_tpu import native as ref_native
from zipkin_tpu.model import json_v2 as ref_json
from zipkin_tpu.parallel.mesh import make_mesh as jax_mesh
from zipkin_tpu.storage.tpu import TpuStorage as RefAdapter
from zipkin_tpu.tpu import snapshot as ref_snap
from zipkin_tpu.tpu.state import AggConfig as JConfig
from zipkin_tpu.tpu.store import TpuStorage
from zipkin_tpu_torch import native
from zipkin_tpu_torch.parallel.mesh import make_mesh
from zipkin_tpu_torch.server.app import build_storage
from zipkin_tpu_torch.server.config import ServerConfig
from zipkin_tpu_torch.storage.tpu import TorchStorage as PortAdapter
from zipkin_tpu_torch.storage.tpu import build_mesh
from zipkin_tpu_torch.tpu import snapshot as snap
from zipkin_tpu_torch.tpu.columnar import WIRE_ROWS
from zipkin_tpu_torch.tpu.mp_ingest import MultiProcessIngester
from zipkin_tpu_torch.tpu.state import AggConfig, AggState
from zipkin_tpu_torch.tpu.store import TorchStorage

WEEK_MS = 7 * 86_400_000
FLOAT_LEAVES = {"digest", "tb_digest"}
needs_native = pytest.mark.skipif(not native.available() or not ref_native.available(),
                                  reason="no C compiler for the native parser")
# tests/test_mp_ingest.py's config for the line-rate path and the tier
JFAST = JConfig(max_services=64, max_keys=1024, hll_precision=8, digest_centroids=16,
                digest_buffer=4096, ring_capacity=8192, link_buckets=4, bucket_minutes=60,
                hist_slices=2)
FAST = AggConfig(**dataclasses.asdict(JFAST))


def cpu_mesh(n):
    return make_mesh(n, devices=["cpu"] * n)


def port_store(n_shards=2, config=SMALL, **kw):
    kw.setdefault("archive_max_span_count", 100_000)
    return TorchStorage(config=config, mesh=cpu_mesh(n_shards), pad_to_multiple=256, **kw)


def ref_store(n_shards=2, config=JSMALL, **kw):
    kw.setdefault("archive_max_span_count", 100_000)
    return TpuStorage(config=config, mesh=jax_mesh(n_shards), pad_to_multiple=256, **kw)


def assert_sharded_parity(port, ref, end_ts=None) -> None:
    """Every leaf with its shard axis, the host counters, vocab ids,
    wal_seq and (with ``end_ts``) the aggregate reads."""
    got, want = port.agg.state_arrays(), ref.agg.state_arrays()
    for name, g, w in zip(AggState._fields, got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, (name, g.shape, w.shape)
        if name in FLOAT_LEAVES:
            np.testing.assert_array_equal(g[..., 1], w[..., 1], err_msg=name)
            np.testing.assert_allclose(g[..., 0], w[..., 0], rtol=1e-5, err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
    assert port.agg.host_counters == ref.agg.host_counters
    assert port.agg.wal_seq == ref.agg.wal_seq
    assert port.vocab.services._names == ref.vocab.services._names
    assert port.vocab._key_list == ref.vocab._key_list
    if end_ts is not None:
        port._deps_max_stale_ms = ref._deps_max_stale_ms = 0.0
        assert links(port.get_dependencies(end_ts, WEEK_MS).execute()) == \
            links(ref.get_dependencies(end_ts, WEEK_MS).execute())
        assert_rows_match(port.latency_quantiles(QS, use_digest=False),
                          ref.latency_quantiles(QS, use_digest=False), rtol=1e-6)
        assert_rows_match(port.latency_quantiles(QS), ref.latency_quantiles(QS), rtol=1e-5)
        assert_cards_match(port.trace_cardinalities(), ref.trace_cardinalities())


def _spans(n=3000, seed=42):
    return lots_of_spans(n, seed=seed, services=6, span_names=8)


def _end(spans):
    return max(s.timestamp for s in spans) // 1000 + 60_000


def test_object_path_matches_reference_at_two_shards():
    spans = _spans()
    port, ref = port_store(), ref_store()
    assert port.agg.n_shards == ref.agg.n_shards == 2
    for i in range(0, len(spans), 1000):
        ref.accept(spans[i:i + 1000]).execute()
        port.accept(to_port(spans[i:i + 1000])).execute()
    assert_sharded_parity(port, ref, _end(spans))
    tid = spans[0].trace_id
    assert [s.id for s in port.get_trace(tid).execute()] == [s.id for s in ref.get_trace(tid).execute()]


def _payloads(n_payloads=3, spans_each=2048):
    return [ref_json.encode_span_list(lots_of_spans(spans_each, seed=100 + i, services=10 + 3 * i,
                                                    span_names=20 + 5 * i))
            for i in range(n_payloads)]


@needs_native
def test_line_rate_path_matches_reference_at_two_shards():
    ps = _payloads()
    port, ref = port_store(config=FAST), ref_store(config=JFAST)
    for p in ps:
        assert ref.ingest_json_fast(p) is not None
        assert port.ingest_json_fast(p) is not None
    assert_sharded_parity(port, ref)


@needs_native
def test_fanout_tier_matches_reference_at_two_shards():
    """The tier at S = 2 (one worker, no coalescing) against the
    reference's synchronous line-rate path on a 2-device mesh, bit for bit;
    its ring slots hold a routed image of S x 11 rows."""
    ps = _payloads()
    ref = ref_store(config=JFAST)
    for p in ps:
        assert ref.ingest_json_fast(p) is not None
    port = port_store(config=FAST)
    ing = MultiProcessIngester(port, workers=1, coalesce_max=1)
    try:
        per_cap = ((port.max_batch + 255) // 256) * 256
        assert ing._ring.img_cap_u32 == 2 * WIRE_ROWS * per_cap
        for p in ps:
            ing.submit(p)
        ing.drain()
    finally:
        ing.close()
    assert_sharded_parity(port, ref)


def _two_shard_ref_snapshot(d):
    ref = ref_store()
    spans = _spans(1500, seed=7)
    ref.accept(spans).execute()
    ref_snap.save(ref, d)
    return ref, spans


def test_reference_two_shard_snapshot_restores_into_the_port(tmp_path):
    d = str(tmp_path / "snap")
    ref, spans = _two_shard_ref_snapshot(d)
    port = port_store()
    assert snap.maybe_restore(port, d)
    assert_sharded_parity(port, ref, _end(spans))
    # and back: the port's 2-shard file restores into the reference
    d2 = str(tmp_path / "back")
    snap.save(port, d2)
    again = ref_store()
    assert ref_snap.maybe_restore(again, d2)
    assert_sharded_parity(port, again, _end(spans))


@pytest.mark.parametrize("n_shards", [1, 8])
def test_another_shard_count_refuses_a_two_shard_snapshot(tmp_path, caplog, n_shards):
    d = str(tmp_path / "snap")
    _two_shard_ref_snapshot(d)
    store = port_store(n_shards)
    with caplog.at_level(logging.WARNING):
        assert not snap.maybe_restore(store, d)
    assert f"has 2 shards but this store has {n_shards}" in caplog.text
    assert store.agg.host_counters["spans"] == 0


def _adapters(root, n_shards=2):
    port = PortAdapter(config=SMALL, mesh=cpu_mesh(n_shards), batch_size=256,
                       checkpoint_dir=str(root / "p" / "ckpt"), wal_dir=str(root / "p" / "wal"))
    ref = RefAdapter(config=JSMALL, num_devices=n_shards, batch_size=256,
                     checkpoint_dir=str(root / "r" / "ckpt"), wal_dir=str(root / "r" / "wal"),
                     scrub_interval_s=0.0)
    return port, ref


def test_wal_at_two_shards_logs_as_the_reference_and_replays_exactly(tmp_path):
    port, ref = _adapters(tmp_path)
    assert port.agg.mesh == cpu_mesh(2) and port.agg.n_shards == ref.agg.n_shards == 2
    bs = batches(3)
    for i, b in enumerate(bs):
        feed((port, ref), b)
        if i == 1:
            port.latency_quantiles(QS)  # flush-then-read logs a ttflush marker
            ref.latency_quantiles(QS)
    port.latency_quantiles(QS)
    ref.latency_quantiles(QS)
    got, want = log_records(tmp_path / "p" / "wal"), log_records(tmp_path / "r" / "wal")
    assert got == want and len(got) >= 4
    assert all(m["shape"][0] == 2 for _, m, _ in got)
    assert_sharded_parity(port, ref, end_of(bs))
    crash(port)
    reborn = PortAdapter(config=SMALL, mesh=cpu_mesh(2), batch_size=256,
                         checkpoint_dir=str(tmp_path / "p" / "ckpt"),
                         wal_dir=str(tmp_path / "p" / "wal"))
    assert reborn.restore_stats["walReplayBatches"] == len(got)
    assert_sharded_parity(reborn, ref, end_of(bs))
    # a snapshot at 2 shards, then a boot from it and the log's suffix
    assert reborn.snapshot()
    crash(reborn)
    third = PortAdapter(config=SMALL, mesh=cpu_mesh(2), batch_size=256,
                        checkpoint_dir=str(tmp_path / "p" / "ckpt"),
                        wal_dir=str(tmp_path / "p" / "wal"))
    assert third.restore_stats["walReplayBatches"] == 0
    assert_sharded_parity(third, ref, end_of(bs))


def test_tpu_devices_parses_as_the_reference(monkeypatch):
    from zipkin_tpu.server.config import ServerConfig as RefConfig

    for raw, want in ((None, None), ("0", None), ("2", 2), ("8", 8)):
        if raw is None:
            monkeypatch.delenv("TPU_DEVICES", raising=False)
        else:
            monkeypatch.setenv("TPU_DEVICES", raw)
        assert ServerConfig.from_env().tpu_devices == RefConfig.from_env().tpu_devices == want
    assert ServerConfig().tpu_devices is None


def test_tpu_devices_reaches_the_store_mesh(tmp_path, monkeypatch):
    """TPU_DEVICES=2 asks make_mesh for the first two cards; here two CPU
    entries stand for them."""
    asked = []

    def two_cards(n_devices=None, devices=None):
        asked.append((n_devices, devices))
        return make_mesh(n_devices, devices=devices or ["cpu"] * 2)

    monkeypatch.setattr("zipkin_tpu_torch.storage.tpu.make_mesh", two_cards)
    small = {f.name: getattr(SMALL, f.name) for f in dataclasses.fields(SMALL)}
    config = ServerConfig(storage_type="tpu", tpu_devices=2, tpu_agg=small)
    store = build_storage(config)
    try:
        assert asked == [(2, None)]
        assert store.agg.n_shards == 2 and store.agg.mesh == cpu_mesh(2)
        store.accept(to_port(_spans(600, seed=3))).execute()
        assert store.agg.host_counters["spans"] == 600
    finally:
        store.close()


def test_more_devices_than_the_machine_has_is_refused(monkeypatch):
    """With one visible card, TPU_DEVICES=2 fails as the reference does,
    before any state is built; a shard count is never put on a device the
    caller named: several shards on one device come only through ``mesh``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert make_mesh() == [torch.device("cuda", 0)]
    with pytest.raises(ValueError, match="requested 2 devices, have 1"):
        make_mesh(2)
    with pytest.raises(ValueError, match="requested 2 devices, have 1"):
        PortAdapter(config=SMALL, num_devices=2, batch_size=256)
    config = ServerConfig(storage_type="tpu", tpu_devices=2)
    with pytest.raises(ValueError, match="requested 2 devices, have 1"):
        build_storage(config)
    with pytest.raises(ValueError, match="num_devices and device"):
        build_storage(config, device="cpu")
    assert build_mesh() == build_mesh(1) == [torch.device("cuda", 0)]
    assert build_mesh(None, device="cpu") == cpu_mesh(1)
    assert build_mesh(mesh=cpu_mesh(2)) == cpu_mesh(2)
    with pytest.raises(ValueError, match="num_devices and mesh"):
        build_mesh(2, mesh=cpu_mesh(2))
    with pytest.raises(ValueError, match="num_devices and device"):
        PortAdapter(config=SMALL, num_devices=2, device="cpu", batch_size=256)


# -- the modules that read through the aggregator, at S = 2 ------------------


def _timed_spans():
    """Three 5-minute buckets of spans (tests/test_torch_store.py's)."""
    base = lots_of_spans(3000, seed=8, services=5, span_names=4)
    out = []
    for i in range(3):
        for s in base[i * 1000:(i + 1) * 1000]:
            out.append(dataclasses.replace(s, timestamp=s.timestamp + i * 5 * 60_000_000))
    return out


def test_time_tier_seals_and_windows_match_reference_at_two_shards():
    spans = _timed_spans()
    port, ref = port_store(), ref_store()
    for i in range(0, len(spans), 1000):
        ref.accept(spans[i:i + 1000]).execute()
        port.accept(to_port(spans[i:i + 1000])).execute()
    port._deps_max_stale_ms = ref._deps_max_stale_ms = 0.0
    assert port.tt_seal() == ref.tt_seal() == 3
    first_ms = min(s.timestamp for s in spans) // 1000
    for end_ts, lookback in ((first_ms + 9 * 60_000, 9 * 60_000),
                             (first_ms + 14 * 60_000, 14 * 60_000)):
        kw = dict(end_ts=end_ts, lookback=lookback)
        assert_rows_match(port.latency_quantiles(QS, **kw), ref.latency_quantiles(QS, **kw),
                          rtol=1e-5)
        assert links(port.get_dependencies(end_ts, lookback).execute()) == \
            links(ref.get_dependencies(end_ts, lookback).execute())
        assert_cards_match(port.trace_cardinalities(**kw), ref.trace_cardinalities(**kw))
    assert port.timetier.counters["ttWindowReads"] == ref.timetier.counters["ttWindowReads"] > 0


def test_mirror_and_segment_serve_the_merged_reads_at_two_shards():
    import json

    from zipkin_tpu_torch.serving.segment import MirrorSegment
    from zipkin_tpu_torch.serving.shape import SegmentMiss, SegmentView

    spans = _spans(1200, seed=5)
    store = port_store()
    seg = MirrorSegment(readers=1, capacity=4 << 20)
    try:
        store.accept(to_port(spans)).execute()
        end_ts = _end(spans)
        store.attach_mirror_segment(seg)
        assert store.publish_mirror(force=True)
        serves = store.mirror.serves
        got = store.latency_quantiles(QS)
        assert store.mirror.serves == serves + 1
        J = lambda x: json.dumps(x, sort_keys=True)  # noqa: E731
        assert J(got) == J(store.latency_quantiles(QS, staleness_ms=0))
        assert J(store.trace_cardinalities()) == J(store.trace_cardinalities(staleness_ms=0))
        view = SegmentView(seg, 0)
        for fn, args, fresh in (
            (view.serve_quantiles, (QS,), lambda: store.latency_quantiles(list(QS), staleness_ms=0)),
            (view.serve_cardinalities, (), lambda: store.trace_cardinalities(staleness_ms=0)),
        ):
            try:
                out = fn(*args)[0]
            except SegmentMiss:
                assert store.publish_mirror(force=True)
                out = fn(*args)[0]
            assert J(out) == J(fresh())
        fresh_links = store.get_dependencies(end_ts, WEEK_MS, staleness_ms=0).execute()
        ref = ref_store()
        ref.accept(spans).execute()
        ref._deps_max_stale_ms = 0.0
        assert links(fresh_links) == links(ref.get_dependencies(end_ts, WEEK_MS).execute())
    finally:
        store.mirror.segment_sink = None
        seg.close()
        store.close()


def test_disk_archive_reads_back_every_trace_at_two_shards(tmp_path):
    spans = _spans(1200, seed=6)
    port = port_store(archive_dir=str(tmp_path / "p"), archive_segment_bytes=1 << 16)
    ref = ref_store(archive_dir=str(tmp_path / "r"), archive_segment_bytes=1 << 16)
    port.accept(to_port(spans)).execute()
    ref.accept(spans).execute()
    ids = sorted({s.trace_id for s in spans})
    for tid in ids[:40]:
        got = sorted(s.id for s in port.get_trace(tid).execute())
        assert got == sorted(s.id for s in ref.get_trace(tid).execute()) and got
    assert_sharded_parity(port, ref)
    port.close()
    ref.close()

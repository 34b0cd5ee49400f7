"""The port's multi-process tier through the durability plane, on the CPU
(the reference's ``tests/test_fanout_parity.py`` against the port's resume
adapter, ``zipkin_tpu_torch.storage.tpu.TorchStorage``).

With the WAL attached and boundary sampling armed, the tier makes the
synchronous path's verdicts and a WAL whose replay rebuilds the same state;
a crash at ``wal.append.mid`` with workers live recovers like the
synchronous path; coalesced groups (``coalesce_max=8``) change the batch
count and nothing else: integer planes equal, digests inside their rank
band, and a replay of the coalesced records rebuilds the live store leaf
for leaf.

Tolerances: with one worker every leaf exact; under coalescing or two
workers, counters (but ``batches``), histograms, cardinalities and links
exact, by name; digest quantiles of keys with at least 100 points inside
``[quantile(q - w), quantile(q + w)]`` of the true durations, with
``w = tdigest.cluster_q_width(C, q)``; a replay exact, leaf for leaf.
"""

from __future__ import annotations

import numpy as np
import pytest

from tests.fixtures import lots_of_spans
from tests.test_torch_mp_ingest import CFG, assert_state_parity, payloads
from tests.test_torch_mp_ingest import pytestmark  # noqa: F401  (the native-parser gate)
import tests.torch_cpu  # noqa: F401  (one intra-op thread a test process)
from zipkin_tpu.model import json_v2 as ref_json
from zipkin_tpu_torch import faults
from zipkin_tpu_torch.collector import CollectorSampler
from zipkin_tpu_torch.ops import tdigest
from zipkin_tpu_torch.storage.tpu import TorchStorage
from zipkin_tpu_torch.tpu.mp_ingest import MultiProcessIngester

QS = [0.5, 0.9, 0.99]


@pytest.fixture(autouse=True)
def _always_disarm():
    yield
    faults.disarm()


def make_wal(root, **kw):
    return TorchStorage(config=CFG, device="cpu", batch_size=512,
                        checkpoint_dir=str(root / "ckpt"), wal_dir=str(root / "wal"), **kw)


def oracle(**kw):
    return TorchStorage(config=CFG, device="cpu", batch_size=512, **kw)


def run(store, ps, **kw):
    ing = MultiProcessIngester(store, **kw)
    try:
        for p in ps:
            ing.submit(p)
        ing.drain()
    finally:
        ing.close()
    return ing


def assert_vocab_equal(a, b) -> None:
    assert a.vocab.services._names == b.vocab.services._names
    assert a.vocab.span_names._names == b.vocab.span_names._names
    assert a.vocab._key_list == b.vocab._key_list


def assert_replay_rebuilds(live, make_again) -> None:
    """Flush the live store's pending digest points (a logged marker), close
    it, and boot a new adapter on its dirs: every leaf, counter and vocab id
    equal."""
    live.agg.flush_now()
    leaves = live.agg.state_arrays()
    counters = dict(live.agg.host_counters)
    live.close()
    revived = make_again()
    try:
        assert revived.agg.host_counters == counters
        for x, y in zip(revived.agg.state_arrays(), leaves):
            np.testing.assert_array_equal(x, y)
        assert revived.restore_stats["walReplayBatches"] > 0
    finally:
        revived.close()


def assert_digests_in_band(store, spans) -> int:
    """Each digest quantile of a key with >= 100 points lies inside the rank
    band of the key's true durations; returns how many were checked."""
    durs = {}
    for s in spans:
        if s.duration:
            durs.setdefault((s.local_service_name, s.name), []).append(s.duration)
    checked = 0
    for row in store.latency_quantiles(QS):
        v = np.sort(np.asarray(durs[(row["serviceName"], row["spanName"])], np.float64))
        assert row["count"] == len(v)
        if len(v) < 100:
            continue
        for q, got in row["quantiles"].items():
            w = tdigest.cluster_q_width(CFG.digest_centroids, q)
            lo, hi = np.quantile(v, [max(q - w, 0.0), min(q + w, 1.0)])
            assert lo <= got <= hi, (row["serviceName"], row["spanName"], q, got, lo, hi)
            checked += 1
    return checked


def test_workers1_wal_and_sampling_bit_parity(tmp_path):
    """One worker, boundary sampling at 0.5: the same verdicts, the same
    leaves and logs whose replays match each other, ids included."""
    ps = payloads(n_payloads=3)
    sync = make_wal(tmp_path / "sync")
    for p in ps:
        assert sync.ingest_json_fast(p, CollectorSampler(0.5)) is not None
    mp_store = make_wal(tmp_path / "mp")
    ing = run(mp_store, ps, workers=1, sampler=CollectorSampler(0.5))
    assert ing.counters["fallbacks"] == 0
    assert ing.counters["sampleDropped"] > 0
    assert_state_parity(sync, mp_store, exact=True)
    assert mp_store.agg.wal_seq == sync.agg.wal_seq
    sync.close()
    mp_store.close()
    r_sync, r_mp = make_wal(tmp_path / "sync"), make_wal(tmp_path / "mp")
    try:
        assert_state_parity(r_sync, r_mp, exact=True)
        assert_vocab_equal(r_sync, r_mp)
    finally:
        r_sync.close()
        r_mp.close()


def test_workers2_interleaved_wal_replay_parity(tmp_path):
    """Two workers interleave; the WAL holds every acked batch, so a replay
    rebuilds the live store, and both match the synchronous path by name."""
    ps = payloads(n_payloads=4)
    mp_store = make_wal(tmp_path / "mp")
    run(mp_store, ps, workers=2, queue_depth=8)
    sync = oracle()
    for p in ps:
        assert sync.ingest_json_fast(p) is not None
    assert_state_parity(sync, mp_store, exact=False)
    assert_replay_rebuilds(mp_store, lambda: make_wal(tmp_path / "mp"))
    sync.close()


def test_wal_append_crash_resume_with_workers_live(tmp_path):
    """A crash at ``wal.append.mid`` (a torn record) while the pool is live:
    the revived store equals an oracle fed the durable prefix, and a new
    pool on it takes the retry and new traffic to full parity."""
    ps = payloads(n_payloads=5, spans_each=1024)
    victim = make_wal(tmp_path / "mp")
    ing = MultiProcessIngester(victim, workers=2, queue_depth=8)
    for p in ps[:3]:
        ing.submit(p)
    ing.drain()
    faults.arm("wal.append.mid", action="raise")
    ing.submit(ps[3])
    with pytest.raises(RuntimeError):
        ing.drain()
    assert isinstance(ing._dispatch_error, faults.CrashpointTriggered)
    ing.close()  # a dead dispatcher does not wedge teardown
    del victim  # the crash: nothing flushed, closed or snapshotted

    revived = make_wal(tmp_path / "mp")
    want = oracle()
    for p in ps[:3]:
        assert want.ingest_json_fast(p) is not None
    assert_state_parity(want, revived, exact=False)
    run(revived, ps[3:], workers=2, queue_depth=8)
    for p in ps[3:]:
        assert want.ingest_json_fast(p) is not None
    assert_state_parity(want, revived, exact=False)
    counters = dict(revived.agg.host_counters)
    revived.close()
    again = make_wal(tmp_path / "mp")
    assert again.agg.host_counters == counters
    again.close()
    want.close()


def test_workers1_coalesce1_matches_the_synchronous_path(tmp_path):
    """coalesce_max=1: one step and one WAL record a chunk, no coalesced
    group, and the synchronous path's log: the same images in the same
    records, and the same vocab journal. Where the journal splits between
    records may differ: the dispatcher replays a chunk's vocab delta when it
    consumes the chunk, which can be a pass before the group that logs it."""
    from tests.test_torch_wal import log_records

    ps = payloads(n_payloads=3)
    sync = make_wal(tmp_path / "sync")
    for p in ps:
        assert sync.ingest_json_fast(p) is not None
    mp_store = make_wal(tmp_path / "mp")
    ing = run(mp_store, ps, workers=1, coalesce_max=1)
    assert ing.counters["coalescedBatches"] == ing.counters["coalescedChunks"] == 0
    assert_state_parity(sync, mp_store, exact=True)
    sync.close()
    mp_store.close()
    a, b = log_records(tmp_path / "sync" / "wal"), log_records(tmp_path / "mp" / "wal")
    assert [(s, p) for s, _, p in a] == [(s, p) for s, _, p in b] and len(a) == 3
    journal = ("svc", "names", "pairs")
    for (_, ma, _), (_, mb, _) in zip(a, b):
        assert {k: v for k, v in ma.items() if k not in journal} == \
            {k: v for k, v in mb.items() if k not in journal}
    for key in journal:
        assert [x for _, m, _ in a for x in m.get(key, [])] == \
            [x for _, m, _ in b for x in m.get(key, [])]


def _coalescing_payloads(n):
    """2,560-span payloads: three chunks each at max_device_batch=1024,
    which a coalesce_max=8 flush merges into one group (2,560 lanes under
    the 4,096-lane cap)."""
    spans = [lots_of_spans(2560, seed=300 + i, services=6 + i, span_names=12) for i in range(n)]
    return spans, [ref_json.encode_span_list(s) for s in spans]


def make_coalescing(root=None):
    dirs = {} if root is None else dict(checkpoint_dir=str(root / "ckpt"), wal_dir=str(root / "wal"))
    return TorchStorage(config=CFG, device="cpu", batch_size=512, max_device_batch=1024, **dirs)


def test_coalesced_semantic_parity_and_replay_identity(tmp_path):
    """coalesce_max=8 merges a payload's chunks into one device step and
    one WAL record: fewer steps, every integer plane and counter but
    ``batches`` equal to the synchronous path, digests inside their rank
    band, and the replay of the coalesced records equal to the live store."""
    spans, ps = _coalescing_payloads(3)
    sync = make_coalescing(tmp_path / "sync")
    for p in ps:
        assert sync.ingest_json_fast(p) is not None
    mp_store = make_coalescing(tmp_path / "mp")
    assert mp_store.max_batch == 1024 and mp_store.agg.lane_cap == 4096
    ing = run(mp_store, ps, workers=2, queue_depth=8, coalesce_max=8)
    assert ing.counters["fallbacks"] == 0
    assert ing.counters["coalescedBatches"] >= 3 and ing.counters["coalescedChunks"] >= 9
    assert mp_store.agg.host_counters["batches"] < sync.agg.host_counters["batches"] == 9
    assert ing.counters["groups"] == mp_store.agg.host_counters["batches"]
    assert_state_parity(sync, mp_store, exact=False, exact_batches=False)
    all_spans = [s for b in spans for s in b]
    assert assert_digests_in_band(mp_store, all_spans) > 0
    assert assert_digests_in_band(sync, all_spans) > 0
    sync.close()
    assert_replay_rebuilds(mp_store, lambda: make_coalescing(tmp_path / "mp"))


def test_coalesced_crash_resume_oracle_parity(tmp_path):
    """A crash at ``wal.append.mid`` while a coalesced group appends tears
    that one record: the whole group is lost together, the revived store
    equals an oracle fed the acked prefix, and a new coalescing pool takes
    the retry to parity."""
    _, ps = _coalescing_payloads(4)
    make = make_coalescing
    victim = make(tmp_path / "mp")
    ing = MultiProcessIngester(victim, workers=2, queue_depth=8, coalesce_max=8)
    for p in ps[:2]:
        ing.submit(p)
    ing.drain()
    assert ing.counters["coalescedChunks"] >= 2
    faults.arm("wal.append.mid", action="raise")
    ing.submit(ps[2])
    with pytest.raises(RuntimeError):
        ing.drain()
    assert isinstance(ing._dispatch_error, faults.CrashpointTriggered)
    ing.close()
    del victim

    revived = make(tmp_path / "mp")
    want = make()
    for p in ps[:2]:
        assert want.ingest_json_fast(p) is not None
    assert_state_parity(want, revived, exact=False, exact_batches=False)
    run(revived, ps[2:], workers=2, queue_depth=8, coalesce_max=8)
    for p in ps[2:]:
        assert want.ingest_json_fast(p) is not None
    assert_state_parity(want, revived, exact=False, exact_batches=False)
    counters = dict(revived.agg.host_counters)
    revived.close()
    again = make(tmp_path / "mp")
    assert again.agg.host_counters == counters
    again.close()
    want.close()

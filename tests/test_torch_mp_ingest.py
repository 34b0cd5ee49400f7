"""The port's multi-process ingest tier (``zipkin_tpu_torch.tpu.mp_ingest``)
on the CPU, against the port's own synchronous line-rate path and against
the JAX package.

The reference's own cases (``tests/test_mp_ingest.py``) run against the
port: one worker is bit-identical to ``ingest_json_fast``; two workers
interleave and every order-free plane still matches after the id remap;
the parser's punts take the object path; a payload of several chunks
drains whole; a SIGKILLed worker loses nothing, whether it was the last
one or the pool keeps a survivor; full queues push back with
``IngestBackpressure`` and recover; boundary sampling drops what the
synchronous path drops; worker-built records fill the disk archive.

Across packages: ``route_fused`` equals the reference's at 1, 2 and 4
shards, and the port's tier (one worker, ``coalesce_max=1``) is bit-equal
to the JAX package's synchronous ``ingest_json_fast`` through the one-shard
mesh. A spawned worker never loads torch.

Tolerances: integer leaves, counters, names and links exact; with one
worker every leaf exact (the same batches in the same order on the CPU);
against the JAX package digest means rtol 1e-5 (``assert_leaves_equal``).
"""

from __future__ import annotations

import dataclasses
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from tests.fixtures import lots_of_spans
from tests.test_torch_fastpath import assert_leaves_equal
import tests.torch_cpu  # noqa: F401  (one intra-op thread a test process)
from zipkin_tpu import native as ref_native
from zipkin_tpu.model import json_v2 as ref_json
from zipkin_tpu.parallel.mesh import make_mesh
from zipkin_tpu.tpu import columnar as ref_columnar
from zipkin_tpu.tpu.state import AggConfig as JConfig
from zipkin_tpu.tpu.store import TpuStorage
from zipkin_tpu_torch import native
from zipkin_tpu_torch.collector import CollectorSampler
from zipkin_tpu_torch.model import codec
from zipkin_tpu_torch.model import json_v2 as port_json
from zipkin_tpu_torch.storage.spi import QueryRequest
from zipkin_tpu_torch.tpu import columnar
from zipkin_tpu_torch.tpu.mp_ingest import IngestBackpressure, MultiProcessIngester
from zipkin_tpu_torch.tpu.state import AggConfig
from zipkin_tpu_torch.tpu.store import TorchStorage

pytestmark = pytest.mark.skipif(not native.available() or not ref_native.available(),
                                reason="no C compiler for the native parser")

# tests/test_mp_ingest.py's config: max_keys above the corpus' distinct
# (service, spanName) count, since at capacity which pairs overflow depends
# on arrival order
JCFG = JConfig(max_services=64, max_keys=1024, hll_precision=8, digest_centroids=16,
               digest_buffer=4096, ring_capacity=8192, link_buckets=4, bucket_minutes=60,
               hist_slices=2)
CFG = AggConfig(**dataclasses.asdict(JCFG))


def payloads(n_payloads=3, spans_each=2048):
    """Distinct service and name mixes per payload, so worker-local ids
    diverge from the global order under more than one worker."""
    return [ref_json.encode_span_list(lots_of_spans(spans_each, seed=100 + i, services=10 + 3 * i,
                                                    span_names=20 + 5 * i))
            for i in range(n_payloads)]


def make_store(**kw):
    kw.setdefault("archive_max_span_count", 100_000)
    return TorchStorage(config=CFG, device="cpu", pad_to_multiple=256, **kw)


def ingest_sync(store, ps, sampler=None):
    for p in ps:
        assert store.ingest_json_fast(p, sampler) is not None


def ingest_mp(store, ps, **kw):
    ing = MultiProcessIngester(store, **kw)
    try:
        for p in ps:
            ing.submit(p)
        ing.drain()
    finally:
        ing.close()
    return ing


def hist_by_name(store, hist):
    pairs = list(store.vocab._key_list)
    return {(store.vocab.services.lookup(s), store.vocab.span_names.lookup(n)): hist[kid]
            for kid, (s, n) in enumerate(pairs) if kid and hist[kid].any()}


def links_by_name(store):
    calls, errs = store.agg.dependency_matrices(0, 1 << 31)
    lookup = store.vocab.services.lookup
    return {(lookup(int(p)), lookup(int(c))): (int(calls[p, c]), int(errs[p, c]))
            for p, c in zip(*np.nonzero(calls))}


def assert_state_parity(a, b, exact: bool, exact_batches: bool = True) -> None:
    """Counters exact (``batches`` too unless coalesced); with ``exact``
    every leaf bit for bit, else histograms, cardinalities and dependency
    links compared by name (more than one worker assigns global ids in
    arrival order)."""
    ca, cb = dict(a.agg.host_counters), dict(b.agg.host_counters)
    if not exact_batches:
        ca.pop("batches")
        cb.pop("batches")
    assert ca == cb
    if exact:
        for x, y in zip(a.agg.state_arrays(), b.agg.state_arrays()):
            np.testing.assert_array_equal(x, y)
        return
    ha, hb = a.agg.merged_sketches()[0], b.agg.merged_sketches()[0]
    da, db = hist_by_name(a, ha), hist_by_name(b, hb)
    assert da.keys() == db.keys() and da
    for k in da:
        np.testing.assert_array_equal(da[k], db[k], err_msg=str(k))
    assert a.trace_cardinalities() == b.trace_cardinalities()
    assert links_by_name(a) == links_by_name(b)


def archive_trace_ids(store):
    ids = set()
    for svc in store._archive.get_service_names().execute():
        req = QueryRequest(end_ts=1 << 62, lookback=1 << 62, limit=100_000, service_name=svc)
        for trace in store._archive.get_traces_query(req).execute():
            ids.add(trace[0].trace_id)
    return ids


# -- the reference's cases ----------------------------------------------------


def test_single_worker_bit_parity():
    """One worker takes payloads in submission order, so vocab ids, chunks
    and batch order match the synchronous path: every leaf is bit-equal,
    and the 1/64 archive sample holds the same traces."""
    ps = payloads()
    sync, mp_store = make_store(), make_store()
    ingest_sync(sync, ps)
    ing = ingest_mp(mp_store, ps, workers=1)
    assert ing.counters["fallbacks"] == 0
    assert ing.counters["accepted"] == mp_store.agg.host_counters["spans"] == 3 * 2048
    assert ing.counters["groups"] == mp_store.agg.host_counters["batches"] == 3
    assert_state_parity(sync, mp_store, exact=True)
    assert sync.vocab._key_list == mp_store.vocab._key_list
    assert archive_trace_ids(sync) == archive_trace_ids(mp_store) != set()


def test_two_workers_semantic_parity():
    ps = payloads(n_payloads=4)
    sync, mp_store = make_store(), make_store()
    ingest_sync(sync, ps)
    ingest_mp(mp_store, ps, workers=2)
    assert_state_parity(sync, mp_store, exact=False)
    assert archive_trace_ids(sync) == archive_trace_ids(mp_store)


def test_fallback_payload_takes_object_path():
    """A payload the native parser refuses (an escaped string) is ingested
    through the dispatcher's object-path fallback, not dropped."""
    good = payloads(1)[0]
    weird = (b'[{"traceId":"000000000000000a","id":"000000000000000b",'
             b'"name":"esc\\u0041ped","localEndpoint":{"serviceName":"svc"},'
             b'"timestamp":1000,"duration":10}]')
    assert native.parse_spans(weird) is None
    sync, mp_store = make_store(), make_store()
    ingest_sync(sync, [good])
    sync.accept(codec.decode_spans(weird)).execute()
    ing = ingest_mp(mp_store, [good, weird], workers=1)
    assert ing.counters["fallbacks"] == 1
    assert sync.agg.host_counters["spans"] == mp_store.agg.host_counters["spans"] == 2049


def test_multichunk_payload_drains_completely():
    """A payload past max_batch splits into chunks; drain() returns only
    after the last one is on the device."""
    payload = ref_json.encode_span_list(lots_of_spans(10_000, seed=7, services=8, span_names=16))
    sync, mp_store = make_store(), make_store()
    assert sync.max_batch == 4096  # 3 chunks
    ingest_sync(sync, [payload])
    ing = ingest_mp(mp_store, [payload], workers=1)
    assert ing.counters["fallbacks"] == 0
    assert mp_store.agg.host_counters["spans"] == 10_000
    assert mp_store.agg.host_counters["batches"] == 3
    assert_state_parity(sync, mp_store, exact=True)


def _wait_reaped(ing, w: int) -> None:
    deadline = time.monotonic() + 30
    while ing._maps[w] is not None and time.monotonic() < deadline:
        time.sleep(0.05)
    assert ing._maps[w] is None, "dead worker never reaped"


def test_dead_worker_pool_exhaustion_recovers_not_wedges():
    """The only worker SIGKILLed: its payload re-ingests on the slow path,
    drain() returns, and only then do new submissions fail."""
    mp_store = make_store()
    ps = payloads(n_payloads=2, spans_each=512)
    ing = MultiProcessIngester(mp_store, workers=1)
    try:
        ing.submit(ps[0])
        ing._procs[0].kill()
        _wait_reaped(ing, 0)
        assert ing._dead == {0}
        ing.drain()
        assert mp_store.agg.host_counters["spans"] == 512  # exactly once
        with pytest.raises(RuntimeError, match="exhausted"):
            ing.submit(ps[1])
        assert ing._dispatch_error is None
    finally:
        t0 = time.monotonic()
        ing.close()
        assert time.monotonic() - t0 < 25, "close() wedged after pool death"


def test_dead_worker_survivors_keep_accepting_zero_loss():
    mp_store = make_store()
    ps = payloads(n_payloads=6, spans_each=1024)
    ing = MultiProcessIngester(mp_store, workers=2, queue_depth=16)
    try:
        for p in ps[:3]:
            ing.submit(p)
        ing._procs[0].kill()
        _wait_reaped(ing, 0)
        assert ing._dead == {0}
        assert ing.stats()["mpWorkersAlive"] == 1
        for p in ps[3:]:
            ing.submit(p)
        ing.drain()
        assert ing._dispatch_error is None
        assert mp_store.agg.host_counters["spans"] == 6 * 1024
    finally:
        t0 = time.monotonic()
        ing.close()
        assert time.monotonic() - t0 < 25, "close() wedged on the survivor"


def test_backpressure_bounded_queues_push_back_then_recover():
    """The lone worker frozen (SIGSTOP): its bounded queue fills and a
    non-blocking submit raises IngestBackpressure without leaking the
    refused payload into the in-flight count; after SIGCONT every accepted
    payload lands once."""
    mp_store = make_store()
    ps = payloads(n_payloads=8, spans_each=256)
    ing = MultiProcessIngester(mp_store, workers=1, queue_depth=2)
    try:
        os.kill(ing._procs[0].pid, signal.SIGSTOP)
        accepted = 0
        try:
            with pytest.raises(IngestBackpressure):
                for p in ps:
                    ing.submit(p, block=False)
                    accepted += 1
        finally:
            os.kill(ing._procs[0].pid, signal.SIGCONT)
        assert ing.queue_depth <= accepted < len(ps)
        assert ing.counters["rejected"] == 1
        ing.drain()
        assert mp_store.agg.host_counters["spans"] == 256 * accepted
        ing.submit(ps[-1], block=False)
        ing.drain()
        assert mp_store.agg.host_counters["spans"] == 256 * (accepted + 1)
    finally:
        ing.close()


def test_sampler_parity():
    """Boundary sampling drops the same traces in both paths."""
    ps = payloads(2)
    sync, mp_store = make_store(), make_store()
    ingest_sync(sync, ps, CollectorSampler(0.5))
    ing = ingest_mp(mp_store, ps, workers=1, sampler=CollectorSampler(0.5))
    assert sync.agg.host_counters == mp_store.agg.host_counters
    assert ing.counters["sampleDropped"] > 0
    assert ing.counters["sampleDropped"] + ing.counters["accepted"] == 2 * 2048


def test_mp_tier_feeds_disk_archive(tmp_path):
    """With the disk archive on, traces the workers parsed read back whole
    from it (worker-built records, ids remapped by the dispatcher), equal
    to what the synchronous path stores."""
    ps = payloads(n_payloads=4, spans_each=1024)
    mp_store = make_store(archive_dir=str(tmp_path / "mp"), fast_archive_sample=0)
    ingest_mp(mp_store, ps, workers=2, queue_depth=8)
    sync = make_store(archive_dir=str(tmp_path / "sync"), fast_archive_sample=0)
    ingest_sync(sync, ps)
    checked = 0
    for p in ps[:2]:
        for s in port_json.decode_span_list(p)[:64]:
            got = sorted(port_json.encode_span(x) for x in mp_store.get_trace(s.trace_id).execute())
            want = sorted(port_json.encode_span(x) for x in sync.get_trace(s.trace_id).execute())
            assert got == want and got, s.trace_id
            checked += 1
    assert checked > 50
    svc = port_json.decode_span_list(ps[0])[0].local_service_name
    req = QueryRequest(service_name=svc, end_ts=2_000_000_000_000, lookback=2_000_000_000_000,
                       limit=10)
    assert len(mp_store.get_traces_query(req).execute()) == \
        len(sync.get_traces_query(req).execute()) > 0
    # the remote-service names ride the remapped record too
    for name in sync.get_service_names().execute():
        assert mp_store.get_remote_service_names(name).execute() == \
            sync.get_remote_service_names(name).execute()
    mp_store.close()
    sync.close()


# -- the port's own -----------------------------------------------------------


def test_oversized_sidecars_ride_the_queue_in_order(tmp_path):
    """Chunks whose sidecar (here the disk record) outgrows the ring's aux
    region go through the result queue, ordered with the ring's chunks by
    the worker's sequence: one worker fed small and large payloads by turns
    stays bit-equal to the synchronous path, disk archive included."""
    spans = lots_of_spans(6400, seed=41, services=9, span_names=11)
    cuts = [0, 100, 1600, 1700, 3200, 3300, 4800, 4900, 6400]
    ps = [ref_json.encode_span_list(spans[a:b]) for a, b in zip(cuts, cuts[1:])]
    sync = make_store(archive_dir=str(tmp_path / "sync"), fast_archive_sample=0)
    ingest_sync(sync, ps)
    mp_store = make_store(archive_dir=str(tmp_path / "mp"), fast_archive_sample=0)
    ing = MultiProcessIngester(mp_store, workers=1, ring_aux_bytes=64 << 10)
    kinds = []
    apply = ing._apply_queue_msg
    ing._apply_queue_msg = lambda msg, ready: (kinds.append(msg[0]), apply(msg, ready))
    try:
        for p in ps:
            ing.submit(p)
        ing.drain()
    finally:
        ing.close()
    assert kinds.count(0) == 4  # the four large payloads took the queue
    assert ing.counters["groups"] == len(ps)
    assert_state_parity(sync, mp_store, exact=True)
    for s in spans[::97]:
        got = sorted(port_json.encode_span(x) for x in mp_store.get_trace(s.trace_id).execute())
        want = sorted(port_json.encode_span(x) for x in sync.get_trace(s.trace_id).execute())
        assert got == want and got
    mp_store.close()
    sync.close()



def test_tier_gauges_join_the_store_counters():
    """An attached tier's gauges are in ingest_counters(), the worker stage
    seconds among them, and account for every span."""
    ps = payloads(n_payloads=2, spans_each=512)
    store = make_store()
    ing = MultiProcessIngester(store, workers=1)
    store.mp_ingester = ing
    try:
        for p in ps:
            ing.submit(p)
        ing.drain()
        c = store.ingest_counters()
        assert c["mpWorkers"] == c["mpWorkersAlive"] == 1
        assert c["mpAccepted"] == c["spans"] == 1024
        assert c["mpInflight"] == c["mpRejected"] == c["mpFallbacks"] == 0
        assert c["mpGroups"] == 2 and c["mpRingSlots"] == 4
        assert c["mpParseUs"] > 0 and c["mpPackUs"] > 0 and c["mpDeviceFeedUs"] > 0
        assert c["mpWorkerTable"][0]["payloads"] == 2
    finally:
        ing.close()
    # a closed tier still answers (its ring's depths read 0)
    c = store.ingest_counters()
    assert c["mpAccepted"] == 1024 and c["mpRingOccupancy"] == 0


def test_feed_latency_site_stalls_the_dispatcher(monkeypatch):
    """An armed ``feed.latency`` site sleeps in each group flush: the flush
    wall grows by the armed latency, and nothing is lost."""
    from zipkin_tpu_torch import faults

    ps = payloads(n_payloads=2, spans_each=256)
    store = make_store()
    faults.arm_resource("feed.latency", nth=1, count=2, latency_ms=300.0)
    try:
        ing = ingest_mp(store, ps, workers=1)
    finally:
        faults.disarm()
    assert store.agg.host_counters["spans"] == 512
    assert ing.stage_us["flush"] - ing.stage_us["deviceFeed"] >= 2 * 300_000


# -- across packages ----------------------------------------------------------


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_route_fused_equals_the_reference(shards):
    spans = lots_of_spans(1500, seed=3, services=7, span_names=9)
    pv, rv = columnar.Vocab(64, 1024), ref_columnar.Vocab(64, 1024)
    cols = columnar.pack_spans(port_json.decode_span_list(ref_json.encode_span_list(spans)), pv, 256)
    rcols = ref_columnar.pack_spans(spans, rv, 256)
    got, want = columnar.route_fused(cols, shards), ref_columnar.route_fused(rcols, shards)
    assert got.dtype == want.dtype == np.uint32
    np.testing.assert_array_equal(got, want)


def test_tier_bit_equal_to_the_reference_sync_path():
    """The port's tier (one worker, coalesce_max=1) and the JAX package's
    synchronous ingest_json_fast on a one-shard mesh, fed the same payload
    bytes: integer leaves bit for bit, digest means rtol 1e-5, counters and
    vocab ids equal."""
    ps = payloads(n_payloads=3)
    ref = TpuStorage(config=JCFG, mesh=make_mesh(1), pad_to_multiple=256,
                     archive_max_span_count=100_000)
    for p in ps:
        assert ref.ingest_json_fast(p) is not None
    port = make_store()
    ingest_mp(port, ps, workers=1, coalesce_max=1)
    assert_leaves_equal(port, ref)
    assert port.agg.host_counters == ref.agg.host_counters
    assert port.vocab.services._names == ref.vocab.services._names
    assert port.vocab._key_list == ref.vocab._key_list


def test_spawned_workers_load_no_torch():
    """A live worker that has parsed a payload maps the native parser's
    library and no torch library (``/proc/<pid>/maps``); and the modules a
    worker imports leave ``torch`` out of ``sys.modules``."""
    store = make_store()
    ing = MultiProcessIngester(store, workers=1)
    try:
        ing.submit(payloads(1, 256)[0])
        ing.drain()
        with open(f"/proc/{ing._procs[0].pid}/maps") as f:
            maps = f.read()
    finally:
        ing.close()
    assert "span_json" in maps  # the check sees what the worker loaded
    assert "libtorch" not in maps and "libc10" not in maps and "libcuda" not in maps
    code = ("import sys\n"
            "from zipkin_tpu_torch.tpu import mp_ingest\n"
            "from zipkin_tpu_torch import native, faults\n"
            "from zipkin_tpu_torch.tpu import archive, columnar, ring\n"
            "assert native.available()\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in ('torch', 'jax', 'zipkin_tpu')))\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    done = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                          timeout=120, env=dict(os.environ, PYTHONPATH=root))
    assert done.returncode == 0, done.stderr
    assert done.stdout.strip() == "[]"

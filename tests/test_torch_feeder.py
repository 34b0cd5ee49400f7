"""The port's threaded feeder (``zipkin_tpu_torch.tpu.feeder``) on the CPU.

The reference's own cases (``tests/test_feeder.py``) run against the port:
the pipeline lands every span with the synchronous path's answers, applies
the boundary sampler on both the fast path and the object-path fallback,
surfaces a failure in the dispatch stage instead of deadlocking, and falls
back for payloads the native parser refuses. Across packages: the feeder's
store equals the JAX package's synchronous ``ingest_json_fast`` on a
one-shard mesh, by name (the feeder does not keep the order across
batches, so ids can differ).

Tolerances: counters, histogram quantiles, dependency links and archive
reads exact; against the JAX package counters, links and the archived
trace ids exact, histogram quantiles and HLL estimates rtol 1e-6 (float32
ops in another order, as ``tests/test_torch_store.py``), digests not
compared (their flush points follow the batch order).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from tests.fixtures import TRACE, lots_of_spans
from tests.test_torch_store import assert_cards_match, assert_rows_match
import tests.torch_cpu  # noqa: F401  (one intra-op thread a test process)
from zipkin_tpu import native as ref_native
from zipkin_tpu.model import json_v2 as ref_json
from zipkin_tpu.parallel.mesh import make_mesh
from zipkin_tpu.tpu.state import AggConfig as JConfig
from zipkin_tpu.tpu.store import TpuStorage
from zipkin_tpu_torch import native
from zipkin_tpu_torch.collector import CollectorSampler
from zipkin_tpu_torch.tpu.feeder import AsyncIngestFeeder
from zipkin_tpu_torch.tpu.state import AggConfig
from zipkin_tpu_torch.tpu.store import TorchStorage

JSMALL = JConfig(max_services=64, max_keys=256, hll_precision=8, digest_centroids=16,
                 digest_buffer=4096, ring_capacity=4096, link_buckets=4, hist_slices=2)
SMALL = AggConfig(**dataclasses.asdict(JSMALL))

pytestmark = pytest.mark.skipif(not native.available() or not ref_native.available(),
                                reason="no C compiler for the native parser")


def make_store():
    return TorchStorage(config=SMALL, device="cpu", pad_to_multiple=256, fast_archive_sample=1)


def split(spans, per=500):
    return [ref_json.encode_span_list(spans[i:i + per]) for i in range(0, len(spans), per)]


def links(store, end_ts):
    return sorted((x.parent, x.child, x.call_count, x.error_count)
                  for x in store.get_dependencies(end_ts, 10**15).execute())


def test_feeder_matches_synchronous_path():
    spans = lots_of_spans(3000, seed=21, services=5, span_names=8)
    payloads = split(spans)
    sync_store = make_store()
    for p in payloads:
        sync_store.ingest_json_fast(p)
    async_store = make_store()
    with AsyncIngestFeeder(async_store, depth=3) as feeder:
        for p in payloads:
            feeder.submit(p)
    assert feeder._accepted == len(spans)
    assert async_store.ingest_counters()["spans"] == sync_store.ingest_counters()["spans"] == len(spans)
    assert async_store.latency_quantiles([0.5, 0.99], use_digest=False) == \
        sync_store.latency_quantiles([0.5, 0.99], use_digest=False)
    end_ts = max(s.timestamp for s in spans if s.timestamp) // 1000 + 3_600_000
    assert links(async_store, end_ts) == links(sync_store, end_ts) != []
    assert async_store.get_trace(spans[0].trace_id).execute() != []  # the 1-in-1 sample


def test_feeder_applies_sampler():
    spans = lots_of_spans(2000, seed=5, services=4, span_names=4)
    store = make_store()
    with AsyncIngestFeeder(store, sampler=CollectorSampler(0.3)) as feeder:
        feeder.submit(ref_json.encode_span_list(spans))
    assert feeder._accepted + feeder._dropped == len(spans)
    assert 0 < feeder._accepted < len(spans)
    assert store.agg.host_counters["spans"] == feeder._accepted


def _escaped_trace() -> bytes:
    # escaped span names are the native parser's documented punt
    return ref_json.encode_span_list(TRACE).replace(b"get /", b"get \\u002f")


def test_fallback_path_applies_sampler_too():
    """The object-path fallback samples as the collector would, or a
    payload with escaped strings would ingest at 100% while the fast path
    samples."""
    store = make_store()
    payload = _escaped_trace()
    assert native.parse_spans(payload) is None
    with AsyncIngestFeeder(store, sampler=CollectorSampler(0.0)) as feeder:
        feeder.submit(payload)
    assert feeder._fallback == 1
    assert feeder._accepted == 0
    assert feeder._dropped == len(TRACE)


def test_error_in_dispatch_surfaces_instead_of_deadlocking():
    store = make_store()
    feeder = AsyncIngestFeeder(store, depth=1)

    def boom(parsed, cols):
        raise RuntimeError("device gone")

    store._fast_dispatch = boom
    payload = ref_json.encode_span_list(TRACE)
    with pytest.raises(RuntimeError):
        # enough submissions to fill both bounded queues past the failure
        for _ in range(20):
            feeder.submit(payload)
        feeder.drain()
    # the stages keep consuming after the failure: drain ends both threads
    with pytest.raises(RuntimeError, match="feeder failed"):
        feeder.drain()
    assert not feeder._parse_t.is_alive() and not feeder._dispatch_t.is_alive()


def test_feeder_falls_back_for_escaped_strings():
    store = make_store()
    with AsyncIngestFeeder(store) as feeder:
        feeder.submit(_escaped_trace())
    assert feeder._fallback == 1
    assert feeder._accepted == len(TRACE)
    assert store.get_trace(TRACE[0].trace_id).execute() != []


def test_feeder_equals_the_reference_sync_path_by_name():
    """The JAX package's synchronous path and the port's feeder on the same
    payloads: counters, histogram rows by (service, span name), dependency
    links and cardinalities equal."""
    spans = lots_of_spans(3000, seed=23, services=6, span_names=7)
    payloads = split(spans)
    ref = TpuStorage(config=JSMALL, mesh=make_mesh(1), pad_to_multiple=256, fast_archive_sample=1)
    for p in payloads:
        assert ref.ingest_json_fast(p) is not None
    port = make_store()
    with AsyncIngestFeeder(port, depth=2) as feeder:
        for p in payloads:
            feeder.submit(p)
    want = dict(ref.agg.host_counters)
    got = dict(port.agg.host_counters)
    assert got == want
    key = lambda r: (r["serviceName"], r["spanName"])  # noqa: E731
    assert_rows_match(sorted(port.latency_quantiles([0.5, 0.99], use_digest=False), key=key),
                      sorted(ref.latency_quantiles([0.5, 0.99], use_digest=False), key=key),
                      rtol=1e-6)
    end_ts = max(s.timestamp for s in spans) // 1000 + 3_600_000
    assert links(port, end_ts) == links(ref, end_ts) != []
    assert_cards_match(port.trace_cardinalities(), ref.trace_cardinalities())
    np.testing.assert_array_equal(sorted(t[0].trace_id for t in port._archive.get_all_traces()),
                                  sorted(t[0].trace_id for t in ref._archive.get_all_traces()))

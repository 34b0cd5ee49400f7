"""The line-rate path of the port: ``TorchStorage.ingest_json_fast`` (device
"cpu") against the JAX package's ``TpuStorage.ingest_json_fast`` on a
one-shard mesh, the collector that routes to it, and the throttle that
wraps it.

Parity runs the same payload bytes, in the same order, through both
stores at the same small config. Tolerances are those of
``tests/test_torch_store.py``: integer leaves and answers exact; digest
means rtol 1e-5 (cluster sums in another order than XLA's), histogram
quantiles and HLL estimates rtol 1e-6.
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np
import pytest

import tests.torch_cpu  # noqa: F401  (one intra-op thread a test process)
from tests.fixtures import TRACE, lots_of_spans
from tests.test_torch_store import (
    JSMALL, QS, SMALL, WEEK_MS, assert_cards_match, assert_rows_match, links, ref_store,
    small_store, to_port)
from zipkin_tpu import native as ref_native
from zipkin_tpu.collector.core import CollectorSampler as RefSampler
from zipkin_tpu.collector.core import InMemoryCollectorMetrics as RefMetrics
from zipkin_tpu.model import json_v2 as ref_json
from zipkin_tpu.model import proto3 as ref_proto3
from zipkin_tpu_torch import native
from zipkin_tpu_torch.collector import Collector, CollectorSampler, InMemoryCollectorMetrics
from zipkin_tpu_torch.model import json_v2 as port_json
from zipkin_tpu_torch.storage.memory import InMemoryStorage
from zipkin_tpu_torch.storage.spi import FastIngestError
from zipkin_tpu_torch.storage.throttle import RejectedExecutionError, ThrottledStorage
from zipkin_tpu_torch.tpu.columnar import Vocab, pack_spans
from zipkin_tpu_torch.tpu.state import AggConfig, AggState
from zipkin_tpu_torch.utils.call import Call


@pytest.fixture
def compiler():
    if not native.available() or not ref_native.available():
        pytest.skip("no C compiler for the native parser")


def payloads(spans, per: int = 1000):
    """``per``-span payloads, JSON v2 and proto3 by turns."""
    return [(ref_proto3 if i % 2 else ref_json).encode_span_list(spans[lo : lo + per])
            for i, lo in enumerate(range(0, len(spans), per))]


def retained(store):
    return sorted((s.trace_id, s.id, bool(s.shared))
                  for t in store._archive.get_all_traces() for s in t)


def assert_leaves_equal(port, ref) -> None:
    """Integer leaves bit for bit; digest weights exact, means rtol 1e-5."""
    for name, g, w in zip(AggState._fields, port.agg.state_arrays(), ref.agg.state_arrays()):
        if name in ("digest", "tb_digest"):
            np.testing.assert_array_equal(g[..., 1], w[..., 1], err_msg=name)
            np.testing.assert_allclose(g[..., 0], w[..., 0], rtol=1e-5, err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


# -- the store ----------------------------------------------------------------


@pytest.fixture(scope="module")
def sampled_pair():
    """6,000 spans in 1,000-span payloads, JSON v2 and proto3 by turns,
    through both stores' fast paths under a 0.3 boundary sampler, with the
    sampling tier on and the same tables published on both."""
    if not native.available() or not ref_native.available():
        pytest.skip("no C compiler for the native parser")
    cfg_j = dataclasses.replace(JSMALL, sampling=True)
    ref = ref_store(config=cfg_j, archive_max_span_count=100_000)
    port = small_store(config=AggConfig(**dataclasses.asdict(cfg_j)), archive_max_span_count=100_000)
    rate = np.full(SMALL.max_services, 65536 // 3, np.uint32)
    for store in (ref, port):
        store._deps_max_stale_ms = 0.0
        store.sampler.set_tables(rate, store.sampler.tail, np.full_like(store.sampler.link, 1 << 20))
        store.install_sampler()
    spans = lots_of_spans(6000, seed=42, services=6, span_names=8)
    results = [(port.ingest_json_fast(p, CollectorSampler(0.3)),
                ref.ingest_json_fast(p, RefSampler(0.3))) for p in payloads(spans)]
    end_ts = max(s.timestamp for s in spans) // 1000 + 60_000
    return spans, ref, port, end_ts, results


def test_fast_ingest_accepts_and_drops_as_the_reference(sampled_pair):
    spans, _, port, _, results = sampled_pair
    assert all(got == want for got, want in results)
    accepted = sum(a for (a, _), _ in results)
    dropped = sum(d for (_, d), _ in results)
    assert accepted + dropped == len(spans) and 0 < accepted < len(spans)
    assert port.ingest_counters()["spans"] == accepted
    assert port.ingest_counters()["nativeVocabOverflow"] == 0


def test_fast_ingest_state_leaves_equal(sampled_pair):
    _, ref, port, _, _ = sampled_pair
    assert_leaves_equal(port, ref)
    assert port.agg.host_counters == ref.agg.host_counters
    assert port.agg.host_counters["sampledDropped"] > 0


def test_fast_ingest_reads_equal(sampled_pair):
    _, ref, port, end_ts, _ = sampled_pair
    want = links(ref.get_dependencies(end_ts, WEEK_MS).execute())
    assert want and links(port.get_dependencies(end_ts, WEEK_MS).execute()) == want
    for use_digest in (False, True):
        assert_rows_match(port.latency_quantiles(QS, use_digest=use_digest),
                          ref.latency_quantiles(QS, use_digest=use_digest),
                          rtol=1e-5 if use_digest else 1e-6)
    assert_cards_match(port.trace_cardinalities(), ref.trace_cardinalities())
    assert port.vocab._key_list == ref.vocab._key_list


def test_fast_ingest_archives_the_same_sample(sampled_pair):
    """The RAM archive holds the same trace-affine 1/64 sample of the
    verdict-kept spans, each equal to its generated span."""
    spans, ref, port, _, _ = sampled_pair
    kept = retained(port)
    assert kept == retained(ref) and 0 < len(kept) < len(spans) // 10
    by_key = {(s.trace_id, s.id, bool(s.shared)): s for s in spans}
    for trace in port._archive.get_all_traces():
        for s in trace:
            want = by_key[(s.trace_id, s.id, bool(s.shared))]
            assert port_json.encode_span(s) == port_json.encode_span(to_port([want])[0])


def test_fast_path_matches_object_path(compiler):
    """One store fed by accept(), one by ingest_json_fast(): the same
    leaves, and every span counted once (fast archive sample off)."""
    spans = lots_of_spans(3000, seed=14)
    slow, fast = small_store(), small_store(fast_archive_sample=0)
    slow.accept(to_port(spans)).execute()
    assert fast.ingest_json_fast(ref_json.encode_span_list(spans)) == (len(spans), 0)
    for name, g, w in zip(AggState._fields, fast.agg.state_arrays(), slow.agg.state_arrays()):
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert fast.ingest_counters()["spans"] == len(spans)
    assert fast._archive.span_count == 0


def test_fast_ingest_chunks_a_payload_past_the_device_batch(compiler):
    spans = lots_of_spans(2500, seed=6)
    whole, cut = small_store(), small_store(max_device_batch=1024)
    assert cut.max_batch == 1024
    data = ref_json.encode_span_list(spans)
    assert whole.ingest_json_fast(data) == cut.ingest_json_fast(data) == (len(spans), 0)
    assert cut.ingest_counters()["batches"] == 3
    assert retained(whole) == retained(cut)


def test_fast_ingest_refuses_what_it_cannot_parse(compiler):
    store = small_store()
    assert store.ingest_json_fast(b'[{"traceId":"a","id":"b","name":"we\\"ird"}]') is None
    assert store.ingest_json_fast(b"\x0c\x00") is None  # thrift: object path only
    assert store.ingest_json_fast(b"[]") == (0, 0)
    assert store.ingest_counters()["spans"] == 0


def test_warm_ingests_through_either_path(compiler):
    store = small_store()
    store.warm(ref_json.encode_span_list(TRACE))
    store.warm(b'[{"traceId":"a","id":"b","name":"we\\"ird"}]')
    assert store.ingest_counters()["batches"] > 0
    assert store.get_trace("000000000000000a").execute()


def test_object_then_fast_then_object_ids_stay_coherent(compiler):
    """Port of tests/test_native_codec.py:155: interning alternates between
    Python (object path) and C (fast path) and the ids stay those a pure
    Python vocab assigns in the same first-seen order."""
    store = small_store()
    a = lots_of_spans(300, seed=31, services=3, span_names=4)
    b = lots_of_spans(300, seed=32, services=6, span_names=8)
    c = lots_of_spans(300, seed=33, services=9, span_names=12)
    store.accept(to_port(a)).execute()
    store.ingest_json_fast(ref_json.encode_span_list(b))
    store.accept(to_port(c)).execute()
    store.ingest_json_fast(ref_json.encode_span_list(a))
    ref = Vocab(SMALL.max_services, SMALL.max_keys)
    for spans in (a, b, c, a):
        pack_spans(to_port(spans), ref, pad_to_multiple=256)
    assert store.vocab.services._names == ref.services._names
    assert store.vocab.span_names._names == ref.span_names._names
    assert store.vocab._key_list == ref._key_list
    svcs = {r["serviceName"] for r in store.latency_quantiles([0.5], use_digest=False)}
    assert {"svc00", "svc08"} <= svcs


# -- the collector --------------------------------------------------------------


@pytest.mark.parametrize("rate", [0.0, 0.001, 0.3, 0.5, 0.999999, 1.0])
def test_sampler_matches_reference_over_u64_ids(rate):
    rng = np.random.default_rng(5)
    ids = [int(x) for x in rng.integers(0, 1 << 63, 500, dtype=np.uint64)]
    ids += [int(x) | (1 << 63) for x in ids[:250]]
    ids += [0, 1, 1 << 63, (1 << 63) - 1, (1 << 63) + 1, (1 << 64) - 1]  # 1 << 63: Long.MIN_VALUE
    port, ref = CollectorSampler(rate), RefSampler(rate)
    assert [port.is_sampled(t) for t in ids] == [ref.is_sampled(t) for t in ids]
    assert port.is_sampled(1 << 63, debug=True)
    assert port.is_sampled(1 << 63) == (rate == 1.0)
    with pytest.raises(ValueError):
        CollectorSampler(1.5)


def test_metrics_taxonomy_matches_reference():
    port, ref = InMemoryCollectorMetrics(), RefMetrics()
    for m in (port, ref):
        http, grpc = m.for_transport("http"), m.for_transport("grpc")
        http.increment_messages()
        http.increment_bytes(120)
        http.increment_spans(7)
        http.increment_spans_dropped(2)
        http.increment_messages_dropped()
        grpc.increment_messages()
        m.increment_spans(1)
    assert port.snapshot() == ref.snapshot()
    assert port.get("spans", "http") == 7 and port.get("messages", "grpc") == 1


def test_collector_uses_fast_path_and_samples(compiler):
    store = small_store()
    metrics = InMemoryCollectorMetrics()
    collector = Collector(store, sampler=CollectorSampler(0.2), metrics=metrics.for_transport("http"),
                          fast_ingest=True)
    spans = lots_of_spans(2000, seed=15)
    accepted = collector.accept_spans_bytes(ref_json.encode_span_list(spans))
    assert accepted == sum(1 for s in spans if RefSampler(0.2).test(s))
    assert 0 < accepted < len(spans)
    assert accepted + metrics.get("spans_dropped", "http") == metrics.get("spans", "http") == len(spans)
    assert store.ingest_counters()["spans"] == accepted


def test_collector_falls_back_to_the_object_path(compiler):
    """An escaped string is outside the parser's domain: the payload goes
    to the Python codec and lands whole in the archive."""
    store = small_store()
    metrics = InMemoryCollectorMetrics()
    collector = Collector(store, metrics=metrics, fast_ingest=True)
    body = b'[{"traceId":"000000000000000a","id":"000000000000000b","name":"we\\"ird",' \
           b'"timestamp":1785283200000000,"duration":5,"localEndpoint":{"serviceName":"s"}}]'
    assert store.ingest_json_fast(body) is None
    assert collector.accept_spans_bytes(body) == 1
    assert [s.name for s in store.get_trace("000000000000000a").execute()] == ['we"ird']
    with pytest.raises(ValueError):
        collector.accept_spans_bytes(b"\xffnot-spans")
    assert metrics.snapshot() == {"messages": 2, "bytes": len(body) + 10, "spans": 1,
                                  "messages_dropped": 1}


def test_collector_counts_a_shed_fast_ingest(compiler):
    """A throttle shed on the fast path raises to the transport and shows
    as messages_dropped, as on the object path."""
    inner = small_store()
    storage = ThrottledStorage(inner, max_concurrency=1, max_queue=1)
    metrics = InMemoryCollectorMetrics()
    collector = Collector(storage, metrics=metrics.for_transport("http"), fast_ingest=True)
    assert collector.fast_ingest
    gate, release = threading.Event(), threading.Event()
    parse = inner._fast_parse

    def slow_parse(data, sampler=None):
        gate.set()
        release.wait(10)
        return parse(data, sampler)

    inner._fast_parse = slow_parse
    body = ref_json.encode_span_list(TRACE)
    t = threading.Thread(target=collector.accept_spans_bytes, args=(body,), daemon=True)
    t.start()
    assert gate.wait(10)
    with pytest.raises(RejectedExecutionError):
        collector.accept_spans_bytes(body)
    release.set()
    t.join(10)
    assert not t.is_alive()
    assert metrics.get("messages_dropped", "http") == 1
    assert metrics.get("spans", "http") == len(TRACE)


def test_collector_never_reingests_after_a_device_failure(compiler):
    """A failure after the parse (here from the second device batch of
    three on) leaves the first batch stored: the collector counts the payload
    dropped and does not send it down the object path a second time."""
    store = small_store(max_device_batch=1024)
    ingest, calls = store.agg.ingest, []

    def failing_ingest(cols):
        calls.append(cols)
        if len(calls) >= 2:
            raise ValueError("device batch refused")
        return ingest(cols)

    store.agg.ingest = failing_ingest
    metrics = InMemoryCollectorMetrics()
    collector = Collector(store, metrics=metrics, fast_ingest=True)
    spans = lots_of_spans(2500, seed=6)
    assert collector.accept_spans_bytes(ref_json.encode_span_list(spans)) == 0
    assert len(calls) == 2
    assert store.ingest_counters()["spans"] == 1024
    assert metrics.snapshot() == {"messages": 1, "bytes": len(ref_json.encode_span_list(spans)),
                                  "spans": len(spans), "spans_dropped": len(spans)}
    with pytest.raises(FastIngestError) as err:
        store.ingest_json_fast(ref_json.encode_span_list(TRACE))
    assert err.value.spans == len(TRACE) and isinstance(err.value.__cause__, ValueError)
    assert len(calls) == 3 and store.ingest_counters()["spans"] == 1024


def test_an_undecodable_sampled_span_skips_only_itself(compiler):
    """The native parser takes an annotation timestamp of 1e400, which the
    codec then refuses (OverflowError) when the archive sample decodes the
    span. As in the reference, that one span is not archived; the payload is
    ingested whole and the collector drops nothing."""
    import json

    spans = json.loads(ref_json.encode_span_list(lots_of_spans(6, seed=3)))
    spans[1]["annotations"] = [{"timestamp": 0, "value": "v"}]
    body = json.dumps(spans).replace('"timestamp": 0, "value"', '"timestamp": 1e400, "value"')
    body = body.encode()
    assert b"1e400" in body
    ref, port = ref_store(fast_archive_sample=1), small_store(fast_archive_sample=1)
    assert port.ingest_json_fast(body) == ref.ingest_json_fast(body) == (6, 0)
    assert retained(port) == retained(ref) and len(retained(port)) == 5
    assert_leaves_equal(port, ref)
    metrics = InMemoryCollectorMetrics()
    collector = Collector(small_store(fast_archive_sample=1), metrics=metrics, fast_ingest=True)
    assert collector.accept_spans_bytes(body) == 6
    assert metrics.snapshot().get("spans_dropped", 0) == 0


# -- the throttle (ports of tests/test_server.py TestThrottle and
# tests/test_backpressure_and_edges.py TestThrottleDelegation) ----------------


def test_throttle_passes_through():
    storage = ThrottledStorage(InMemoryStorage())
    storage.span_consumer().accept(to_port(TRACE)).execute()
    assert len(storage.span_store().get_trace(TRACE[0].trace_id).execute()) == len(TRACE)
    assert storage.check().ok


def test_throttle_sheds_when_queue_full():
    inner = InMemoryStorage()
    storage = ThrottledStorage(inner, max_concurrency=1, max_queue=1)
    gate, release = threading.Event(), threading.Event()
    original = inner.span_consumer().accept

    class SlowConsumer:
        def accept(self, spans):
            call = original(spans)

            def slow():
                gate.set()
                release.wait(5)
                return call.execute()

            return Call.of(slow)

    storage.delegate.span_consumer = lambda: SlowConsumer()
    throttled = storage.span_consumer()
    t = threading.Thread(target=lambda: throttled.accept(to_port(TRACE)).execute(), daemon=True)
    t.start()
    assert gate.wait(5)
    with pytest.raises(RejectedExecutionError):
        throttled.accept(to_port(TRACE)).execute()
    release.set()
    t.join(5)
    assert not t.is_alive()


def test_extension_methods_visible_through_throttle():
    class FakeDevice(InMemoryStorage):
        def latency_quantiles(self, qs, service_name=None, span_name=None, use_digest=True):
            return ["row"]

    wrapped = ThrottledStorage(FakeDevice())
    assert hasattr(wrapped, "latency_quantiles")
    assert wrapped.latency_quantiles([0.5]) == ["row"]


def test_missing_attr_still_raises():
    wrapped = ThrottledStorage(InMemoryStorage())
    with pytest.raises(AttributeError):
        wrapped.definitely_not_a_method

"""TorchStorage (device="cpu") against the storage contract and against the
JAX package's TpuStorage.

The contract suite (``tests/storage_contract.py``) runs twice, strict and
lenient trace ids. It speaks the JAX package's model, so an adapter crosses
at the wire: spans go in as ``zipkin_tpu`` JSON v2 bytes decoded by the
port's codec, and spans and links come back the same way. The port never
sees a foreign object.

Parity: the same batches, in the same order, go through a one-shard
TpuStorage (jitted on the CPU) and the port at the same small config, so the
vocab ids, and with them every sketch row, match. Tolerances are those of
``tests/test_torch_ingest.py``: integer answers (counts, links, names,
traces) exact; histogram quantiles and HLL estimates rtol 1e-6 (float32 ops
in another order); digest quantiles rtol 1e-5 (cluster sums in another
order than XLA's).
"""

from __future__ import annotations

import dataclasses
import random

import numpy as np
import pytest

from tests.fixtures import TODAY_US, lots_of_spans
from tests.storage_contract import StorageContract
import tests.torch_cpu  # noqa: F401  (one intra-op thread a test process)
from zipkin_tpu.model import json_v2 as ref_json
from zipkin_tpu.model.span import Endpoint, Kind, Span
from zipkin_tpu.parallel.mesh import make_mesh
from zipkin_tpu.tpu.state import AggConfig as JConfig
from zipkin_tpu.tpu.store import TpuStorage
from zipkin_tpu_torch import convert
from zipkin_tpu_torch.model import json_v2 as port_json
from zipkin_tpu_torch.storage import spi as port_spi
from zipkin_tpu_torch.tpu.state import AggConfig
from zipkin_tpu_torch.tpu.store import TorchStorage
from zipkin_tpu_torch.utils.call import Call

# tests/test_tpu_store.py's small config
JSMALL = JConfig(
    max_services=128, max_keys=512, hll_precision=10,
    digest_centroids=32, ring_capacity=1 << 14,
)
SMALL = AggConfig(**dataclasses.asdict(JSMALL))
QS = [0.5, 0.9, 0.99]
WEEK_MS = 7 * 86_400_000


def to_port(spans):
    return port_json.decode_span_list(ref_json.encode_span_list(spans))


def to_ref(spans):
    return ref_json.decode_span_list(port_json.encode_span_list(spans))


class WireStorage:
    """The contract's view of a TorchStorage: reference objects in and out,
    crossing at JSON v2 bytes."""

    def __init__(self, inner: TorchStorage) -> None:
        self.inner = inner

    def span_consumer(self):
        return self

    def span_store(self):
        return self

    def traces(self):
        return self

    def service_and_span_names(self):
        return self.inner.service_and_span_names()

    def autocomplete_tags(self):
        return self.inner.autocomplete_tags()

    def check(self):
        return self.inner.check()

    def accept(self, spans):
        return self.inner.accept(to_port(spans))

    def get_trace(self, trace_id):
        return Call.of(lambda: to_ref(self.inner.get_trace(trace_id).execute()))

    def get_traces(self, trace_ids):
        return Call.of(lambda: [to_ref(t) for t in self.inner.get_traces(trace_ids).execute()])

    def get_traces_query(self, request):
        fields = {f.name: getattr(request, f.name) for f in dataclasses.fields(request)}
        ported = port_spi.QueryRequest(**fields)
        return Call.of(lambda: [to_ref(t) for t in self.inner.get_traces_query(ported).execute()])

    def get_dependencies(self, end_ts, lookback):
        return Call.of(lambda: ref_json.decode_link_list(port_json.encode_link_list(
            self.inner.get_dependencies(end_ts, lookback).execute())))


def small_store(**kwargs) -> TorchStorage:
    kwargs.setdefault("config", SMALL)
    kwargs.setdefault("pad_to_multiple", 256)
    return TorchStorage(device="cpu", **kwargs)


def ref_store(**kwargs) -> TpuStorage:
    kwargs.setdefault("config", JSMALL)
    kwargs.setdefault("pad_to_multiple", 256)
    return TpuStorage(mesh=make_mesh(1), **kwargs)


class TestTorchStorageContract(StorageContract):
    def make_storage(self, **kwargs):
        return WireStorage(small_store(**kwargs))


class TestTorchStorageContractLenient(StorageContract):
    """The whole contract again with lenient trace ids (64- and 128-bit
    renditions collapse); tests that pin the flag keep their value."""

    def make_storage(self, **kwargs):
        kwargs.setdefault("strict_trace_id", False)
        return WireStorage(small_store(**kwargs))


def feed(pairs, spans, chunk: int = 1000) -> None:
    """The same chunks, in the same order, into (reference, port) stores."""
    for i in range(0, len(spans), chunk):
        part = spans[i : i + chunk]
        for ref, port in pairs:
            ref.accept(part).execute()
            port.accept(to_port(part)).execute()


def links(store):
    return {(x.parent, x.child): (x.call_count, x.error_count) for x in store}


def assert_rows_match(got, want, rtol: float) -> None:
    assert [(r["serviceName"], r["spanName"], r["count"]) for r in got] == \
        [(r["serviceName"], r["spanName"], r["count"]) for r in want]
    assert got, "expected sketch rows"
    for g, w in zip(got, want):
        assert list(g["quantiles"]) == list(w["quantiles"])
        np.testing.assert_allclose(list(g["quantiles"].values()), list(w["quantiles"].values()),
                                   rtol=rtol)


def assert_cards_match(got: dict, want: dict) -> None:
    assert list(got) == list(want)
    np.testing.assert_allclose(list(got.values()), list(want.values()), rtol=1e-6)


@pytest.fixture(scope="module")
def loaded():
    spans = lots_of_spans(6000, seed=42, services=6, span_names=8)
    ref = ref_store(archive_max_span_count=100_000)
    port = small_store(archive_max_span_count=100_000)
    ref._deps_max_stale_ms = port._deps_max_stale_ms = 0.0
    feed([(ref, port)], spans)
    end_ts = max(s.timestamp for s in spans) // 1000 + 60_000
    return spans, ref, port, end_ts


def test_dependency_links_equal(loaded):
    _, ref, port, end_ts = loaded
    want = links(ref.get_dependencies(end_ts, WEEK_MS).execute())
    assert want and links(port.get_dependencies(end_ts, WEEK_MS).execute()) == want


@pytest.mark.parametrize("use_digest", [False, True], ids=["hist", "digest"])
def test_latency_quantile_rows_match(loaded, use_digest):
    _, ref, port, _ = loaded
    assert_rows_match(port.latency_quantiles(QS, use_digest=use_digest),
                      ref.latency_quantiles(QS, use_digest=use_digest),
                      rtol=1e-5 if use_digest else 1e-6)
    assert_rows_match(port.latency_quantiles(QS, service_name="svc01", use_digest=use_digest),
                      ref.latency_quantiles(QS, service_name="svc01", use_digest=use_digest),
                      rtol=1e-5 if use_digest else 1e-6)


def test_windowed_hist_quantiles_match(loaded):
    _, ref, port, end_ts = loaded
    kw = dict(use_digest=False, end_ts=end_ts, lookback=3_600_000)
    assert_rows_match(port.latency_quantiles(QS, **kw), ref.latency_quantiles(QS, **kw), rtol=1e-6)


def test_trace_cardinalities_match(loaded):
    _, ref, port, _ = loaded
    assert_cards_match(port.trace_cardinalities(), ref.trace_cardinalities())


def test_sketch_overview_matches(loaded):
    _, ref, port, _ = loaded
    got, want = port.sketch_overview(QS), ref.sketch_overview(QS)
    assert_rows_match(got["percentiles"], want["percentiles"], rtol=1e-5)
    assert_cards_match(got["cardinalities"], want["cardinalities"])
    # the store's own counters; transfer bytes and the device observatory's
    # totals are process-wide, and the timing, cache-age and query-plane
    # (lock ledger, query walls) gauges are wall clock
    skip = {"hostTransferBytes", "ctxMaintenanceMs", "readCacheServeAgeMs",
            "readCacheServeAgeMaxMs", "ttWindowMergeMsLast", "ttSealWallMsLast"}
    shared = {k for k in (set(got["counters"]) & set(want["counters"])) - skip
              if not k.startswith(("device", "query"))}
    assert {"spans", "batches", "hostTransfers", "ctxAdvances", "keyVocabOverflow"} <= shared
    assert {k: got["counters"][k] for k in shared} == {k: want["counters"][k] for k in shared}


def test_names_match(loaded):
    _, ref, port, _ = loaded
    services = ref.get_service_names().execute()
    assert services and port.get_service_names().execute() == services
    for svc in services + ["nope"]:
        assert port.get_span_names(svc).execute() == ref.get_span_names(svc).execute()
        assert port.get_remote_service_names(svc).execute() == \
            ref.get_remote_service_names(svc).execute()
    assert port.vocab.services._names == ref.vocab.services._names
    assert port.vocab._key_list == ref.vocab._key_list


def test_every_trace_equal_as_json(loaded):
    spans, ref, port, _ = loaded
    ids = sorted({s.trace_id for s in spans})
    for tid in ids:
        got = port_json.encode_span_list(port.get_trace(tid).execute())
        assert got == ref_json.encode_span_list(ref.get_trace(tid).execute()), tid
    assert len(port.get_traces(ids[:50]).execute()) == 50


def test_ingest_counters_count_every_span(loaded):
    spans, _, port, _ = loaded
    c = port.ingest_counters()
    assert c["spans"] == len(spans)
    assert c["spansWithDuration"] == sum(1 for s in spans if s.duration is not None)
    assert c["batches"] == len(spans) // 1000


def test_restored_vocab_and_state_answer_the_same():
    """A reference store's vocab (plain lists) and state leaves (numpy)
    carried into a fresh TorchStorage give its answers."""
    spans = lots_of_spans(1500, seed=5, services=5, span_names=6)
    ref = ref_store()
    for i in range(0, len(spans), 500):
        ref.accept(spans[i : i + 500]).execute()
    port = small_store()
    v = ref.vocab
    port.vocab = convert.vocab_from_reference(
        v.services._names, v.span_names._names, v._key_list,
        max_services=SMALL.max_services, max_keys=SMALL.max_keys)
    port.agg.states = convert.state_from_numpy(ref.agg.state_arrays(), SMALL, device="cpu")
    port.agg.sync_pend_lanes()
    end_ts = max(s.timestamp for s in spans) // 1000 + 60_000
    assert links(port.get_dependencies(end_ts, WEEK_MS).execute()) == \
        links(ref.get_dependencies(end_ts, WEEK_MS).execute())
    assert_rows_match(port.latency_quantiles(QS, use_digest=False),
                      ref.latency_quantiles(QS, use_digest=False), rtol=1e-6)
    assert_rows_match(port.latency_quantiles(QS), ref.latency_quantiles(QS), rtol=1e-5)
    assert_cards_match(port.trace_cardinalities(), ref.trace_cardinalities())
    with pytest.raises(ValueError):
        convert.vocab_from_reference(["a"], [""], [(0, 0)])


def test_dense_fallback_when_the_edge_compaction_is_full():
    """More than 4096 distinct service pairs fill the [E] compaction: the
    store reads the dense matrices instead and drops no edge."""
    rng = random.Random(3)
    eps = [Endpoint.create(f"s{i:03d}") for i in range(SMALL.max_services - 1)]
    spans = []
    for i in range(8000):
        a, b = rng.sample(eps, 2)
        spans.append(Span.create(f"{i + 1:016x}", "1", name="call", kind=Kind.CLIENT,
                                 local_endpoint=a, remote_endpoint=b,
                                 timestamp=TODAY_US + i, duration=10,
                                 tags={"error": "x"} if i % 7 == 0 else {}))
    ref, port = ref_store(), small_store()
    feed([(ref, port)], spans, chunk=len(spans))
    end_ts = TODAY_US // 1000 + 60_000
    t0 = port.agg.read_stats["host_transfers"]
    got = links(port.get_dependencies(end_ts, WEEK_MS).execute())
    assert port.agg.read_stats["host_transfers"] - t0 == 2  # compaction, then dense
    assert len(got) > 4096
    assert got == links(ref.get_dependencies(end_ts, WEEK_MS).execute())


def test_time_tier_windows_after_seal_match():
    """Three 5-minute buckets; tt_seal seals up to the last; windowed
    quantile and dependency reads over sealed and mixed windows match."""
    base = lots_of_spans(3000, seed=8, services=5, span_names=4)
    minute = 60_000_000
    spans = []
    for i in range(3):
        for s in base[i * 1000 : (i + 1) * 1000]:
            spans.append(dataclasses.replace(s, timestamp=s.timestamp + i * 5 * minute))
    ref, port = ref_store(), small_store()
    ref._deps_max_stale_ms = port._deps_max_stale_ms = 0.0
    feed([(ref, port)], spans)
    # the ring holds 4 buckets: the empty one before the data seals too
    assert port.tt_seal() == ref.tt_seal() == 3
    assert port.timetier.sealed_through == ref.timetier.sealed_through
    first_ms = min(s.timestamp for s in spans) // 1000
    windows = [(first_ms + 9 * 60_000, 9 * 60_000),  # sealed buckets only
               (first_ms + 14 * 60_000, 14 * 60_000)]  # through the unsealed one
    for end_ts, lookback in windows:
        kw = dict(end_ts=end_ts, lookback=lookback)
        assert_rows_match(port.latency_quantiles(QS, **kw), ref.latency_quantiles(QS, **kw),
                          rtol=1e-5)
        assert links(port.get_dependencies(end_ts, lookback).execute()) == \
            links(ref.get_dependencies(end_ts, lookback).execute())
        assert_cards_match(port.trace_cardinalities(**kw), ref.trace_cardinalities(**kw))
    assert port.timetier.counters["ttWindowReads"] == ref.timetier.counters["ttWindowReads"] > 0


def test_sampled_archive_retains_the_same_spans():
    """With sampling on and the same published tables on both stores, the
    archive keeps the same verdict-kept spans while the sketches count all."""
    spans = lots_of_spans(3000, seed=4, services=6, span_names=5)
    cfg_j = dataclasses.replace(JSMALL, sampling=True)
    ref, port = ref_store(config=cfg_j), small_store(config=AggConfig(**dataclasses.asdict(cfg_j)))
    # a third of the traces by rate, and no edge counted as rare
    rate = np.full(SMALL.max_services, 65536 // 3, np.uint32)
    for store in (ref, port):
        link = np.full_like(store.sampler.link, 1 << 20)
        store.sampler.set_tables(rate, store.sampler.tail, link)
        store.install_sampler()
    feed([(ref, port)], spans)

    def retained(store):
        return sorted((s.trace_id, s.id, bool(s.shared))
                      for t in store._archive.get_all_traces() for s in t)

    kept = retained(port)
    assert kept == retained(ref) and 0 < len(kept) < len(spans)
    assert port.ingest_counters()["spans"] == len(spans)
    assert port.sampler_rates() == ref.sampler_rates()


def test_clear_keeps_the_device_and_drops_cached_answers():
    port = small_store()
    spans = lots_of_spans(400, seed=2, services=4, span_names=3)
    port.accept(to_port(spans)).execute()
    assert port.latency_quantiles(QS)
    port.clear()
    assert port.agg.device.type == "cpu"
    assert port.latency_quantiles(QS) == [] and port.get_trace(spans[0].trace_id).execute() == []
    assert port.check().ok

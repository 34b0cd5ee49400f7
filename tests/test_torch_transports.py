"""The port's broker transports (``zipkin_tpu_torch/collector/transports.py``):
the reference's ``tests/test_transports.py`` (7 cases) and
``tests/test_broker_sources.py`` (12 cases) against the port, with
``tests/fake_brokers.py``'s in-memory kafka-python, pika and stomp.py
fakes; the replay log and its ``.offset`` marker across the two packages;
and the same seeded payloads through both packages' ``TransportCollector``
into their device stores (the port's on the CPU).

Parity tolerances are those of ``tests/test_torch_fastpath.py``: integer
leaves (HLL registers, histograms, counters, ring) and dependency links
exact, digest weights exact and means rtol 1e-5. Every worker join and
poll loop has its own deadline.
"""

from __future__ import annotations

import time

import numpy as np
import pytest

import tests.torch_cpu  # noqa: F401  (one intra-op thread a test process)
from tests import fake_brokers as fb
from tests.fixtures import TRACE, lots_of_spans
from tests.test_torch_store import WEEK_MS, links, ref_store, small_store
from zipkin_tpu import native as ref_native
from zipkin_tpu.collector import transports as ref_transports
from zipkin_tpu.collector.core import Collector as RefCollector
from zipkin_tpu.model import json_v2 as ref_json
from zipkin_tpu.model import proto3 as ref_proto3
from zipkin_tpu_torch import native
from zipkin_tpu_torch.collector import transports as port_transports
from zipkin_tpu_torch.collector.core import Collector, InMemoryCollectorMetrics
from zipkin_tpu_torch.collector.transports import (
    ActiveMQSource,
    KafkaSource,
    QueueSource,
    RabbitMQSource,
    ReplayFileSource,
    TransportCollector,
    append_replay,
    kafka_collector,
)
from zipkin_tpu_torch.storage.memory import InMemoryStorage
from zipkin_tpu_torch.tpu.state import AggState

PAYLOAD = ref_json.encode_span_list(TRACE)


def _collector(storage, metrics=None, transport="queue"):
    m = (metrics or InMemoryCollectorMetrics()).for_transport(transport)
    return Collector(storage, metrics=m)


def _wait(pred, deadline_s=5.0):
    end = time.monotonic() + deadline_s
    while not pred() and time.monotonic() < end:
        time.sleep(0.02)


# -- tests/test_transports.py -------------------------------------------------


class TestQueueSource:
    def test_roundtrip_via_worker_threads(self):
        storage = InMemoryStorage()
        source = QueueSource()
        metrics = InMemoryCollectorMetrics()
        tc = TransportCollector(source, _collector(storage, metrics), transport="queue",
                                workers=2, poll_timeout=0.05)
        tc.start()
        try:
            for _ in range(5):
                source.send(PAYLOAD)
            _wait(lambda: storage.span_count >= 5 * len(TRACE))
            # raw rows keep duplicates (the reference's multimap); reads dedup
            assert storage.span_count == 5 * len(TRACE)
            assert len(storage.get_trace(TRACE[0].trace_id).execute()) == len(TRACE)
            assert metrics.get("messages", "queue") == 5
        finally:
            tc.close()
        assert not any(t.is_alive() for t in tc._threads)

    def test_malformed_payload_counted_dropped(self):
        storage = InMemoryStorage()
        source = QueueSource()
        metrics = InMemoryCollectorMetrics()
        tc = TransportCollector(source, _collector(storage, metrics), transport="queue")
        source.send(b"\xff\xffnot a span")
        tc.drain(2.0)
        assert metrics.get("messages_dropped", "queue") == 1
        assert storage.span_count == 0
        tc.close()


class TestReplayFile:
    def test_replay_and_offset_resume(self, tmp_path):
        path = str(tmp_path / "spans.replay")
        spans = lots_of_spans(300, seed=5)
        for lo in range(0, 300, 100):
            append_replay(path, [ref_json.encode_span_list(spans[lo:lo + 100])])

        storage = InMemoryStorage()
        src = ReplayFileSource(path)
        tc = TransportCollector(src, _collector(storage), transport="replay")
        tc.drain()
        assert storage.span_count == 300
        assert src.committed == 2
        tc.close()

        # resume: nothing re-delivered
        storage2 = InMemoryStorage()
        tc2 = TransportCollector(ReplayFileSource(path), _collector(storage2), transport="replay")
        tc2.drain(1.0)
        assert storage2.span_count == 0
        tc2.close()

        # append more; only the new message is delivered
        append_replay(path, [PAYLOAD])
        storage3 = InMemoryStorage()
        tc3 = TransportCollector(ReplayFileSource(path), _collector(storage3), transport="replay")
        tc3.drain()
        assert storage3.span_count == len(TRACE)
        tc3.close()

    def test_check_reports_closed(self, tmp_path):
        path = str(tmp_path / "x.replay")
        append_replay(path, [b"[]"])
        src = ReplayFileSource(path)
        assert src.check().ok
        src.close()
        assert not src.check().ok


class TestKafkaGated:
    def test_kafka_source_unavailable_raises_clearly(self):
        with pytest.raises(RuntimeError, match="kafka-python is not installed"):
            KafkaSource("broker:9092")


class TestCommitWatermark:
    """A fast worker must not commit past a slower worker's unstored
    offsets (cumulative-commit sources would mark them consumed)."""

    def test_watermark_holds_below_outstanding(self):
        source = QueueSource()
        tc = TransportCollector(source, _collector(InMemoryStorage()), transport="queue")
        # worker A polled 0-4 but has not stored them; worker B polled 5-9
        tc._outstanding.update(range(10))
        for off in range(5, 10):
            tc._mark_stored(off)
        assert source.committed == -1  # 0-4 still outstanding
        for off in range(5):
            tc._mark_stored(off)
        assert source.committed == 9  # everything stored: a full commit

    def test_poison_pill_advances_watermark(self):
        storage = InMemoryStorage()
        source = QueueSource()
        tc = TransportCollector(source, _collector(storage), transport="queue")
        source.send(b"\xff\xff garbage")
        source.send(PAYLOAD)
        tc.drain(2.0)
        assert source.committed == 1  # the pill is consumed, not stuck
        assert storage.span_count == len(TRACE)


# -- tests/test_broker_sources.py ---------------------------------------------


class TestKafkaSource:
    def test_poll_spans_partitions_and_sequences(self):
        with fb.installed():
            src = KafkaSource("broker1:9092,broker2:9092", topic="zipkin")
            consumer = fb.FakeKafkaConsumer.instances[-1]
            assert consumer.bootstrap_servers == ["broker1:9092", "broker2:9092"]
            consumer.feed(0, b"a")
            consumer.feed(1, b"b")
            consumer.feed(0, b"c")
            msgs = src.poll(10, 0.1)
            assert [m.payload for m in msgs] == [b"a", b"c", b"b"]
            assert [m.offset for m in msgs] == [0, 1, 2]  # one monotonic sequence
            assert msgs[0].meta[1] == 0 and msgs[1].meta[1] == 1

    def test_commit_watermark_maps_to_per_partition_offsets(self):
        with fb.installed():
            src = KafkaSource("b:9092")
            consumer = fb.FakeKafkaConsumer.instances[-1]
            for p, v in [(0, b"a"), (0, b"b"), (1, b"c"), (1, b"d")]:
                consumer.feed(p, v)
            assert len(src.poll(10, 0.1)) == 4
            src.commit(1)  # only partition 0 is fully stored
            (committed,) = consumer.commit_calls
            assert {tp.partition: om.offset for tp, om in committed.items()} == {0: 2}
            src.commit(1)  # idempotent
            assert len(consumer.commit_calls) == 1
            src.commit(3)
            tps = {tp.partition: om.offset for tp, om in consumer.commit_calls[-1].items()}
            assert tps == {1: 2}

    def test_end_to_end_store_then_commit(self):
        storage = InMemoryStorage()
        with fb.installed():
            tc = kafka_collector("b:9092", _collector(storage, transport="kafka"))
            consumer = fb.FakeKafkaConsumer.instances[-1]
            for _ in range(3):
                consumer.feed(0, PAYLOAD)
            consumer.feed(1, PAYLOAD)
            tc.drain(2.0)
            assert storage.span_count == 4 * len(TRACE)
            committed = {tp.partition: om.offset for tp, om in consumer.committed.items()}
            assert committed == {0: 3, 1: 1}
            tc.close()
            assert consumer.closed

    def test_backpressure_holds_commit_until_retry_stores(self):
        """A throttle shed reaches the transport, which retries the message
        before polling again: the first commit covers exactly seq 0."""
        from zipkin_tpu_torch.storage.throttle import RejectedExecutionError
        from zipkin_tpu_torch.utils.call import Call

        class SheddingStorage(InMemoryStorage):
            def __init__(self):
                super().__init__()
                self.shed_next = 1

            def accept(self, spans):
                call = super().accept(spans)
                if self.shed_next:
                    self.shed_next -= 1

                    def boom():
                        raise RejectedExecutionError("shed")

                    return Call.of(boom)
                return call

        storage = SheddingStorage()
        with fb.installed():
            tc = kafka_collector("b:9092", _collector(storage, transport="kafka"))
            consumer = fb.FakeKafkaConsumer.instances[-1]
            for _ in range(3):
                consumer.feed(0, PAYLOAD)
            tc.drain(3.0)
            assert storage.span_count == 3 * len(TRACE)  # retried through
            committed = {tp.partition: om.offset for tp, om in consumer.committed.items()}
            assert committed == {0: 3}
            first = {tp.partition: om.offset for tp, om in consumer.commit_calls[0].items()}
            assert first == {0: 1}
            tc.close()

    def test_missing_client_raises_clearly(self):
        with pytest.raises(RuntimeError, match="kafka-python is not installed"):
            KafkaSource("b:9092")


class TestRabbitMQSource:
    def test_poll_uses_delivery_tags_and_cumulative_ack(self):
        with fb.installed():
            src = RabbitMQSource("amqp://guest@localhost", queue="zipkin")
            conn = fb.FakeBlockingConnection.instances[-1]
            ch = conn.channel()
            for b in (b"a", b"b", b"c"):
                ch.feed(b)
            msgs = src.poll(10, 0.1)
            assert [m.payload for m in msgs] == [b"a", b"b", b"c"]
            assert [m.offset for m in msgs] == [1, 2, 3]  # rabbit tags from 1
            src.commit(2)
            assert ch.acks == [(2, True)]
            src.commit(3)
            assert ch.acks[-1] == (3, True)
            src.close()
            assert conn.closed

    def test_commit_guards_tag_zero_and_reack(self):
        with fb.installed():
            src = RabbitMQSource("amqp://guest@localhost", queue="zipkin")
            ch = fb.FakeBlockingConnection.instances[-1].channel()
            for b in (b"a", b"b"):
                ch.feed(b)
            src.poll(10, 0.1)
            src.commit(0)  # tag 0 would ack every outstanding delivery
            assert ch.acks == []
            src.commit(1)
            src.commit(1)  # a repeated watermark: no re-ack
            assert ch.acks == [(1, True)]
            src.commit(2)
            assert ch.acks == [(1, True), (2, True)]

    def test_end_to_end_with_transport_collector(self):
        storage = InMemoryStorage()
        with fb.installed():
            src = RabbitMQSource("amqp://guest@localhost")
            ch = fb.FakeBlockingConnection.instances[-1].channel()
            for _ in range(4):
                ch.feed(PAYLOAD)
            tc = TransportCollector(src, _collector(storage, transport="rabbitmq"),
                                    transport="rabbitmq")
            tc.drain(2.0)
            assert storage.span_count == 4 * len(TRACE)
            assert ch.acks[-1] == (4, True)
            tc.close()


class TestActiveMQSource:
    def test_connect_subscribe_client_individual(self):
        with fb.installed():
            src = ActiveMQSource("amq.example", port=61613, queue="zipkin")
            conn = fb.FakeStompConnection.instances[-1]
            assert conn.connected
            assert conn.subscriptions == [("/queue/zipkin", 1, "client-individual")]
            src.close()
            assert not conn.connected

    def test_commit_acks_each_frame_at_or_below_offset_once(self):
        with fb.installed():
            src = ActiveMQSource("amq.example")
            conn = fb.FakeStompConnection.instances[-1]
            ids = [conn.deliver("x"), conn.deliver("y"), conn.deliver("z")]
            msgs = src.poll(10, 0.1)
            assert [m.offset for m in msgs] == [0, 1, 2]
            src.commit(1)
            assert conn.acked == ids[:2]  # client-individual: one ack a frame
            src.commit(2)
            assert conn.acked == ids
            src.commit(2)
            assert conn.acked == ids  # idempotent

    def test_end_to_end_with_transport_collector(self):
        storage = InMemoryStorage()
        with fb.installed():
            src = ActiveMQSource("amq.example")
            conn = fb.FakeStompConnection.instances[-1]
            for _ in range(3):
                conn.deliver(PAYLOAD.decode())
            tc = TransportCollector(src, _collector(storage, transport="activemq"),
                                    transport="activemq")
            tc.drain(2.0)
            assert storage.span_count == 3 * len(TRACE)
            assert len(conn.acked) == 3
            tc.close()


class TestWorkerThreadsWithFakes:
    def test_kafka_under_worker_threads(self):
        storage = InMemoryStorage()
        with fb.installed():
            tc = kafka_collector("b:9092", _collector(storage, transport="kafka"), streams=2)
            consumer = fb.FakeKafkaConsumer.instances[-1]
            for i in range(10):
                consumer.feed(i % 3, PAYLOAD)
            tc.start()
            want = 10 * len(TRACE)
            _wait(lambda: storage.span_count >= want)
            tc.close()
            assert storage.span_count == want
            committed = {tp.partition: om.offset for tp, om in consumer.committed.items()}
            assert committed == {0: 4, 1: 3, 2: 3}


# -- across the two packages --------------------------------------------------


def _payloads(n_spans=3000, per=500, seed=17):
    spans = lots_of_spans(n_spans, seed=seed, services=6, span_names=8)
    return [(ref_proto3 if i % 2 else ref_json).encode_span_list(spans[lo:lo + per])
            for i, lo in enumerate(range(0, n_spans, per))], spans


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_replay_log_and_marker_read_across_packages(tmp_path, writer):
    """A log and marker that one package writes, the other reads and resumes
    from; both packages write the same bytes."""
    payloads, _ = _payloads(600, per=100)
    wa, ra = ((ref_transports, port_transports) if writer == "reference"
              else (port_transports, ref_transports))
    path = str(tmp_path / "spans.replay")
    wa.append_replay(path, payloads)
    twin = str(tmp_path / "twin.replay")
    ra.append_replay(twin, payloads)
    with open(path, "rb") as f, open(twin, "rb") as g:
        assert f.read() == g.read()  # the log format byte for byte
    first = wa.ReplayFileSource(path)
    got = first.poll(3, 0.0)
    assert [m.offset for m in got] == [0, 1, 2] and [m.payload for m in got] == payloads[:3]
    first.commit(2)
    first.close()
    with open(path + ".offset") as f:
        assert f.read() == "2"
    second = ra.ReplayFileSource(path, resume=True)
    assert second.committed == 2
    rest = second.poll(100, 0.0)
    assert [m.offset for m in rest] == [3, 4, 5] and [m.payload for m in rest] == payloads[3:]
    second.commit(5)
    second.close()
    third = wa.ReplayFileSource(path, resume=True)
    assert third.committed == 5 and third.poll(10, 0.0) == []
    third.close()


@pytest.mark.parametrize("fast", [False, True], ids=["object", "line_rate"])
def test_transport_collector_fills_the_same_device_state(tmp_path, fast):
    """The same seeded payloads from the same replay log through the
    reference's TransportCollector into ``TpuStorage(mesh=make_mesh(1))``
    and the port's into ``TorchStorage(device="cpu")``: equal leaves,
    counters, links and commit markers."""
    if fast and not (native.available() and ref_native.available()):
        pytest.skip("no C compiler for the native parser")
    payloads, spans = _payloads()
    path = str(tmp_path / "spans.replay")
    append_replay(path, payloads)
    ref = ref_store(archive_max_span_count=100_000)
    port = small_store(archive_max_span_count=100_000)
    for store in (ref, port):
        store._deps_max_stale_ms = 0.0
    ref_src = ref_transports.ReplayFileSource(path, resume=False)
    ref_src.offset_path = str(tmp_path / "ref.offset")
    port_src = ReplayFileSource(path, resume=False)
    port_src.offset_path = str(tmp_path / "port.offset")
    ref_tc = ref_transports.TransportCollector(ref_src, RefCollector(ref, fast_ingest=fast))
    port_tc = TransportCollector(port_src, Collector(port, fast_ingest=fast))
    ref_tc.drain(60.0)
    port_tc.drain(60.0)
    ref_tc.close()
    port_tc.close()
    assert ref_src.committed == port_src.committed == len(payloads) - 1
    assert port.agg.host_counters == ref.agg.host_counters
    assert port.agg.host_counters["spans"] == len(spans)
    for name, g, w in zip(AggState._fields, port.agg.state_arrays(), ref.agg.state_arrays()):
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, name
        if name in ("digest", "tb_digest"):
            np.testing.assert_array_equal(g[..., 1], w[..., 1], err_msg=name)
            np.testing.assert_allclose(g[..., 0], w[..., 0], rtol=1e-5, err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
    end_ts = max(s.timestamp for s in spans) // 1000 + 60_000
    want = links(ref.get_dependencies(end_ts, WEEK_MS).execute())
    assert want and links(port.get_dependencies(end_ts, WEEK_MS).execute()) == want

"""Broker transports: the poll -> decode -> sample -> store loops (the
port's copy of ``zipkin_tpu/collector/transports.py:1-508``).

Reference semantics: ``zipkin-collector/{kafka,rabbitmq,activemq}``: N
workers poll a source and hand raw bytes to
``Collector.accept_spans_bytes`` (format detection, sampling, storage),
committing offsets only after the accept, so delivery is at-least-once
(duplicates possible).

The transport seam is a small :class:`MessageSource` protocol:

- :class:`QueueSource`: an in-process queue (the unit tests' broker).
- :class:`ReplayFileSource`: a length-prefixed message log with a durable
  ``.offset`` marker, the replay feed and the crash-resume story (the
  Kafka-offset analog). Its log and marker are the reference's byte for
  byte: a log either package writes is read by the other, and either
  resumes from the other's marker.
- :class:`KafkaSource`, :class:`RabbitMQSource` and
  :class:`ActiveMQSource`: real brokers through kafka-python, pika and
  stomp.py, imported when a source is built; without the client the
  constructor raises the reference's message.

:class:`TransportCollector` keeps the reference's commit discipline:
several workers commit only below the least offset still outstanding, a
poison pill (a payload the collector refuses) advances the watermark, and
a storage failure is retried before the next poll. Unlike the reference's,
a worker about to poll waits while another waits to commit, so an idle
source's poller cannot starve a committer of the lock. Every message lands on
the collector's path: the line-rate path with ``fast_ingest`` (the card's
ingest step), else the object path. The server starts no broker
transport (the reference has no ``KAFKA_*`` autoconfig): these are
library entry points.
"""

from __future__ import annotations

import logging
import os
import queue as pyqueue
import struct
import threading
import time
from typing import List, Optional, Sequence

from zipkin_tpu_torch.collector.core import Collector, CollectorComponent
from zipkin_tpu_torch.utils.component import CheckResult

logger = logging.getLogger(__name__)

# -- the transport seam ---------------------------------------------------


class Message:
    """One opaque payload plus its resume offset (and optional transport
    metadata, e.g. a STOMP ack id)."""

    __slots__ = ("payload", "offset", "meta")

    def __init__(self, payload: bytes, offset: int, meta=None) -> None:
        self.payload = payload
        self.offset = offset
        self.meta = meta


class MessageSource:
    """Minimal consumer contract: poll / commit / close."""

    def poll(self, max_messages: int, timeout: float) -> List[Message]:
        raise NotImplementedError

    def commit(self, offset: int) -> None:
        """Mark everything up to ``offset`` (inclusive) as consumed."""

    def check(self) -> CheckResult:
        return CheckResult.OK

    def close(self) -> None: ...


class QueueSource(MessageSource):
    """In-process broker stand-in (bounded, drop-oldest-never: put blocks)."""

    def __init__(self, maxsize: int = 10_000) -> None:
        self._q: "pyqueue.Queue[bytes]" = pyqueue.Queue(maxsize)
        self._seq = 0
        self.committed = -1

    def send(self, payload: bytes) -> None:
        self._q.put(payload)

    def poll(self, max_messages: int, timeout: float) -> List[Message]:
        out: List[Message] = []
        deadline = time.monotonic() + timeout
        while len(out) < max_messages:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                payload = self._q.get(timeout=remaining)
            except pyqueue.Empty:
                break
            out.append(Message(payload, self._seq))
            self._seq += 1
        return out

    def commit(self, offset: int) -> None:
        self.committed = max(self.committed, offset)


class ReplayFileSource(MessageSource):
    """Length-prefixed message log (``u32 big-endian length + payload``)*
    with a sidecar ``.offset`` marker for resume.

    Writer half (:func:`append_replay`) + reader half in one class: the
    file format doubles as the pre-tokenized ingest corpus for replay
    benchmarks and as a write-ahead log for crash recovery (SURVEY.md §5
    failure-detection row).
    """

    def __init__(self, path: str, *, resume: bool = True) -> None:
        self.path = path
        self.offset_path = path + ".offset"
        self._file = open(path, "rb")
        self._index = 0
        self.committed = -1
        if resume and os.path.exists(self.offset_path):
            with open(self.offset_path) as f:
                committed = int(f.read().strip() or -1)
            self.committed = committed
            # skip already-consumed messages
            while self._index <= committed:
                if self._read_one() is None:
                    break

    def _read_one(self) -> Optional[bytes]:
        header = self._file.read(4)
        if len(header) < 4:
            return None
        (length,) = struct.unpack(">I", header)
        payload = self._file.read(length)
        if len(payload) < length:
            return None
        self._index += 1
        return payload

    def poll(self, max_messages: int, timeout: float) -> List[Message]:
        out: List[Message] = []
        for _ in range(max_messages):
            payload = self._read_one()
            if payload is None:
                break
            out.append(Message(payload, self._index - 1))
        return out

    def commit(self, offset: int) -> None:
        if offset <= self.committed:
            return
        self.committed = offset
        tmp = self.offset_path + ".tmp"
        with open(tmp, "w") as f:
            f.write(str(offset))
        os.replace(tmp, self.offset_path)

    def check(self) -> CheckResult:
        return (
            CheckResult.OK
            if not self._file.closed
            else CheckResult.failed(RuntimeError("replay file closed"))
        )

    def close(self) -> None:
        self._file.close()


def append_replay(path: str, payloads: Sequence[bytes]) -> None:
    """Append messages to a replay log (writer half of ReplayFileSource)."""
    with open(path, "ab") as f:
        for p in payloads:
            f.write(struct.pack(">I", len(p)))
            f.write(p)


class KafkaSource(MessageSource):
    """Kafka consumer over kafka-python, if installed.

    Mirrors ``KafkaCollectorWorker``'s poll loop. Kafka offsets are per
    partition, but the collector's watermark is a single cumulative
    sequence — so this source numbers polled records with its own
    monotonic sequence and, on ``commit(watermark)``, commits per
    partition the highest record offset at or below the watermark
    (+1 = Kafka's next-to-consume convention). At-least-once: nothing
    commits until the collector marks the message stored.
    """

    def __init__(
        self,
        bootstrap_servers: str,
        topic: str = "zipkin",
        group_id: str = "zipkin",
    ) -> None:
        try:
            from kafka import KafkaConsumer, OffsetAndMetadata  # type: ignore
        except ImportError as e:  # pragma: no cover - not in this image
            raise RuntimeError(
                "kafka-python is not installed; use ReplayFileSource or "
                "QueueSource, or install kafka-python"
            ) from e
        # kafka-python >= 2.1 added a required leader_epoch field to the
        # OffsetAndMetadata namedtuple; construct compatibly with both.
        def _om(offset):
            try:
                return OffsetAndMetadata(offset, None, -1)
            except TypeError:
                return OffsetAndMetadata(offset, None)

        self._offset_meta = _om
        self._consumer = KafkaConsumer(
            topic,
            bootstrap_servers=bootstrap_servers.split(","),
            group_id=group_id,
            enable_auto_commit=False,
        )
        self._seq = 0
        self._pending: dict = {}  # seq -> (TopicPartition, kafka offset)

    def poll(self, max_messages, timeout):
        records = self._consumer.poll(
            timeout_ms=int(timeout * 1000), max_records=max_messages
        )
        out = []
        for tp, batch in records.items():
            for r in batch:
                self._pending[self._seq] = (tp, r.offset)
                out.append(Message(r.value, self._seq, meta=(tp, r.offset)))
                self._seq += 1
        return out

    def commit(self, offset) -> None:
        ready = [s for s in self._pending if s <= offset]
        if not ready:
            return
        per_tp: dict = {}
        for s in ready:
            tp, koff = self._pending[s]
            per_tp[tp] = max(per_tp.get(tp, -1), koff)
        # commit BEFORE dropping from _pending: a failed commit (routine on
        # rebalance) must leave the offsets re-committable by a later
        # watermark, not silently forgotten.
        self._consumer.commit(
            {tp: self._offset_meta(koff + 1) for tp, koff in per_tp.items()}
        )
        for s in ready:
            del self._pending[s]

    def close(self) -> None:
        self._consumer.close()


class RabbitMQSource(MessageSource):
    """RabbitMQ basic-consume on queue ``zipkin`` via pika, if installed.

    Mirrors ``RabbitMQCollector.java``: basic_get polling with explicit
    acks after storage accept (at-least-once).
    """

    def __init__(self, uri: str, queue: str = "zipkin") -> None:
        try:
            import pika  # type: ignore
        except ImportError as e:  # pragma: no cover - not in this image
            raise RuntimeError(
                "pika is not installed; use ReplayFileSource or QueueSource, "
                "or install pika"
            ) from e
        self._connection = pika.BlockingConnection(  # pragma: no cover
            pika.URLParameters(uri)
        )
        self._channel = self._connection.channel()  # pragma: no cover
        self._queue = queue
        self._committed = 0  # highest delivery tag already acked

    def poll(self, max_messages, timeout):
        out = []
        for _ in range(max_messages):
            method, _props, body = self._channel.basic_get(self._queue)
            if method is None:
                break
            out.append(Message(body, method.delivery_tag))
        return out

    def commit(self, offset) -> None:
        # Delivery tags are 1-based and multiple-acks are cumulative, so:
        # tag 0 must never reach basic_ack (AMQP reads it as "ack ALL
        # outstanding", which would ack unstored deliveries), and a
        # repeated watermark must not re-ack an already-acked tag (the
        # broker closes the channel with PRECONDITION_FAILED).
        if offset <= self._committed or offset < 1:
            return
        self._channel.basic_ack(offset, multiple=True)
        self._committed = offset

    def close(self) -> None:  # pragma: no cover
        self._connection.close()


class ActiveMQSource(MessageSource):
    """ActiveMQ queue consume via stomp.py, if installed.

    Mirrors ``ActiveMQCollector.java`` (JMS consume -> accept); STOMP is
    the broker protocol available to Python.
    """

    def __init__(self, host: str, port: int = 61613, queue: str = "zipkin") -> None:
        try:
            import stomp  # type: ignore
        except ImportError as e:  # pragma: no cover - not in this image
            raise RuntimeError(
                "stomp.py is not installed; use ReplayFileSource or "
                "QueueSource, or install stomp.py"
            ) from e
        self._buffer = pyqueue.Queue()  # pragma: no cover
        self._conn = stomp.Connection([(host, port)])  # pragma: no cover

        outer = self

        class _Listener(stomp.ConnectionListener):  # pragma: no cover
            def on_message(self, frame):
                outer._buffer.put((frame.body.encode(), frame.headers))

        self._conn.set_listener("zipkin", _Listener())  # pragma: no cover
        self._conn.connect(wait=True)  # pragma: no cover
        self._conn.subscribe(f"/queue/{queue}", id=1, ack="client-individual")  # pragma: no cover
        self._seq = 0
        self._unacked: dict = {}  # offset -> stomp ack id

    def poll(self, max_messages, timeout):  # pragma: no cover
        out = []
        deadline = time.monotonic() + timeout
        while len(out) < max_messages:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                body, headers = self._buffer.get(timeout=remaining)
            except pyqueue.Empty:
                break
            ack_id = headers.get("ack") or headers.get("message-id")
            self._unacked[self._seq] = ack_id
            out.append(Message(body, self._seq, meta=ack_id))
            self._seq += 1
        return out

    def commit(self, offset) -> None:  # pragma: no cover
        # client-individual ack mode: ack every delivered frame <= offset
        for off in sorted(k for k in self._unacked if k <= offset):
            self._conn.ack(self._unacked.pop(off))

    def close(self) -> None:  # pragma: no cover
        self._conn.disconnect()


# -- the collector component ---------------------------------------------


class TransportCollector(CollectorComponent):
    """N worker threads draining a MessageSource into the Collector.

    The generalization of ``KafkaCollector``/``RabbitMQCollector``/
    ``ActiveMQCollector``: the broker specifics live in the source; the
    decode→sample→store→commit discipline lives here, once.
    """

    def __init__(
        self,
        source: MessageSource,
        collector: Collector,
        *,
        transport: str = "replay",
        workers: int = 1,
        poll_batch: int = 64,
        poll_timeout: float = 0.2,
    ) -> None:
        self.source = source
        self.collector = collector  # owns ALL metric counting
        self.transport = transport
        self._workers = workers
        self._poll_batch = poll_batch
        self._poll_timeout = poll_timeout
        self._threads: List[threading.Thread] = []
        self._running = threading.Event()
        # guards poll/commit + watermark bookkeeping (single-poller
        # sources); decode+store run OUTSIDE it so workers > 1 actually
        # parallelize (reference: N KafkaCollectorWorker streams). Each
        # worker keeps its own retry list of polled-but-unstored messages
        # (transient storage failure), so a rejection loses nothing
        # in-process; crash durability remains the committed offset.
        self._lock = threading.Lock()
        # Sources commit CUMULATIVELY (replay marker, kafka group offset,
        # rabbit multiple-ack), so with several workers a fast worker must
        # not commit past a slower worker's still-unstored offsets:
        # track outstanding offsets and only commit below their minimum.
        self._outstanding: set = set()
        self._stored_high = -1
        # workers waiting to commit: a poller lets them take the lock first.
        # threading.Lock is not fair, and a poller that re-polls an idle
        # source at once can hold it against a committer for as long as the
        # source stays idle (the reference's workers starve so)
        self._committers = 0
        self._committers_lock = threading.Lock()

    def start(self) -> "TransportCollector":
        self._running.set()
        for i in range(self._workers):
            t = threading.Thread(
                target=self._run, name=f"{self.transport}-collector-{i}", daemon=True
            )
            t.start()
            self._threads.append(t)
        return self

    def _poll(self, timeout: float) -> List[Message]:
        while self._committers:
            time.sleep(0.0005)
        with self._lock:
            messages = self.source.poll(self._poll_batch, timeout)
            self._outstanding.update(m.offset for m in messages)
            return messages

    def _mark_stored(self, offset: int) -> None:
        """Record one stored message and commit the safe watermark: the
        highest stored offset with nothing unstored at or below it."""
        with self._committers_lock:
            self._committers += 1
        with self._lock:
            with self._committers_lock:
                self._committers -= 1
            self._outstanding.discard(offset)
            self._stored_high = max(self._stored_high, offset)
            floor = min(self._outstanding) - 1 if self._outstanding else self._stored_high
            watermark = min(self._stored_high, floor)
            if watermark >= 0:
                try:
                    self.source.commit(watermark)  # after accept: at-least-once
                except Exception:
                    # A failed commit (broker rebalance, transient I/O) must
                    # not kill the worker: the spans ARE stored, and the
                    # next stored message retries with >= this watermark.
                    # Worst case is redelivery — the at-least-once contract.
                    logger.warning(
                        "%s commit(%d) failed; will retry on next store",
                        self.transport, watermark, exc_info=True,
                    )

    def _process(self, messages: List[Message]) -> List[Message]:
        """Store a batch; returns the unstored tail on storage failure
        (empty when the batch finished)."""
        for i, m in enumerate(messages):
            try:
                self.collector.accept_spans_bytes(m.payload)
            except ValueError:
                # poison pill: counted dropped by the collector; it is
                # terminally consumed, so it still advances the watermark
                pass
            except Exception:
                return messages[i:]  # retried before the next poll
            self._mark_stored(m.offset)
        return []

    def _run(self) -> None:
        retry: List[Message] = []
        while self._running.is_set():
            if retry:
                messages, retry = retry, []
            else:
                messages = self._poll(self._poll_timeout)
            if messages:
                retry = self._process(messages)
                if retry:
                    time.sleep(self._poll_timeout)  # back off before retry

    def drain(self, deadline: float = 5.0) -> None:
        """Test helper: poll inline until the source stops yielding."""
        end = time.monotonic() + deadline
        idle = 0
        retry: List[Message] = []
        while time.monotonic() < end and idle < 3:
            if retry:
                messages, retry = retry, []
            else:
                messages = self._poll(0.05)
            if messages:
                idle = 0
                retry = self._process(messages)
            else:
                idle += 1

    def check(self) -> CheckResult:
        return self.source.check()

    def close(self) -> None:
        self._running.clear()
        for t in self._threads:
            t.join(timeout=2.0)
        self.source.close()


def kafka_collector(
    bootstrap_servers: str,
    collector: Collector,
    *,
    topic: str = "zipkin",
    group_id: str = "zipkin",
    streams: int = 1,
) -> TransportCollector:
    """KAFKA_BOOTSTRAP_SERVERS autoconfig entry point (KafkaCollector)."""
    return TransportCollector(
        KafkaSource(bootstrap_servers, topic, group_id),
        collector,
        transport="kafka",
        workers=streams,
    )

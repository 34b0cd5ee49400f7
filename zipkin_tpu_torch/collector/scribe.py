"""Scribe collector: the legacy thrift transport (the port's copy of
``zipkin_tpu/collector/scribe.py:1-181``).

Reference semantics: ``zipkin-collector/scribe`` (``ScribeCollector.java``,
``ScribeSpanConsumer.java``): a thrift RPC service
``scribe.Log(List<LogEntry>)`` where each entry of category ``zipkin``
carries one base64-encoded thrift v1 span in its ``message``. The reply is
``ResultCode.OK`` (0) once the batch is handed to the collector,
``TRY_LATER`` (1) on a storage rejection.

An asyncio TCP server speaking TBinaryProtocol over TFramedTransport (a
4-byte length prefix, frames up to 64 MiB), with the port's own thrift
reader (:mod:`zipkin_tpu_torch.model.thrift`) and v1 conversion
(:func:`zipkin_tpu_torch.model.json_v1.convert_v1_spans`); no thrift
runtime. ``start`` and ``stop`` are coroutines: the port's server runs
them on its transport loop's thread. Unlike the reference's, ``stop``
closes the connections that wait between frames (a connection mid-frame
answers it first), so a client that keeps its connection open cannot hold
a server's shutdown. A frame's spans go through
``Collector.accept`` (the object path, and on a device store its ingest
step) off the loop, on a worker thread.
"""

from __future__ import annotations

import asyncio
import base64
import logging
import struct
from typing import List, Optional, Tuple

from zipkin_tpu_torch.collector.core import Collector
from zipkin_tpu_torch.model.span import Span
from zipkin_tpu_torch.model.json_v1 import convert_v1_spans
from zipkin_tpu_torch.model.thrift import _Reader, _read_v1_span  # codec internals
from zipkin_tpu_torch.utils.component import CheckResult, Component

logger = logging.getLogger(__name__)

_T_STRUCT = 12
_T_STRING = 11
_T_LIST = 15
_T_I32 = 8
_T_STOP = 0

_CALL = 1
_REPLY = 2
_EXCEPTION = 3
_VERSION_1 = 0x80010000

OK, TRY_LATER = 0, 1


def _parse_log_call(frame: bytes) -> Tuple[int, List[Tuple[str, bytes]]]:
    """Parse a thrift binary ``Log`` call; returns (seqid, [(category,
    message)]). Raises ValueError on anything malformed."""
    r = _Reader(frame)
    first = r.i32()
    if first & 0xFFFF0000 == _VERSION_1 & 0xFFFF0000:
        mtype = first & 0xFF
        name = r.binary().decode("utf-8", "replace")
        seqid = r.i32()
    else:  # old-style unversioned: name length first
        r = _Reader(frame)
        name = r.binary().decode("utf-8", "replace")
        mtype = r.u8()
        seqid = r.i32()
    if mtype != _CALL or name != "Log":
        raise ValueError(f"unsupported scribe call {name!r} type {mtype}")

    entries: List[Tuple[str, bytes]] = []
    while True:
        ftype = r.u8()
        if ftype == _T_STOP:
            break
        fid = r.i16()
        if fid == 1 and ftype == _T_LIST:
            etype = r.u8()
            count = r.i32()
            if etype != _T_STRUCT:
                raise ValueError("messages field must be list<LogEntry>")
            for _ in range(count):
                category, message = "", b""
                while True:
                    et = r.u8()
                    if et == _T_STOP:
                        break
                    eid = r.i16()
                    if eid == 1 and et == _T_STRING:
                        category = r.binary().decode("utf-8", "replace")
                    elif eid == 2 and et == _T_STRING:
                        message = r.binary()
                    else:
                        r.skip(et)
                entries.append((category, message))
        else:
            r.skip(ftype)
    return seqid, entries


def _reply(seqid: int, code: int) -> bytes:
    """Encode ``Log_result{0: ResultCode}`` as a versioned REPLY frame."""
    name = b"Log"
    body = struct.pack(">I", (_VERSION_1 | _REPLY) & 0xFFFFFFFF)
    body += struct.pack(">i", len(name)) + name
    body += struct.pack(">i", seqid)
    body += bytes([_T_I32]) + struct.pack(">hi", 0, code) + bytes([_T_STOP])
    return struct.pack(">I", len(body)) + body


def decode_scribe_message(message: bytes) -> List[Span]:
    """One LogEntry message -> spans: base64 (MIME or raw) thrift v1 span."""
    raw = base64.b64decode(message, validate=False)
    r = _Reader(raw)
    return convert_v1_spans([_read_v1_span(r)])


class ScribeCollector(Component):
    """Lifecycle wrapper over the asyncio scribe server (port 9410)."""

    def __init__(
        self, collector: Collector, host: str = "0.0.0.0", port: int = 9410,
        category: str = "zipkin",
    ) -> None:
        self.collector = collector
        self.host = host
        self.port = port
        self.category = category
        self._server: Optional[asyncio.AbstractServer] = None
        # connections waiting for their next frame: stop() closes them
        # (a server's wait_closed() waits for every connection to end)
        self._idle: set = set()
        self._stopping = False

    async def start(self) -> "ScribeCollector":
        self._server = await asyncio.start_server(
            self._serve_connection, self.host, self.port
        )
        self.port = self._server.sockets[0].getsockname()[1]
        logger.info("scribe collector listening on %s", self.port)
        return self

    async def _serve_connection(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        try:
            while not self._stopping:
                self._idle.add(writer)
                try:
                    header = await reader.readexactly(4)
                finally:
                    self._idle.discard(writer)
                (length,) = struct.unpack(">I", header)
                if length > 64 * 1024 * 1024:
                    raise ValueError("scribe frame too large")
                frame = await reader.readexactly(length)
                writer.write(await self._handle_frame(frame))
                await writer.drain()
        except (asyncio.IncompleteReadError, ConnectionResetError):
            pass  # client hung up
        except Exception:
            logger.exception("scribe connection error")
        finally:
            writer.close()

    async def _handle_frame(self, frame: bytes) -> bytes:
        seqid, entries = _parse_log_call(frame)
        spans: List[Span] = []
        metrics = self.collector.metrics
        for category, message in entries:
            metrics.increment_messages()
            metrics.increment_bytes(len(message))
            if category.lower() != self.category:
                continue
            try:
                spans.extend(decode_scribe_message(message))
            except Exception:
                metrics.increment_messages_dropped()
        try:
            if spans:
                await asyncio.to_thread(self.collector.accept, spans)
        except Exception:
            return _reply(seqid, TRY_LATER)  # storage rejection: retryable
        return _reply(seqid, OK)

    async def stop(self) -> None:
        """Stop accepting, close the connections that wait between frames,
        and wait for those mid-frame to answer theirs."""
        if self._server is not None:
            self._stopping = True
            self._server.close()
            for writer in list(self._idle):
                writer.close()
            await self._server.wait_closed()
            self._server = None

    def check(self) -> CheckResult:
        if self._server is not None and self._server.is_serving():
            return CheckResult.OK
        return CheckResult.failed(RuntimeError("scribe server not running"))

    def close(self) -> None:
        pass  # async stop() is the real teardown

"""The embedded mock server behind :class:`ZipkinMock` (the port's copy of
``zipkin_tpu/testkit/mock.py:1-145``).

It runs the production :class:`~zipkin_tpu_torch.server.app.ZipkinServer`
over :class:`~zipkin_tpu_torch.storage.memory.InMemoryStorage`, so the
mock cannot drift from the real collector. Failure injection is the
server's ``post_hook``, which a POST consults before it reads its body (in
place of the reference's aiohttp middleware): it counts the POSTs to a
``.../spans`` route and answers the next enqueued :class:`HttpFailure`
instead of the server, as ``ZipkinRule`` enqueues failures ahead of
MockWebServer's responses.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import deque
from typing import Deque, List, Optional, Sequence

from zipkin_tpu_torch.model.span import Span
from zipkin_tpu_torch.server.app import ZipkinServer
from zipkin_tpu_torch.server.config import ServerConfig
from zipkin_tpu_torch.storage.memory import InMemoryStorage


@dataclasses.dataclass(frozen=True)
class HttpFailure:
    """One enqueued ingest failure (consumed in FIFO order)."""

    status: int = 500
    body: str = "injected failure"
    disconnect: bool = False

    @staticmethod
    def send_error_response(status: int, body: str = "") -> "HttpFailure":
        return HttpFailure(status=status, body=body)

    @staticmethod
    def disconnect_during_body() -> "HttpFailure":
        return HttpFailure(disconnect=True)


class ZipkinMock:
    """Embedded mock zipkin; start()/close() or use as a context manager."""

    def __init__(self, port: int = 0) -> None:
        self.storage = InMemoryStorage()
        self._config = ServerConfig(host="127.0.0.1", port=port, storage_type="mem")
        self._failures: Deque[HttpFailure] = deque()
        self._request_count = 0
        self._lock = threading.Lock()
        self._server: Optional[ZipkinServer] = None
        self.port: Optional[int] = None

    # -- lifecycle -------------------------------------------------------

    def start(self) -> "ZipkinMock":
        server = ZipkinServer(self._config, storage=self.storage)
        server.post_hook = self._failure_hook
        self._server = server.start()
        self.port = server.port
        return self

    def _failure_hook(self, handler, path: str) -> bool:
        """Count a POST to a spans route; answer the next enqueued failure
        in the server's place (True), else let the server answer it."""
        if not path.endswith("/spans"):
            return False
        with self._lock:
            self._request_count += 1
            failure = self._failures.popleft() if self._failures else None
        if failure is None:
            return False
        if failure.disconnect:
            # read part of the body, then close without an answer
            length = int(handler.headers.get("Content-Length") or 0)
            handler.rfile.read(length // 2)
            handler.close_connection = True
            return True
        handler._send(failure.status, failure.body.encode())
        return True

    def close(self) -> None:
        if self._server is not None:
            self._server.stop()
            self._server = None

    def __enter__(self) -> "ZipkinMock":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # -- assertions ------------------------------------------------------

    @property
    def http_url(self) -> str:
        return f"http://127.0.0.1:{self.port}/api/v2/spans"

    @property
    def base_url(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    @property
    def http_request_count(self) -> int:
        return self._request_count

    @property
    def trace_count(self) -> int:
        return len(self.storage.get_all_traces())

    def traces(self) -> List[List[Span]]:
        return self.storage.get_all_traces()

    def store_spans(self, spans: Sequence[Span]) -> None:
        """Seed spans directly (ZipkinRule#storeSpans)."""
        self.storage.accept(list(spans)).execute()

    def enqueue_failure(self, failure: HttpFailure) -> None:
        with self._lock:
            self._failures.append(failure)

    def collector_metrics(self):
        assert self._server is not None
        return self._server.metrics

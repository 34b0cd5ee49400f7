"""The evals' wire drivers: HTTP and gRPC clients on threads and on an event
loop, the port's answer to the reference's aiohttp client and ``grpc.aio`` channels
(``benchmarks/server_bench.py:55-150`` ``_drive``, and the
``asyncio.gather`` floods of ``evals/run_configs.py`` configs 8 and 9).

- :func:`drive` posts ``total`` spans with two requests in flight, as
  ``_drive`` does: proto3 over HTTP on two keep-alive ``http.client``
  connections, or ``SpanService/Report`` over one ``grpc`` channel. A 429
  or ``RESOURCE_EXHAUSTED`` is the fan-out tier's backpressure: it is
  retried after 5 ms and counted. Any other answer is counted in
  ``stats["responses"]`` and its payload is not retried (``_drive`` raises
  there; the caller's gate reads the tally instead).
- :func:`request` and :func:`post` make one request on a connection of
  its own and return its status, headers, body and wall.
- :func:`flood` sends requests all at once from one thread, on an event
  loop, each on a kept-alive connection that has answered a
  ``GET /health`` before the first request is sent.
- :class:`GrpcCollector` runs a
  :class:`~zipkin_tpu_torch.server.grpc.GrpcCollectorServer` over a given
  collector on an event loop of its own thread; :func:`report` makes one
  ``Report`` call and returns its status code and trailing metadata.

``grpc`` is imported only by the gRPC paths. This is a helper of the
evals, not a port of ``benchmarks/``.
"""

from __future__ import annotations

import asyncio
import http.client
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, NamedTuple, Optional, Sequence
from urllib.parse import urlsplit

BACKOFF_S = 0.005  # the client's pause before it retries a backpressured payload
IN_FLIGHT = 2
HOST = "127.0.0.1"  # every server the evals drive is local


def _tally(stats: dict, lock: threading.Lock, key: str) -> None:
    with lock:
        stats["responses"][key] = stats["responses"].get(key, 0) + 1


def drive(port: int, fmt: str, payloads: Sequence[bytes], batch: int, total: int,
          stats: Optional[dict] = None) -> float:
    """Send ``total`` spans, ``batch`` a payload (``payloads`` in turn),
    ``IN_FLIGHT`` at a time, to the server's HTTP port (``fmt`` ``proto3``)
    or its gRPC port (``fmt`` ``grpc``); returns the seconds
    until the last answer. ``stats["backpressure"]`` counts the pushbacks,
    ``stats["responses"]`` every answer by status (``"202"``, ``"429"``,
    ``"OK"``, ``"RESOURCE_EXHAUSTED"``, ...)."""
    if fmt not in ("proto3", "grpc"):
        raise ValueError(f"unknown wire format {fmt!r}")
    if stats is None:
        stats = {}
    stats.setdefault("backpressure", 0)
    stats.setdefault("responses", {})
    lock = threading.Lock()
    claimed = [0, 0]  # spans claimed, payloads claimed

    def claim() -> Optional[bytes]:
        with lock:
            if claimed[0] >= total:
                return None
            claimed[0] += batch
            claimed[1] += 1
            return payloads[(claimed[1] - 1) % len(payloads)]

    def backpressure() -> None:
        with lock:
            stats["backpressure"] += 1
        time.sleep(BACKOFF_S)

    if fmt == "grpc":
        import grpc

        from zipkin_tpu_torch.server.grpc import METHOD

        channel = grpc.insecure_channel(f"{HOST}:{port}",
                                        options=[("grpc.max_send_message_length", 64 << 20)])
        method = channel.unary_unary(METHOD)

        def sender() -> None:
            while (data := claim()) is not None:
                while True:
                    try:
                        method(data)
                        _tally(stats, lock, "OK")
                        break
                    except grpc.RpcError as e:
                        _tally(stats, lock, e.code().name)
                        if e.code() is not grpc.StatusCode.RESOURCE_EXHAUSTED:
                            break
                        backpressure()
    else:
        channel = None

        def sender() -> None:
            conn = http.client.HTTPConnection(HOST, port, timeout=300)
            try:
                while (data := claim()) is not None:
                    while True:
                        conn.request("POST", "/api/v2/spans", body=data,
                                     headers={"Content-Type": "application/x-protobuf"})
                        resp = conn.getresponse()
                        resp.read()
                        _tally(stats, lock, str(resp.status))
                        if resp.status != 429:
                            break
                        backpressure()
            finally:
                conn.close()

    t0 = time.perf_counter()
    try:
        with ThreadPoolExecutor(IN_FLIGHT) as pool:
            for f in [pool.submit(sender) for _ in range(IN_FLIGHT)]:
                f.result()
    finally:
        if channel is not None:
            channel.close()
    return time.perf_counter() - t0


class Answer(NamedTuple):
    status: int
    headers: Dict[str, str]
    body: bytes
    ms: float  # the request's wall, connect to last byte


def request(method: str, url: str, body: Optional[bytes] = None,
            headers: Optional[Dict[str, str]] = None) -> Answer:
    """One request on a connection of its own (``url`` is
    ``http://host:port/path``); an error status is an answer too."""
    parts = urlsplit(url)
    t0 = time.perf_counter()
    conn = http.client.HTTPConnection(parts.hostname, parts.port, timeout=300)
    try:
        conn.request(method, parts.path + (f"?{parts.query}" if parts.query else ""), body=body,
                     headers=headers or {})
        resp = conn.getresponse()
        data = resp.read()
        return Answer(resp.status, dict(resp.getheaders()), data,
                      (time.perf_counter() - t0) * 1000.0)
    finally:
        conn.close()


def post(url: str, body: bytes, headers: Optional[Dict[str, str]] = None) -> Answer:
    """One JSON POST (``headers`` added to its ``Content-Type``)."""
    return request("POST", url, body, {"Content-Type": "application/json", **(headers or {})})


async def _exchange(conn, method: str, url: str, body: Optional[bytes],
                    headers: Optional[Dict[str, str]], close: bool) -> Answer:
    """One HTTP/1.1 request on the open connection ``conn`` (a reader and a
    writer of the running event loop); its wall runs from the request's
    first byte to the answer's last (the server sends a
    ``Content-Length``)."""
    reader, writer = conn
    parts = urlsplit(url)
    body = body or b""
    head = [f"{method} {parts.path}{'?' + parts.query if parts.query else ''} HTTP/1.1",
            f"Host: {parts.netloc}", f"Content-Length: {len(body)}"]
    head += ["Connection: close"] if close else []
    head += [f"{k}: {v}" for k, v in (headers or {}).items()]
    t0 = time.perf_counter()
    writer.write(("\r\n".join(head) + "\r\n\r\n").encode("latin-1") + body)
    status = int((await reader.readline()).split()[1])
    got: Dict[str, str] = {}
    while (line := await reader.readline()) not in (b"\r\n", b"\n", b""):
        k, _, v = line.decode("latin-1").partition(":")
        got[k.strip()] = v.strip()
    data = await reader.readexactly(int(got.get("Content-Length", 0)))
    return Answer(status, got, data, (time.perf_counter() - t0) * 1000.0)


async def _pooled(url: str):
    """A connection to ``url``'s server that has answered a ``GET
    /health``, kept alive: the server's thread for it is serving."""
    parts = urlsplit(url)
    conn = await asyncio.open_connection(parts.hostname, parts.port)
    ans = await _exchange(conn, "GET", f"{parts.scheme}://{parts.netloc}/health", None, None,
                          close=False)
    if ans.status != 200:
        raise RuntimeError(f"warm-up GET /health answered {ans.status}")
    return conn


def flood(requests: Sequence[tuple]) -> List[Answer]:
    """Send every ``(method, url, body, headers)`` request at once from one
    thread (an event loop's ``gather``, as the reference's aiohttp client
    floods), each on a pooled connection of its own (:func:`_pooled`,
    all opened before the first request is sent): their answers in order,
    each connection closed after its answer."""
    async def run() -> List[Answer]:
        conns = await asyncio.gather(*(_pooled(r[1]) for r in requests))
        try:
            return list(await asyncio.gather(*(
                _exchange(c, *r, close=True) for c, r in zip(conns, requests))))
        finally:
            for _, writer in conns:
                writer.close()

    return asyncio.run(run())


class GrpcCollector:
    """A ``SpanService/Report`` server over ``collector`` on an ephemeral
    port of :data:`HOST`, on an event loop of its own thread; a context
    manager (``port`` is bound on entry)."""

    def __init__(self, collector) -> None:
        self._collector = collector
        self.port: Optional[int] = None

    def __enter__(self) -> "GrpcCollector":
        from zipkin_tpu_torch.server.grpc import GrpcCollectorServer

        self._loop = asyncio.new_event_loop()
        self._thread = threading.Thread(target=self._loop.run_forever, name="eval-grpc",
                                        daemon=True)
        self._thread.start()
        self._server = GrpcCollectorServer(self._collector, host=HOST, port=0)
        try:
            asyncio.run_coroutine_threadsafe(self._server.start(), self._loop).result(60)
        except BaseException:
            self._stop_loop()
            raise
        self.port = self._server.port
        return self

    def __exit__(self, *exc) -> None:
        try:
            asyncio.run_coroutine_threadsafe(self._server.stop(), self._loop).result(60)
        finally:
            self._stop_loop()

    def _stop_loop(self) -> None:
        self._loop.call_soon_threadsafe(self._loop.stop)
        self._thread.join(timeout=60)
        self._loop.close()


def report(port: int, payload: bytes, metadata=()):
    """One ``Report`` over a fresh channel: (status code name, trailing
    metadata as a dict); ``("OK", {})`` when it was accepted."""
    import grpc

    from zipkin_tpu_torch.server.grpc import METHOD

    with grpc.insecure_channel(f"{HOST}:{port}",
                               options=[("grpc.max_send_message_length", 64 << 20)]) as ch:
        try:
            ch.unary_unary(METHOD)(payload, metadata=tuple(metadata), timeout=60)
            return "OK", {}
        except grpc.RpcError as e:
            return e.code().name, {k: v for k, v in (e.trailing_metadata() or ())}

"""gRPC span collector: ``zipkin.proto3.SpanService/Report`` (the port's
copy of ``zipkin_tpu/server/grpc.py:1-201``).

Reference semantics: ``ZipkinGrpcCollector.java``, enabled by
``COLLECTOR_GRPC_ENABLED``. Like the reference, it uses the package's own
proto3 codec and registers a generic method handler, so there is no
generated stub to drift from the wire format. The request body is a
``ListOfSpans`` (the bytes the HTTP collector takes as
``application/x-protobuf``); the response is an empty ``ReportResponse``.

Every Report records the ``grpc_boundary`` stage (request bytes to the
collector hand-off) and stamps the critical path's wire anchor. B3 ids on
the invocation metadata (``x-b3-traceid``/``x-b3-spanid``) are published
to ``obs.selfspans.CURRENT_B3`` for the call (``x-b3-sampled: 0``
suppresses it), and ``x-tenant-id`` to ``CURRENT_TENANT`` before the
collector's admission chokepoint. A spent deadline answers
``DEADLINE_EXCEEDED`` before dispatch; a malformed body
``INVALID_ARGUMENT``; backpressure (a throttle or admission shed, a full
fan-out tier) ``RESOURCE_EXHAUSTED`` with ``retry-delay`` trailers.

This module imports ``grpc`` at its top: the server imports it only when
``grpc_collector_enabled`` is set, and a server asked for gRPC on a machine
without the ``grpc`` package refuses to start. The server runs
:class:`GrpcCollectorServer` on its transport loop's thread.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Optional

import grpc
import grpc.aio

from zipkin_tpu_torch import obs
from zipkin_tpu_torch.collector.core import Collector
from zipkin_tpu_torch.model.codec import Encoding
from zipkin_tpu_torch.obs import critpath
from zipkin_tpu_torch.obs.selfspans import CURRENT_B3
from zipkin_tpu_torch.runtime.tenant import (
    CURRENT_TENANT,
    TENANT_METADATA_KEY,
    normalize_tenant,
)

logger = logging.getLogger(__name__)

SERVICE = "zipkin.proto3.SpanService"
METHOD = f"/{SERVICE}/Report"


def _stamped_request(data: bytes):
    """Request deserializer that timestamps message receipt.

    grpc's C core assembles the request message (socket reads, HTTP/2
    reassembly, the ~5 MB body of a 64k-span ListOfSpans) BEFORE the
    Python handler runs, so a ``t0`` taken inside ``report()`` misses
    the read entirely. The
    deserializer is the earliest Python hook after assembly: stamping
    here makes the stage span request read + decode like the HTTP
    site's (whose t0 precedes ``request.read()``)."""
    return time.perf_counter_ns(), data


class _SpanServiceHandler(grpc.GenericRpcHandler):
    def __init__(self, collector: Collector, deadlines: bool = True) -> None:
        self._collector = collector
        self._deadlines = deadlines

    def _retry_trailers(self, exc=None):
        """Backoff guidance for a RESOURCE_EXHAUSTED shed:
        the backoff delay as ``retry-delay`` trailing metadata (seconds,
        decimal) — the gRPC twin of the HTTP site's Retry-After header.
        When the shed carries a scope (tenant-budget vs global-ladder)
        the trailers also say WHICH control rejected the
        payload (``shed-scope``/``shed-tenant``) and the delay comes
        from that tenant's own deficit, not the global ladder."""
        ctl = getattr(self._collector, "overload", None)
        if ctl is None:
            return None
        delay_s = getattr(exc, "retry_after_s", None)
        scope = getattr(exc, "scope", None)
        tenant = getattr(exc, "tenant", None)
        if delay_s is None:
            delay_s = ctl.retry_after_s(tenant if scope == "tenant" else None)
        trailers = [
            ("retry-delay", f"{delay_s:.3f}s"),
            ("retry-delay-ms", str(int(delay_s * 1000.0))),
        ]
        if scope:
            trailers.append(("shed-scope", str(scope)))
        if tenant:
            trailers.append(("shed-tenant", str(tenant)))
        return tuple(trailers)

    def service(self, handler_call_details):
        if handler_call_details.method != METHOD:
            return None

        # zt-ingest-boundary: gRPC Report is a wire entrypoint — tenant
        # identity is extracted from invocation metadata here, before the
        # collector chokepoint runs admission
        async def report(request, context) -> bytes:
            t0_ns, data = request
            critpath.WIRE_T0_NS.set(t0_ns)
            # deadline propagation: the client's gRPC
            # deadline may already be spent (the message sat in HTTP/2
            # reassembly or the accept queue) — drop before the
            # collector dispatches work nobody awaits
            if self._deadlines:
                remaining = context.time_remaining()
                if remaining is not None and remaining <= 0:
                    ctl = getattr(self._collector, "overload", None)
                    if ctl is not None:
                        ctl.note_deadline_expired()
                    await context.abort(
                        grpc.StatusCode.DEADLINE_EXCEEDED,
                        "deadline expired before dispatch",
                    )
            md = dict(context.invocation_metadata() or ())
            tid, sid = md.get("x-b3-traceid"), md.get("x-b3-spanid")
            sampled = str(md.get("x-b3-sampled", "")).lower()
            token = None
            if tid and sid and sampled not in ("0", "false"):
                token = CURRENT_B3.set((tid, sid))
            # tenant admission identity: lowercase metadata
            # form of the HTTP X-Tenant-Id header; absent/hostile values
            # normalize to the default tenant, so legacy clients keep
            # flowing. contextvars survive asyncio.to_thread.
            ten_tok = CURRENT_TENANT.set(
                normalize_tenant(md.get(TENANT_METADATA_KEY))
            )
            try:
                # off the event loop: decode + device ingest block, and the
                # loop is shared with the scribe server
                await asyncio.to_thread(
                    self._collector.accept_spans_bytes, data, Encoding.PROTO3
                )
            except ValueError as e:
                await context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
            except Exception as e:
                # storage rejection -> retryable; IngestBackpressure (a
                # tenant-budget shed, the fan-out tier's bounded queues
                # full, or the global brownout ladder) lands here too,
                # the gRPC twin of the HTTP site's 429 — trailing
                # metadata carries backoff guidance scoped to whichever
                # control rejected the payload
                trailers = self._retry_trailers(e)
                if trailers is not None:
                    context.set_trailing_metadata(trailers)
                await context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED, str(e))
            finally:
                CURRENT_TENANT.reset(ten_tok)
                if token is not None:
                    CURRENT_B3.reset(token)
            obs.record(
                "grpc_boundary", (time.perf_counter_ns() - t0_ns) / 1e9
            )
            return b""  # empty ReportResponse

        return grpc.unary_unary_rpc_method_handler(
            report,
            request_deserializer=_stamped_request,  # (t_recv_ns, bytes)
            response_serializer=None,
        )


class GrpcCollectorServer:
    """Lifecycle wrapper: bind, serve, drain."""

    def __init__(self, collector: Collector, host: str = "0.0.0.0",
                 port: int = 9412, deadlines: bool = True):
        self._collector = collector
        self._address = f"{host}:{port}"
        self._server: Optional[grpc.aio.Server] = None
        self.port = port
        self._deadlines = deadlines

    async def start(self) -> "GrpcCollectorServer":
        # span batches are big by design (a 64k-span ListOfSpans is
        # ~5 MB); grpc's 4 MB default would RESOURCE_EXHAUSTED them
        server = grpc.aio.server(options=[
            ("grpc.max_receive_message_length", 64 << 20),
            ("grpc.max_send_message_length", 64 << 20),
        ])
        server.add_generic_rpc_handlers(
            (_SpanServiceHandler(self._collector, self._deadlines),)
        )
        self.port = server.add_insecure_port(self._address)
        await server.start()
        self._server = server
        logger.info("grpc collector listening on %s", self.port)
        return self

    async def stop(self) -> None:
        if self._server is not None:
            await self._server.stop(grace=1.0)
            self._server = None

"""Test kit: an embedded mock Zipkin for instrumentation tests (the port's
copy of ``zipkin_tpu/testkit/__init__.py``).

Reference semantics: ``zipkin-junit``'s ``ZipkinRule`` and
``zipkin-junit5``'s ``ZipkinExtension``: a real HTTP endpoint that records
what clients POST, can inject failures (``HttpFailure.sendErrorResponse``
and ``disconnectDuringBody``), and exposes the stored traces and the
collector's metrics for assertions.

Usage (the port's ``http.server`` server on its own thread, over the
in-memory store: a test double needs no card):

    with ZipkinMock() as zipkin:
        my_tracer.configure(endpoint=zipkin.http_url)
        ... exercise instrumented code ...
        assert zipkin.trace_count == 1
"""

from zipkin_tpu_torch.testkit.mock import HttpFailure, ZipkinMock

__all__ = ["HttpFailure", "ZipkinMock"]

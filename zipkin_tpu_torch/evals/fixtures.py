"""The spans the evals are built from: the canonical 3-service ``TRACE``
(the exact object of BASELINE config[0]), the fixed ``TODAY`` its
timestamps hang from, and the ``lots_of_spans`` generator (port of the
parts of ``tests/fixtures.py`` that ``evals/run_configs.py`` takes, on the
port's own model; the same seed gives the same spans); and the span
generators of configs 5, 7, 8 and 9, which the reference writes inside
each config's body (``fanout_payloads``, ``drift_spans``,
``flood_spans``)."""

from __future__ import annotations

import random
from typing import List, Sequence

from zipkin_tpu_torch.model import proto3
from zipkin_tpu_torch.model.span import Endpoint, Kind, Span

# Midnight UTC 2026-07-29, in epoch milliseconds — a fixed "today" so runs
# are deterministic. Span timestamps are microseconds (ms * 1000).
TODAY = 1_785_283_200_000
TODAY_US = TODAY * 1000

FRONTEND = Endpoint.create("frontend", "127.0.0.1")
BACKEND = Endpoint.create("backend", "192.168.99.101", 9000)
DB = Endpoint.create("mysql", "2001:db8::c001", 3306)

TRACE_ID = "0000000000000001" + "0000000000000ace"  # 128-bit

# The canonical 3-service trace: an uninstrumented client hits frontend,
# frontend calls backend (client+shared-server pair), backend queries mysql
# (uninstrumented remote, with an error).
TRACE: List[Span] = [
    Span.create(
        trace_id=TRACE_ID,
        id="0000000000000001",
        name="get /",
        kind=Kind.SERVER,
        local_endpoint=FRONTEND,
        timestamp=TODAY_US,
        duration=350_000,
    ),
    Span.create(
        trace_id=TRACE_ID,
        id="0000000000000002",
        parent_id="0000000000000001",
        name="get /api",
        kind=Kind.CLIENT,
        local_endpoint=FRONTEND,
        timestamp=TODAY_US + 50_000,
        duration=250_000,
        annotations=[(TODAY_US + 51_000, "ws")],
    ),
    Span.create(
        trace_id=TRACE_ID,
        id="0000000000000002",
        parent_id="0000000000000001",
        name="get /api",
        kind=Kind.SERVER,
        shared=True,
        local_endpoint=BACKEND,
        timestamp=TODAY_US + 60_000,
        duration=150_000,
    ),
    Span.create(
        trace_id=TRACE_ID,
        id="0000000000000003",
        parent_id="0000000000000002",
        name="query",
        kind=Kind.CLIENT,
        local_endpoint=BACKEND,
        remote_endpoint=DB,
        timestamp=TODAY_US + 70_000,
        duration=80_000,
        tags={"error": "Deadlock found when trying to get lock"},
    ),
]


def lots_of_spans(
    n: int = 10_000,
    *,
    seed: int = 0,
    services: int = 10,
    span_names: int = 30,
) -> List[Span]:
    """Synthetic span soup: client/server pairs across a service mesh, with
    realistic skew (zipf-ish durations, ~2% errors)."""
    rng = random.Random(seed)
    svc = [Endpoint.create(f"svc{i:02d}", f"10.0.0.{i + 1}") for i in range(services)]
    names = [f"op{i:02d}" for i in range(span_names)]
    spans: List[Span] = []
    trace_seq = 0
    while len(spans) < n:
        trace_seq += 1
        trace_id = f"{rng.getrandbits(63) | 1:016x}"
        depth = rng.randint(1, 4)
        parent_id = None
        ts = TODAY_US + trace_seq * 1000
        caller = rng.randrange(services)
        for level in range(depth):
            span_id = f"{(trace_seq << 8 | level) + 1:016x}"
            callee = rng.randrange(services)
            dur = int(rng.paretovariate(1.2) * 1000) + 50
            err = {"error": "boom"} if rng.random() < 0.02 else {}
            spans.append(
                Span.create(
                    trace_id=trace_id,
                    id=span_id,
                    parent_id=parent_id,
                    name=names[rng.randrange(span_names)],
                    kind=Kind.CLIENT,
                    local_endpoint=svc[caller],
                    remote_endpoint=svc[callee],
                    timestamp=ts,
                    duration=dur,
                    tags=err,
                )
            )
            parent_id = span_id
            caller = callee
            ts += rng.randint(10, 500)
    return spans[:n]


def fanout_payloads(batch: int) -> List[bytes]:
    """config5's two proto3 payloads of ``batch`` spans each, cut from one
    ``lots_of_spans(2 * batch, seed=7, services=40, span_names=120)``."""
    spans = lots_of_spans(2 * batch, seed=7, services=40, span_names=120)
    return [proto3.encode_span_list(spans[i : i + batch]) for i in range(0, len(spans), batch)]


DRIFT_ENDPOINT = Endpoint.create("checkout", "10.0.0.7")


def drift_spans(durations: Sequence[float], seq0: int, ts_us: int) -> List[Span]:
    """config7's spans: one ``checkout``/``charge`` SERVER span a duration,
    the ``k``-th with trace and span id ``seq0 + k + 1`` and timestamp
    ``ts_us + seq0 + k + 1``."""
    out = []
    for k, d in enumerate(durations):
        seq = seq0 + k + 1
        out.append(Span.create(
            trace_id=f"{seq:016x}", id=f"{seq:016x}", name="charge", kind=Kind.SERVER,
            local_endpoint=DRIFT_ENDPOINT, timestamp=ts_us + seq, duration=int(d)))
    return out


def flood_spans(i: int, n: int, base: int) -> List[Span]:
    """Payload ``i`` of configs 8 (``base`` 0xE800_0000) and 9
    (0xE900_0000): ``n`` spans of trace ``base + i`` on ``svc{i % 8}``."""
    ep = Endpoint.create(service_name=f"svc{i % 8}", ip="10.0.0.1")
    return [
        Span.create(
            trace_id=f"{base + i:016x}", id=f"{(i << 16) + j + 1:016x}", name=f"op{j % 8}",
            timestamp=1_753_000_000_000_000 + i * 1000 + j, duration=500 + j, local_endpoint=ep)
        for j in range(n)
    ]

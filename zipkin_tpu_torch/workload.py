"""Seeded synthetic span traffic with its ground truth (numpy only).

Traces are chains of RPC hops; each hop is a CLIENT span in the caller's
service and a SERVER span sharing its span id in the callee's service
(the shared-id RPC pair), so every hop yields exactly one dependency
edge caller -> callee under the DependencyLinker rules, with an error
when the hop fails. Services and span names are drawn with Zipf-like
skew, durations are lognormal, and timestamps advance over
``minutes`` epoch minutes as the stream goes on.

:func:`generate` returns the columns plus what a checker needs: the
distinct traces per service, the edges with their call and error counts
and the durations per sketch key. :func:`render_spans` and
:func:`payloads` give the same traffic as the port's Span objects and as
JSON v2 and proto3 ingest payloads, for the store's object path.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

from zipkin_tpu_torch.model import json_v2, proto3
from zipkin_tpu_torch.model.span import Endpoint, Kind, Span
from zipkin_tpu_torch.tpu.columnar import SpanColumns, empty_columns

BASE_MINUTE = 29_000_000  # an epoch minute in 2025


@dataclass
class Traffic:
    cols: SpanColumns  # all spans, in delivery order
    edges: Dict[Tuple[int, int], Tuple[int, int]]  # (caller, callee) -> (calls, errors)
    names_per_service: int = 10  # key = svc * names_per_service + name


def _zipf_weights(n: int, s: float) -> np.ndarray:
    w = 1.0 / np.arange(1, n + 1) ** s
    return w / w.sum()


def generate(n_spans: int, seed: int, services: int = 200, names_per_service: int = 10,
             hops: int = 4, minutes: int = 30, error_rate: float = 0.01,
             base_minute: int = BASE_MINUTE) -> Traffic:
    """``n_spans`` spans (a multiple of ``2 * hops``) of ``hops``-hop traces
    over service ids 1..services and sketch keys svc * names + name."""
    rng = np.random.default_rng(seed)
    per_trace = 2 * hops
    if n_spans % per_trace:
        raise ValueError(f"n_spans must be a multiple of {per_trace}")
    t = n_spans // per_trace
    svc_p = _zipf_weights(services, 0.9)
    name_p = _zipf_weights(names_per_service, 1.2)

    # services along each trace's chain: hop h calls from chain[h] to chain[h+1]
    chain = rng.choice(services, size=(t, hops + 1), p=svc_p) + 1
    for h in range(1, hops + 1):  # no self-calls
        same = chain[:, h] == chain[:, h - 1]
        chain[same, h] = chain[same, h] % services + 1
    trace_h = rng.integers(0, 1 << 32, t, dtype=np.uint32)
    tl = rng.integers(0, 1 << 32, (t, 2), dtype=np.uint32)
    span_id = rng.integers(1, 1 << 32, (t, hops, 2), dtype=np.uint32)
    hop_err = rng.random((t, hops)) < error_rate
    minute = base_minute + (np.arange(t) * minutes) // max(t, 1)

    cols = empty_columns(n_spans)
    idx = np.arange(t) * per_trace
    for h in range(hops):
        for half in (0, 1):  # 0: client in the caller, 1: shared server in the callee
            lane = idx + 2 * h + half
            cols.trace_h[lane] = trace_h
            cols.tl0[lane], cols.tl1[lane] = tl[:, 0], tl[:, 1]
            cols.s0[lane], cols.s1[lane] = span_id[:, h, 0], span_id[:, h, 1]
            if h > 0:  # parent: the previous hop's (shared) span id
                cols.p0[lane], cols.p1[lane] = span_id[:, h - 1, 0], span_id[:, h - 1, 1]
            cols.shared[lane] = half == 1
            cols.kind[lane] = 2 if half else 1
            svc = chain[:, h + half]
            cols.svc[lane] = svc
            cols.rsvc[lane] = chain[:, h + 1] if half == 0 else 0
            name = rng.choice(names_per_service, size=t, p=name_p)
            cols.key[lane] = svc * names_per_service + name
            cols.err[lane] = hop_err[:, h]
            dur = rng.lognormal(np.log(4000.0), 1.0, t) * (1.2 if half == 0 else 1.0)
            cols.dur[lane] = np.minimum(dur, 0xFFFFFFFF).astype(np.uint32) + 1
            cols.has_dur[lane] = True
            cols.ts_min[lane] = minute
            cols.valid[lane] = True

    edges: Dict[Tuple[int, int], Tuple[int, int]] = {}
    pairs = np.stack([chain[:, :-1].ravel(), chain[:, 1:].ravel(), hop_err.ravel()], 1)
    uniq, inv = np.unique(pairs[:, :2], axis=0, return_inverse=True)
    calls = np.bincount(inv.ravel(), minlength=len(uniq))
    errs = np.bincount(inv.ravel(), weights=pairs[:, 2], minlength=len(uniq))
    for (a, b), c, e in zip(uniq, calls, errs):
        edges[(int(a), int(b))] = (int(c), int(e))
    return Traffic(cols=cols, edges=edges, names_per_service=names_per_service)


def service_name(svc: int) -> str:
    return f"svc{svc:04d}"


def span_name(traffic: Traffic, key: int) -> str:
    return f"op{key % traffic.names_per_service:02d}"


def render_spans(traffic: Traffic) -> List[Span]:
    """The valid lanes of ``traffic`` as Span objects, in lane order: the
    64-bit trace id ``tl1:tl0``, span and parent ids from their lanes,
    service ``svc`` as :func:`service_name`, the client half's remote
    service, key ``k``'s span name :func:`span_name`, an ``error`` tag on
    failed hops, and a timestamp inside the lane's epoch minute. Packing
    them gives the generator's columns except ``trace_h`` (hashed from the
    id) and the service and key ids (interned in first-seen order)."""
    c = traffic.cols
    lanes = np.nonzero(c.valid)[0]
    trace = (c.tl1[lanes].astype(np.uint64) << np.uint64(32)) | c.tl0[lanes]
    span = (c.s1[lanes].astype(np.uint64) << np.uint64(32)) | c.s0[lanes]
    parent = (c.p1[lanes].astype(np.uint64) << np.uint64(32)) | c.p0[lanes]
    ts = c.ts_min[lanes].astype(np.int64) * 60_000_000 + (lanes % 60_000) * 1000
    endpoints: Dict[int, Endpoint] = {}

    def endpoint(svc: int):
        if svc not in endpoints:
            endpoints[svc] = Endpoint.create(service_name(svc))
        return endpoints[svc]

    kinds = {1: Kind.CLIENT, 2: Kind.SERVER}
    out = []
    for j, i in enumerate(lanes.tolist()):
        out.append(Span.create(
            trace_id=f"{int(trace[j]):016x}",
            id=f"{int(span[j]):016x}",
            parent_id=f"{int(parent[j]):016x}" if parent[j] else None,
            kind=kinds[int(c.kind[i])],
            name=span_name(traffic, int(c.key[i])),
            timestamp=int(ts[j]),
            duration=int(c.dur[i]),
            local_endpoint=endpoint(int(c.svc[i])),
            remote_endpoint=endpoint(int(c.rsvc[i])) if c.rsvc[i] else None,
            tags={"error": "true"} if c.err[i] else {},
            shared=True if c.shared[i] else None,
        ))
    return out


def payloads(spans: Sequence[Span], per: int = 4096) -> List[bytes]:
    """``spans`` as ingest payloads of ``per`` spans each, JSON v2 and
    proto3 ``ListOfSpans`` by turns."""
    out = []
    for n, lo in enumerate(range(0, len(spans), per)):
        encode = proto3.encode_span_list if n % 2 else json_v2.encode_span_list
        out.append(encode(spans[lo : lo + per]))
    return out


def slice_columns(cols: SpanColumns, lo: int, hi: int, pad_to: int = 0) -> SpanColumns:
    """Lanes ``[lo, hi)`` as a batch, zero-padded (valid=0) to ``pad_to``."""
    n = max(hi - lo, pad_to)
    out = empty_columns(n)
    for dst, src in zip(out, cols):
        dst[: hi - lo] = src[lo:hi]
    return out

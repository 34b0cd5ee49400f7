"""The BASELINE.json eval configs 0-9 on the port, runnable end to end
(port of ``evals/run_configs.py``).

Each stage prints one JSON line with pass/fail and measurements, under the
reference's keys. Scales default to BASELINE's; env vars set them:

  config0 — server smoke: POST the canonical TRACE to the port's server
            (storage "mem", an ephemeral port), query it back over HTTP.
  config1 — EVAL_SPANS (default 1M) synthetic spans: device t-digest
            p50/p99 per (service, spanName) vs exact truth, in rank space.
  config2 — EVAL_LINK_SPANS (default 10M): device dependency links through
            the ring's rollups vs closed-form truth, with the host
            DependencyLinker on a 1-in-EVAL_LINK_ORACLE_SAMPLE (64) sample.
  config3 — EVAL_HLL (default 100M) distinct trace ids through the
            production ingest step into the HLL; estimates within
            3*stderr, globally and per service.
  config4 — EVAL_REPLAY_SPANS (default 2M) streaming replay through the
            line-rate path with the disk archive live, vocab churn and
            mixed Lens reads mid-stream and quiesced; each read program's
            device time from the device observatory, gated at 50 ms.
            EVAL_SMALL runs it at a small config (a CPU smoke of the
            harness). EVAL_REPLAY_DURABLE=<dir> runs it with the WAL and
            periodic snapshots live; EVAL_RESUME_DIR=<dir> makes it one
            window of a crash-resumable run that
            ``python -m zipkin_tpu_torch.evals.resume_driver`` relaunches.
  config5 — the fan-out tier's wire-to-ack gate: proto3 through the
            server's HTTP boundary with sampling and the WAL live, at least
            EVAL_FANOUT_TARGET (the reference's 1M spans/s) through
            min(4, cores) parse workers on a multi-core host, graceful
            degradation against the same-run in-process budget on one core.
  config6 — the SLO watchdog's trip and clear: an induced query_fresh burn
            through the production record site; the alert within one long
            window, on /prometheus, cleared after recovery.
  config7 — accuracy drift's trip and clear: an undersized digest (C=4) on
            a bimodal stream; the shadow's drift gauge crosses 0.20 and
            digest_p99_relerr trips, then clears after a reset.
  config8 — the overload flood gate: a flood of at least 3x the tier's
            queue capacity through HTTP with a WAL ENOSPC mid-flood; acked
            p99 within its SLO, every shed guided (Retry-After, gRPC
            retry-delay), no acked span lost at durable parity, the at-risk
            flag cleared by a snapshot, B0 back within one long window.
  config9 — tenant flood containment: tenant B floods 4x its budget
            (X-Tenant-Id) while A and C stay inside theirs; only B shed,
            tenant-scoped, the global ladder at B0, exact per-tenant
            attribution, no acked span lost across a mid-flood
            crash-resume, the {tenant=} Prometheus families.

Each config that steps the card captures its graphs before its timed
window (``capture_steps``) and reports the recompiles inside it. After the
stages, a line ``{"launches": {...}}`` gives each hand kernel's launches in
each config and in all. Where the reference's harness has a tool the port
lacks, the config's docstring says what stands in for it: the reference
drives its aiohttp app with aiohttp's test client and ``grpc.aio``; the
port's ``http.server`` runs on an ephemeral port, driven by the thread
clients of :mod:`zipkin_tpu_torch.evals.wire`.

Run: python -m zipkin_tpu_torch.evals.run_configs [--device cpu] [config0 ...]
It runs on the card; without one it refuses to start unless ``--device``
names another device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import random
import shutil
import sys
import tempfile
import time
from typing import Optional

import numpy as np
import torch

from zipkin_tpu_torch import faults, native, obs
from zipkin_tpu_torch.evals import wire
from zipkin_tpu_torch.evals.fixtures import (TODAY, TODAY_US, TRACE, drift_spans, fanout_payloads,
                                             flood_spans, lots_of_spans)
from zipkin_tpu_torch.internal.dependency_linker import DependencyLinker
from zipkin_tpu_torch.model import json_v2, proto3
from zipkin_tpu_torch.model.span import Endpoint, Kind, Span
from zipkin_tpu_torch.obs.device import OBSERVATORY
from zipkin_tpu_torch.ops import chase_kernel, hll, hll_kernel, ring_kernel
from zipkin_tpu_torch.parallel.aggregator import TorchAggregator
from zipkin_tpu_torch.runtime.supervisor import EX_RESTART, ResumeSupervisor
from zipkin_tpu_torch.runtime.tenant import TENANT_HEADER
from zipkin_tpu_torch.sampling import RATE_ONE
from zipkin_tpu_torch.server.app import ZipkinServer
from zipkin_tpu_torch.server.config import ServerConfig
from zipkin_tpu_torch.storage.spi import QueryRequest
from zipkin_tpu_torch.storage.tpu import TorchStorage as DurableStorage
from zipkin_tpu_torch.tpu.columnar import SpanColumns, Vocab, _hash2_np, _mix32
from zipkin_tpu_torch.tpu.state import AggConfig
from zipkin_tpu_torch.tpu.store import TorchStorage

# the reference's lane count a batch (every config below sizes its batches
# by it, down to a smaller config's lane cap)
BATCH = 65_536


def _emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def _recompiles() -> int:
    """Step-graph captures made after a boot capture, process-wide."""
    return OBSERVATORY.totals()["recompiles"]


def config0(device=None) -> bool:
    """The reference drives its aiohttp app with aiohttp's test client; the
    port's server is ``http.server`` on an ephemeral port, driven with
    :func:`wire.request`."""
    server = ZipkinServer(ServerConfig(host="127.0.0.1", port=0, storage_type="mem"),
                          seal_interval_s=0, device=device).start()
    base = f"http://127.0.0.1:{server.port}"
    try:
        ok = wire.post(base + "/api/v2/spans", json_v2.encode_span_list(TRACE)).status == 202
        ans = wire.request("GET", f"{base}/api/v2/trace/{TRACE[0].trace_id}")
        ok &= ans.status == 200 and len(json.loads(ans.body)) == len(TRACE)
        ans = wire.request(
            "GET", f"{base}/api/v2/dependencies?endTs={TODAY + 3_600_000}&lookback=86400000")
        links = ({(l["parent"], l["child"]) for l in json.loads(ans.body)} if ans.status == 200
                 else set())
        ok &= links == {("frontend", "backend"), ("backend", "mysql")}
    finally:
        server.stop()
    _emit(config="config0", passed=ok)
    return ok


def _dur_of(k: np.ndarray, j: np.ndarray) -> np.ndarray:
    """Deterministic per-key duration stream: occurrence j of key k gets
    a reproducible pseudo-random duration, so the EXACT per-key multiset
    can be regenerated vectorized at check time instead of being
    accumulated span by span during ingest. Long-tailed on purpose: 1-in-64
    durations land 100x out, so the p99 rank check exercises the digest's
    tail, not just its bulk."""
    h = _mix32((k.astype(np.uint32) << np.uint32(18)) ^ j.astype(np.uint32))
    base = (h % np.uint32(10_000)).astype(np.uint32) + 1
    tail = ((h >> np.uint32(16)) % np.uint32(64)) == 0
    return np.where(tail, base * np.uint32(100), base)


def config1(device=None, cfg: Optional[AggConfig] = None) -> bool:
    """Device t-digest accuracy vs EXACT closed-form truth, in rank space,
    at array speed (the corpus and the per-key truth are regenerated
    vectorized; pack-path correctness is the contract suites' job)."""
    total = int(os.environ.get("EVAL_SPANS", 1_000_000))
    n_keys = 200
    n_services = 10
    cfg = cfg or AggConfig()
    agg = TorchAggregator(cfg, device=device)
    batch = min(BATCH, agg.lane_cap)
    vocab = Vocab(cfg.max_services, cfg.max_keys)
    for s in range(n_services):
        vocab.services.intern(f"svc{s:02d}")
    # record the vocab's id per synthetic key: the interner pre-reserves
    # a per-service catch-all row before each service's first named pair,
    # so ids are NOT dense k+1
    kid_of = np.zeros(n_keys, np.int32)
    for k in range(n_keys):
        nid = vocab.span_names.intern(f"op{k:03d}")
        kid_of[k] = vocab.key_id((k % n_services) + 1, nid)
    if not ((kid_of > 0).all() and len(set(kid_of.tolist())) == n_keys):
        raise ValueError(f"{cfg} has no room for {n_keys} keys over {n_services} services")

    ts_min = np.uint32(29_000_000)
    agg.capture_steps([batch])
    recompiles0 = _recompiles()
    start = time.perf_counter()
    done = 0
    while done < total:
        n = min(batch, total - done)
        i = np.arange(done, done + batch, dtype=np.uint32)
        k = i % np.uint32(n_keys)
        dur = _dur_of(k, i // np.uint32(n_keys))
        valid = np.arange(batch) < n
        u0 = np.zeros(batch, np.uint32)
        cols = SpanColumns(
            trace_h=_hash2_np(i + np.uint32(1), u0), tl0=i + np.uint32(1),
            tl1=u0, s0=i + np.uint32(1), s1=u0, p0=u0, p1=u0,
            shared=np.zeros(batch, bool),
            kind=np.zeros(batch, np.int32),
            svc=(k.astype(np.int32) % n_services) + 1,
            rsvc=np.zeros(batch, np.int32),
            key=kid_of[k],
            err=np.zeros(batch, bool),
            dur=dur, has_dur=valid,
            ts_min=np.full(batch, ts_min, np.uint32),
            valid=valid,
        )
        agg.ingest(cols)
        done += n
    agg.block_until_ready()
    ingest_s = time.perf_counter() - start
    recompiles = _recompiles() - recompiles0

    # the quantiles are read on the aggregator's device by the production
    # digest program (spmd_quant_digest: flush, then read), one pull
    got, _ = agg.quantiles([0.5, 0.99], source="digest")

    worst = 0.0
    checked = failed = 0
    for k in range(n_keys):
        n_k = total // n_keys + (1 if k < total % n_keys else 0)
        if n_k < 300:
            continue
        # exact truth, regenerated vectorized
        d = np.sort(_dur_of(np.full(n_k, k, np.uint32), np.arange(n_k)).astype(np.float64))
        kid = int(kid_of[k])
        # t-digest's guarantee is in RANK space (quantile error ~ eps at
        # the tails), not value space — for long-tailed durations a tiny
        # rank error is a large value error, so score the empirical rank
        # of each estimate instead of comparing values.
        rank50 = np.searchsorted(d, float(got[kid, 0])) / n_k
        rank99 = np.searchsorted(d, float(got[kid, 1])) / n_k
        err = max(abs(rank50 - 0.5), abs(rank99 - 0.99))
        worst = max(worst, err)
        ok_key = abs(rank50 - 0.5) < 0.02 and abs(rank99 - 0.99) < 0.01
        checked += 1
        failed += 0 if ok_key else 1
    ok = checked > 0 and failed == 0 and recompiles == 0
    _emit(config="config1", passed=ok, spans=total, keys_checked=checked,
          keys_failed=failed, worst_rank_err=round(worst, 4),
          wall_spans_per_sec=round(total / ingest_s), recompiles_in_window=recompiles)
    return ok


def _link_corpus_batch(
    lo_pair: int, n_pairs: int, n_services: int, ts_min: int,
    pad_pairs: int = 0,
):
    """Columnar batch of ``n_pairs`` shared client/server RPC pairs with
    CLOSED-FORM link truth: pair i emits exactly one (svc_a(i) ->
    svc_b(i)) edge, error iff i % 8 == 0 (the server half carries the
    tag). Vectorized numpy construction — no Span objects — so the
    harness reaches BASELINE config2's 10M-span spec scale.
    """
    gen_pairs = max(pad_pairs, n_pairs)  # pad: a constant lane count keeps
    i = np.arange(lo_pair, lo_pair + gen_pairs, dtype=np.uint32)  # one step graph
    a = (i % np.uint32(n_services)).astype(np.int32) + 1
    b = ((i + 1 + i // np.uint32(n_services)) % np.uint32(n_services)).astype(
        np.int32
    ) + 1
    b = np.where(b == a, (b % n_services) + 1, b)
    err = (i % 8) == 0
    n = 2 * gen_pairs
    live = np.arange(gen_pairs) < n_pairs

    def interleave(client, server):
        out = np.empty(n, client.dtype)
        out[0::2] = client
        out[1::2] = server
        return out

    tl0 = i + np.uint32(1)
    tl1 = np.full(gen_pairs, 0x5EED, np.uint32)
    hi32 = _hash2_np(np.zeros(gen_pairs, np.uint32), np.zeros(gen_pairs, np.uint32))
    trace_h = _hash2_np(_hash2_np(tl0, tl1), hi32)

    def dup(x):
        return interleave(x, x)

    zeros = np.zeros(n, np.uint32)
    cols = SpanColumns(
        trace_h=dup(trace_h), tl0=dup(tl0), tl1=dup(tl1),
        s0=dup(i + np.uint32(9)), s1=dup(np.zeros(gen_pairs, np.uint32)),
        p0=zeros, p1=zeros,
        shared=interleave(
            np.zeros(gen_pairs, bool), np.ones(gen_pairs, bool)
        ),
        kind=interleave(
            np.full(gen_pairs, 1, np.int32), np.full(gen_pairs, 2, np.int32)
        ),
        svc=interleave(a, b),
        rsvc=np.zeros(n, np.int32),
        key=np.zeros(n, np.int32),
        err=interleave(np.zeros(gen_pairs, bool), err),
        dur=dup((i % 10_000 + 1).astype(np.uint32)),
        has_dur=np.ones(n, bool),
        ts_min=np.full(n, ts_min, np.uint32),
        valid=dup(live),
    )
    return cols, (a[:n_pairs], b[:n_pairs], err[:n_pairs])


def config2(device=None, cfg: Optional[AggConfig] = None) -> bool:
    """Device link aggregation at spec scale (10M spans) vs closed-form
    truth, with the host DependencyLinker cross-checking a 1-in-64 trace
    sample — the oracle stays in the loop at object speed while the volume
    runs at array speed, through the production ring-rollup retention
    machinery rather than an oversized ring."""
    total = int(os.environ.get("EVAL_LINK_SPANS", 10_000_000))
    oracle_every = int(os.environ.get("EVAL_LINK_ORACLE_SAMPLE", 64))
    n_services = 30
    cfg = cfg or AggConfig()
    agg = TorchAggregator(cfg, device=device)
    batch = min(BATCH, agg.lane_cap)
    ts_min = int(TODAY_US // 60_000_000)

    s1 = cfg.max_services
    calls_true = np.zeros((s1, s1), np.int64)
    errs_true = np.zeros((s1, s1), np.int64)
    linker = DependencyLinker()
    sample_calls = np.zeros((s1, s1), np.int64)
    sample_errs = np.zeros((s1, s1), np.int64)

    n_pairs_total = total // 2
    done = 0
    agg.capture_steps([batch])
    recompiles0 = _recompiles()
    # host seconds in the window: batch generation, ingest calls (which may
    # wait on the device), the closed-form truth and the oracle sample
    gen_s = ingest_call_s = truth_s = oracle_s = 0.0
    start = time.perf_counter()
    while done < n_pairs_total:
        n_pairs = min(batch // 2, n_pairs_total - done)
        t0 = time.perf_counter()
        cols, (a, b, err) = _link_corpus_batch(
            done, n_pairs, n_services, ts_min, pad_pairs=batch // 2
        )
        t1 = time.perf_counter()
        agg.ingest(cols)
        t2 = time.perf_counter()
        np.add.at(calls_true, (a, b), 1)
        np.add.at(errs_true, (a, b), err.astype(np.int64))
        t3 = time.perf_counter()
        # oracle sample: every Nth pair becomes real Span objects through
        # the reference-semantics host linker
        pick = np.arange(n_pairs) % oracle_every == 0
        for pa, pb, pe, pi in zip(
            a[pick], b[pick], err[pick], np.nonzero(pick)[0] + done
        ):
            tid = f"{int(pi) + 1:016x}"
            sid = f"{int(pi) + 9:016x}"
            trace = [
                Span.create(
                    trace_id=tid, id=sid, kind=Kind.CLIENT, name="op",
                    timestamp=TODAY_US, duration=10,
                    local_endpoint=Endpoint.create(f"svc{pa - 1:02d}", "10.0.0.1"),
                ),
                Span.create(
                    trace_id=tid, id=sid, kind=Kind.SERVER, shared=True,
                    name="op", timestamp=TODAY_US, duration=8,
                    local_endpoint=Endpoint.create(f"svc{pb - 1:02d}", "10.0.0.2"),
                    tags={"error": ""} if pe else {},
                ),
            ]
            linker.put_trace(trace)
            np.add.at(sample_calls, ([pa], [pb]), 1)
            np.add.at(sample_errs, ([pa], [pb]), int(pe))
        gen_s += t1 - t0
        ingest_call_s += t2 - t1
        truth_s += t3 - t2
        oracle_s += time.perf_counter() - t3
        done += n_pairs
    agg.block_until_ready()
    elapsed = time.perf_counter() - start
    recompiles = _recompiles() - recompiles0

    calls, errors = agg.dependency_matrices(0, 2**31)
    device_mism = int(
        (calls.astype(np.int64) != calls_true).sum()
        + (errors.astype(np.int64) != errs_true).sum()
    )
    # oracle cross-check: the host linker over the sampled traces must
    # reproduce the closed-form truth restricted to the sample
    oracle = {
        (l.parent, l.child): (l.call_count, l.error_count)
        for l in linker.link()
    }
    oracle_mism = 0
    for p, c in zip(*np.nonzero(sample_calls)):
        want = (int(sample_calls[p, c]), int(sample_errs[p, c]))
        got = oracle.get((f"svc{p - 1:02d}", f"svc{c - 1:02d}"))
        oracle_mism += got != want
    oracle_mism += sum(
        1
        for (pn, cn) in oracle
        if not (
            pn.startswith("svc")
            and sample_calls[int(pn[3:]) + 1, int(cn[3:]) + 1] > 0
        )
    )
    ok = device_mism == 0 and oracle_mism == 0 and recompiles == 0
    _emit(config="config2", passed=ok, spans=done * 2,
          edges=int((calls_true > 0).sum()), mismatches=device_mism,
          oracle_sampled_traces=linker_traces(linker),
          oracle_mismatches=oracle_mism,
          spans_per_sec=round(done * 2 / elapsed),
          host_generation_share=round(gen_s / elapsed, 4),
          host_ingest_call_share=round(ingest_call_s / elapsed, 4),
          host_truth_share=round(truth_s / elapsed, 4),
          host_oracle_share=round(oracle_s / elapsed, 4),
          recompiles_in_window=recompiles)
    return ok


def linker_traces(linker) -> int:
    return int(sum(l.call_count for l in linker.link()))


def _hll_corpus(batch: int, n_services: int):
    """config3's batch generator: ``cols_at(done)`` is the batch of
    ``batch`` spans whose 64-bit trace ids run from ``done + 1``, each a
    distinct trace, spread over ``n_services`` services and 200 keys."""
    u0 = np.zeros(batch, np.uint32)
    hi32 = _hash2_np(u0, u0)  # th lanes are zero: production trace_h rule
    valid = np.ones(batch, bool)
    zi32 = np.zeros(batch, np.int32)
    zb = np.zeros(batch, bool)
    lane = np.arange(batch, dtype=np.uint64)

    def cols_at(done: int) -> SpanColumns:
        i64 = np.uint64(done + 1) + lane  # distinct 64-bit trace ids
        tl0 = (i64 & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        tl1 = (i64 >> np.uint64(32)).astype(np.uint32)
        svc = (i64 % np.uint64(n_services)).astype(np.int32) + 1
        return SpanColumns(
            trace_h=_hash2_np(_hash2_np(tl0, tl1), hi32),
            tl0=tl0, tl1=tl1, s0=tl0, s1=u0, p0=u0, p1=u0,
            shared=zb, kind=zi32, svc=svc, rsvc=zi32,
            key=(i64 % np.uint64(200)).astype(np.int32) + 1,
            err=zb, dur=(tl0 % np.uint32(10_000)) + np.uint32(1),
            has_dur=valid, ts_min=np.full(batch, 29_000_000, np.uint32),
            valid=valid,
        )

    return cols_at


def config3(device=None, cfg: Optional[AggConfig] = None) -> bool:
    """HLL cardinality at 100M distinct trace ids THROUGH THE PRODUCTION
    INGEST PATH: spans with distinct ids stream through
    ``TorchAggregator.ingest`` — the same captured step production traffic
    replays, with the HLL update inside it and the estimate read through the
    production register-max merge — not a bare ``hll_kernel.update`` loop on
    standalone registers. The rate reported is therefore FULL ingest-step
    throughput (digests, links, histograms all live), not an HLL-only
    number; both the global row and the per-service rows gate. The batches
    are made on the host (u64 arithmetic), and the run reports the host's
    share of the window beside the rate."""
    total = int(os.environ.get("EVAL_HLL", 100_000_000))
    n_services = 32
    cfg = cfg or AggConfig()
    agg = TorchAggregator(cfg, device=device)
    batch = min(BATCH, agg.lane_cap)
    cols_at = _hll_corpus(batch, n_services)

    agg.capture_steps([batch])
    agg.ingest(cols_at(0))  # warm: first uses outside the timed window
    agg.block_until_ready()
    done = batch
    recompiles0 = _recompiles()
    gen_s = ingest_call_s = 0.0
    start = time.perf_counter()
    while done < total:
        t0 = time.perf_counter()
        cols = cols_at(done)
        t1 = time.perf_counter()
        agg.ingest(cols)
        t2 = time.perf_counter()
        gen_s += t1 - t0
        ingest_call_s += t2 - t1
        done += batch
    agg.block_until_ready()
    elapsed = time.perf_counter() - start
    recompiles = _recompiles() - recompiles0
    est_rows = agg.cardinalities()  # production read: register max on device
    est = float(est_rows[cfg.global_hll_row])
    err = abs(est - done) / done
    bound = 3 * hll.standard_error(cfg.hll_precision)
    per_svc = est_rows[1 : n_services + 1]
    svc_true = done / n_services
    svc_err = float(np.abs(per_svc - svc_true).max() / svc_true)
    ok = err < bound and svc_err < bound and recompiles == 0
    _emit(config="config3", passed=ok, ids=done, estimate=round(est),
          rel_err=round(err, 5), worst_service_rel_err=round(svc_err, 5),
          path="TorchAggregator.ingest (production captured step)",
          ingest_spans_per_sec=round((done - batch) / elapsed),
          host_generation_share=round(gen_s / elapsed, 4),
          host_ingest_call_share=round(ingest_call_s / elapsed, 4),
          recompiles_in_window=recompiles)
    return ok


# config4's small config (EVAL_SMALL: a CPU smoke of the harness itself)
SMALL = AggConfig(
    max_services=64, max_keys=256, hll_precision=8,
    digest_centroids=16, digest_buffer=1 << 15,
    ring_capacity=1 << 15, link_buckets=4, hist_slices=2,
)

KINDS = (
    "dependencies", "dependencies_fresh", "percentiles", "windowed",
    "cardinalities", "search_selective", "search_broad",
)
# host-side scans (from-scratch rebuild + archive searches): reported with
# p50/p99 like everything else but excluded from the device-read latency
# gates — they decode spans on the host by design
HOST_SIDE = ("dependencies_fresh", "search_selective", "search_broad")
# amortized programs carry their own bounds so cost cannot silently migrate
# into them; flush + rollup are guaranteed to fire in the load phase, so
# their ABSENCE fails the gate (a program that stopped being timed must not
# vacuously pass its bound); spmd_quant_digest is bounded only if something
# dispatches it
AMORTIZED_BOUNDS = {"spmd_flush": 150.0, "spmd_rollup": 150.0, "spmd_quant_digest": 150.0}
AMORTIZED_REQUIRED = {"spmd_flush", "spmd_rollup"}
PROGRAM_SLO_MS = 50.0


def _tok(ep: int) -> str:  # 8 chars, non-hex prefix so it never collides with ids
    return f"rt{ep:06x}"


def _replay_corpus(batch: int, rotate_every: int) -> dict:
    """config4's corpus: one encoded template whose trace ids carry the
    fixed prefix ``feedface`` and whose service and span names end in the
    rotation token ``roto0000``; ``patched(it)`` is batch ``it``'s payload
    (prefix ``it``-stamped, so every batch's trace ids are fresh; token of
    rotation epoch ``it // rotate_every``) and its probe trace id."""
    raw_corpus = lots_of_spans(batch, seed=400, services=40, span_names=80)
    template = []
    for s in raw_corpus:
        ep = dataclasses.replace(
            s.local_endpoint, service_name=s.local_service_name + "-roto0000"
        )
        rep = (
            dataclasses.replace(
                s.remote_endpoint,
                service_name=s.remote_service_name + "-roto0000",
            )
            if s.remote_endpoint is not None
            else None
        )
        template.append(
            dataclasses.replace(
                s, trace_id="feedface" + s.trace_id[8:],
                name=(s.name or "op") + "-roto0000",
                local_endpoint=ep, remote_endpoint=rep,
            )
        )
    payload_t = json_v2.encode_span_list(template)
    probe_tid_t = template[0].trace_id

    def patched(it: int):
        tag = f"{0x10000000 + it:08x}".encode()
        rot = _tok(it // rotate_every).encode()
        return (
            payload_t.replace(b"feedface", tag).replace(b"roto0000", rot),
            probe_tid_t.replace("feedface", tag.decode()),
        )

    return {
        "template": template,
        "payload": payload_t,
        "patched": patched,
        # exact distinct-trace count per patched batch (suffix collisions
        # inside the template are counted once; prefixes are disjoint)
        "distinct_per_batch": len({s.trace_id for s in template}),
        "probe_n": sum(1 for x in template if x.trace_id == probe_tid_t),
        # getTraces search probes: the SELECTIVE query names an epoch-0
        # rotated service — once the rotation moves past epoch 0, segments
        # sealed under later tokens cannot contain that service id, so the
        # archive's zone-map sidecars must prune them without touching their
        # pages. The BROAD query carries no predicates and early-stops on the
        # newest segments. Both ride the production getTraces path.
        "sel_service": template[0].local_service_name.replace("roto0000", _tok(0)),
    }


def _program_snapshot() -> dict:
    """Each observatory program's (calls, device calls, device ms), every
    finished event pair folded in."""
    return {name: (d["calls"], d["deviceCalls"], d["deviceMs"])
            for name, d in OBSERVATORY.programs().items()}


def program_device_ms(before: dict, after: dict):
    """({spmd program: mean device ms a call between the two snapshots},
    [spmd programs called in between without their device time])."""
    times, missing = {}, []
    for name, (calls, dev_calls, dev_ms) in after.items():
        if not name.startswith("spmd_"):
            continue
        c0, d0, m0 = before.get(name, (0, 0, 0.0))
        if calls == c0:
            continue
        if dev_calls - d0 < calls - c0:
            missing.append(name)
        if dev_calls > d0:
            times[name] = round((dev_ms - m0) / (dev_calls - d0), 3)
    return times, sorted(missing)


def program_gate(program_ms: dict, missing) -> bool:
    """The query-program SLO: every timed program but the amortized ones
    under 50 ms of device time, each amortized one under its own bound and
    present when required, and none called without its device time."""
    gated = {k: v for k, v in program_ms.items() if k not in AMORTIZED_BOUNDS}
    return (
        not missing
        and bool(gated)
        and all(v < PROGRAM_SLO_MS for v in gated.values())
        and all(
            program_ms[k] < bound if k in program_ms else k not in AMORTIZED_REQUIRED
            for k, bound in AMORTIZED_BOUNDS.items()
        )
    )


def _on(device) -> dict:
    """The resume adapter's placement: ``device``, else the first card (the
    reference's ``num_devices=1``)."""
    return {"device": device} if device is not None else {"num_devices": 1}


def config4(device=None) -> bool:
    """Streaming replay + mixed Lens query load at the full-size AggConfig.

    - **Distinct identities at line rate**: the corpus is one encoded
      template whose trace ids carry a fixed 8-hex prefix; every batch
      byte-patches the prefix, so every batch streams DISTINCT trace ids
      through the HLL and the archive. The device HLL estimate is gated
      against the exact distinct count.
    - **Vocab churn at/over capacity**: service and span names embed a
      rotation token patched every EVAL_ROTATE_EVERY batches, so the
      cumulative key space runs past max_services/max_keys and the
      per-service catch-all overflow path stays live (gated: overflow
      counters must be nonzero once the schedule passes capacity).
    - **The disk archive runs LIVE on the ingest path** (budget-bounded by
      EVAL_ARCHIVE_BYTES), and in-window complete-trace probes gate.

    Query latency is measured two ways and BOTH gate the verdict:
    mid-stream (queueing behind the asynchronous ingest — in-flight depth
    bounded by EVAL_SYNC_EVERY_BATCHES) and quiesced (the query programs
    themselves: each program's device time from the device observatory's
    CUDA events, gated at 50 ms; a program without its device time fails
    the gate, and the CPU has none to gate). min/p50/p99 all reported.

    ``EVAL_REPLAY_DURABLE=<dir>`` runs the replay on the resume adapter
    (:class:`zipkin_tpu_torch.storage.tpu.TorchStorage`) with the
    durability plane live: the WAL in ``<dir>/wal``, a snapshot into
    ``<dir>/snap`` every EVAL_SNAPSHOT_EVERY_BATCHES (448) batches, which
    truncates the covered WAL segments, and a final one; the line's
    ``durability`` reports the snapshots committed (under the reference's
    key, ``snapshots_taken``, which there counts the ones attempted) and the
    disk each plane holds at the end.

    ``EVAL_RESUME_DIR=<dir>`` is the crash-resumable run (durable on
    ``<dir>``): the store boots by restoring ``<dir>/snap`` and replaying
    ``<dir>/wal``, batch indexing resumes from ``<dir>/eval_cursor.json``
    (``next_batch``, ``distinct_traces``, ``windows``, ``spans``), so trace
    id prefixes stay disjoint across windows, and a
    :class:`~zipkin_tpu_torch.runtime.supervisor.ResumeSupervisor` watches
    the sent count. A degraded window (EVAL_SUP_WINDOW_S,
    EVAL_DEGRADED_FRACTION, EVAL_DEGRADED_WINDOWS) or the window deadline
    (EVAL_WINDOW_DEADLINE_S) drains, snapshots, writes the cursor
    atomically, prints the window's line and exits ``EX_RESTART`` (75) for
    :mod:`zipkin_tpu_torch.evals.resume_driver` to relaunch. Span counts
    and distinct trace ids accumulate across windows toward the target,
    and the final window's distinct-identity gate holds the restored and
    replayed HLL to the cumulative count. Unlike the reference, a window
    whose batch reaches the target ends normally instead of tripping on
    it (the relaunch would replay past the target).
    """
    if not native.available():
        # the stream, the archive probes and the realism gates all ride the
        # native parser; without it they would stay disarmed and pass
        raise RuntimeError("config4 needs the native JSON parser, which did not build")
    total = int(os.environ.get("EVAL_REPLAY_SPANS", 2_000_000))
    cfg = SMALL if os.environ.get("EVAL_SMALL") else AggConfig()
    batch = min(BATCH, cfg.rollup_segment, cfg.digest_buffer)
    durable_dir = os.environ.get("EVAL_REPLAY_DURABLE") or None
    resume_dir = os.environ.get("EVAL_RESUME_DIR") or None
    if resume_dir:
        durable_dir = resume_dir
    cursor = {"next_batch": 0, "distinct_traces": 0, "windows": 0}
    cursor_path = os.path.join(resume_dir, "eval_cursor.json") if resume_dir else None
    if cursor_path and os.path.exists(cursor_path):
        with open(cursor_path) as f:
            cursor.update(json.load(f))
    # disk archive on the ingest path: default ON, budget-bounded so
    # retention churns live, in a temporary directory removed at the end;
    # EVAL_ARCHIVE_DIR=off disables (for A/B), EVAL_ARCHIVE_BYTES sets the
    # budget
    arc_env = os.environ.get("EVAL_ARCHIVE_DIR", "")
    arc_tmp = None
    if arc_env.lower() in ("off", "none", "0"):
        arc_dir = None
    elif arc_env:
        arc_dir = arc_env
    else:
        arc_dir = arc_tmp = tempfile.mkdtemp(prefix="config4_archive_")
    arc_kw = dict(
        archive_dir=arc_dir,
        archive_max_bytes=int(os.environ.get("EVAL_ARCHIVE_BYTES", 12 << 30)),
        # small segments let a smoke run seal enough of them to ARM the
        # zone-map pruning gate (search_probe_gate below)
        archive_segment_bytes=int(os.environ.get("EVAL_ARCHIVE_SEGMENT_BYTES", 64 << 20)),
    ) if arc_dir else {}
    # bound the asynchronous dispatch queue: sync every N batches so
    # mid-stream queries never queue behind an unbounded pipeline; 0
    # disables
    sync_every = int(os.environ.get("EVAL_SYNC_EVERY_BATCHES", 4))
    store = None
    try:
        if durable_dir:
            store = DurableStorage(
                config=cfg, batch_size=batch, max_span_count=100_000,
                checkpoint_dir=durable_dir + "/snap", wal_dir=durable_dir + "/wal",
                **_on(device), **arc_kw)
        else:
            store = TorchStorage(config=cfg, device=device, pad_to_multiple=batch,
                                 archive_max_span_count=100_000, **arc_kw)
        durable = Durable(
            durable_dir, int(os.environ.get("EVAL_SNAPSHOT_EVERY_BATCHES", 448)),
            cursor, cursor_path) if durable_dir else None
        return _replay(store, cfg, total, batch, arc_dir, sync_every, durable)
    finally:
        if store is not None:
            store.close()
        if arc_tmp is not None:
            shutil.rmtree(arc_tmp, ignore_errors=True)


@dataclasses.dataclass
class Durable:
    """config4's durability plane: the dir its WAL and snapshots live in,
    the snapshot period in batches, in resume mode the cursor read at boot
    and the path it is written back to (None otherwise), and the snapshots
    this run committed (a save returns None on a full disk or after close)."""

    directory: str
    snap_every: int
    cursor: dict
    cursor_path: Optional[str]
    snapshots: int = 0


def dir_bytes(path: str) -> int:
    """The bytes of every file under ``path``."""
    total = 0
    for root, _, files in os.walk(path):
        for name in files:
            try:
                total += os.path.getsize(os.path.join(root, name))
            except OSError:
                pass
    return total


def write_cursor(path: str, cursor: dict) -> None:
    """Replace ``path`` with ``cursor`` atomically (a rename)."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(cursor, f)
    os.replace(tmp, path)


def _replay(store: TorchStorage, cfg: AggConfig, total: int, batch: int,
            arc_dir: Optional[str], sync_every: int, durable: Optional[Durable] = None) -> bool:
    """config4's stream, reads and gates on a built store; ``durable`` its
    durability plane (the durable and resume modes)."""
    cursor = durable.cursor if durable is not None else {"next_batch": 0, "distinct_traces": 0,
                                                         "windows": 0}
    resume = durable is not None and durable.cursor_path is not None
    it0 = int(cursor["next_batch"])
    rotate_every = max(int(os.environ.get("EVAL_ROTATE_EVERY", 256)), 1)
    corpus = _replay_corpus(batch, rotate_every)
    template, payload_t, patched = corpus["template"], corpus["payload"], corpus["patched"]
    distinct_per_batch, probe_n = corpus["distinct_per_batch"], corpus["probe_n"]
    sel_service = corpus["sel_service"]
    search_skipped0 = int(store.ingest_counters().get("archiveSearchSegmentsSkipped", 0))

    end_ts = max(s.timestamp for s in template if s.timestamp) // 1000 + 3_600_000
    lookback = 1000 * 86_400_000
    # what the boot restored and replayed (the resume mode's cumulative
    # count), before the warm-up adds the template once more
    resumed_spans = store.ingest_counters()["spans"] if resume else 0
    # run EVERY program the stream can hit (each step variant, the
    # standalone flush and rollup) once, then capture the step graphs at
    # the store's lane ladder: no first use and no capture lands inside
    # the measurement
    store.warm(payload_t)
    store.capture_steps()
    sent = store.ingest_counters()["spans"]

    lat: dict = {k: [] for k in KINDS}  # mid-stream (under ingest load)
    quiesced: dict = {k: [] for k in KINDS}

    def timed(kind, fn, into):
        q0 = time.perf_counter()
        fn()
        into[kind].append((time.perf_counter() - q0) * 1e3)

    def query_round(into, fresh_version=True):
        # fresh_version bumps past BOTH the memoized pulls and the cached
        # link context (a post-write first query); fresh_version=False
        # re-pulls device reads but rides the cached context (the warm
        # repeated-query path a polling UI takes between writes)
        if fresh_version:
            store.agg.write_version += 1
        else:
            store.invalidate_read_cache()
        # the UI path: dependency answers may ride the bounded-staleness
        # cache under load — exactly what a polling Lens client experiences
        timed("dependencies",
              lambda: store.get_dependencies(end_ts, lookback).execute(), into)

        # the worst case: force a from-scratch recompute (answer + device
        # read caches cleared; under load the advanced write_version also
        # forces the link-context rebuild)
        def fresh():
            store.invalidate_read_cache()
            store.get_dependencies(end_ts, lookback).execute()

        timed("dependencies_fresh", fresh, into)
        timed("percentiles", lambda: store.latency_quantiles([0.5, 0.99]), into)
        timed("windowed",
              lambda: store.latency_quantiles([0.5, 0.99], end_ts=end_ts, lookback=lookback),
              into)
        timed("cardinalities", store.trace_cardinalities, into)
        if arc_dir:
            timed("search_selective",
                  lambda: store.get_traces_query(QueryRequest(
                      end_ts=end_ts, lookback=lookback, limit=5,
                      service_name=sel_service)).execute(), into)
            timed("search_broad",
                  lambda: store.get_traces_query(QueryRequest(
                      end_ts=end_ts, lookback=lookback, limit=10,
                  )).execute(), into)

    # the query programs' first calls land outside the timed window
    query_round(lat)
    for v in lat.values():
        v.clear()

    warm = sent  # spans ingested before the timed window opened
    probe_every = int(os.environ.get("EVAL_PROBE_EVERY", 64))
    # graceful wall deadline (seconds, 0 = none): on expiry the stream STOPS
    # CLEANLY and every gate evaluates at the scale actually reached —
    # reported beside the target, never silently
    deadline_s = float(os.environ.get("EVAL_WALL_DEADLINE_S", 0) or 0)
    progress_every = int(os.environ.get("EVAL_PROGRESS_EVERY", 128))
    deadline_hit = False
    probes: list = []
    probes_incomplete = 0
    acked: list = []  # patched probe tids, oldest first (bounded)
    distinct_traces = int(cursor["distinct_traces"])
    batches = 0
    sup = tripped = None
    if resume:
        sup = ResumeSupervisor(
            store,
            window_s=float(os.environ.get("EVAL_SUP_WINDOW_S", 5.0)),
            degraded_fraction=float(os.environ.get("EVAL_DEGRADED_FRACTION", 0.25)),
            degraded_windows=int(os.environ.get("EVAL_DEGRADED_WINDOWS", 3)),
            deadline_s=float(os.environ.get("EVAL_WINDOW_DEADLINE_S", 0) or 0),
        )
        sup.observe(sent)  # starts the window's clock
    recompiles0 = _recompiles()
    start = time.perf_counter()
    while sent < total:
        if deadline_s and time.perf_counter() - start > deadline_s:
            deadline_hit = True
            break
        payload, tid = patched(it0 + batches)
        n, _ = store.ingest_json_fast(payload)
        acked.append(tid)
        distinct_traces += distinct_per_batch
        sent += n
        batches += 1
        if sup is not None and sent < total:  # a window that reached the target ends
            tripped = sup.observe(sent)
            if tripped:
                break
        if sync_every and batches % sync_every == 0:
            # bound the in-flight dispatch queue (see docstring)
            store.agg.block_until_ready()
        if batches % 8 == 0:  # mixed query load mid-stream
            query_round(lat)
        if arc_dir and batches % probe_every == 0:
            # complete-trace probe of a trace acked ~half a window ago:
            # recent enough to be in archive retention, old enough to prove
            # the ack was durable, under full ingest load
            probe = acked[max(0, len(acked) - probe_every // 2 - 1)]
            p0 = time.perf_counter()
            got = store.get_trace(probe).execute()
            probes.append((time.perf_counter() - p0) * 1e3)
            if len(got) != probe_n:
                probes_incomplete += 1
            if len(acked) > 4 * probe_every:
                del acked[: 2 * probe_every]
        if durable is not None and durable.snap_every and batches % durable.snap_every == 0:
            # the durability plane under load: a snapshot clones the state on
            # the card under the lock, pulls it outside, and truncates the
            # WAL segments it covers, so the disk stays bounded
            durable.snapshots += store.snapshot() is not None
        if progress_every and batches % progress_every == 0:
            print(json.dumps({
                "progress": sent,
                "of": total,
                "spans_per_sec": round((sent - warm) / (time.perf_counter() - start)),
            }), file=sys.stderr, flush=True)
    store.agg.block_until_ready()

    def cursor_now() -> dict:
        return {"next_batch": it0 + batches, "distinct_traces": distinct_traces,
                "windows": cursor["windows"] + 1, "spans": sent}

    if tripped:
        # a degraded or deadline window: drain, snapshot, record the cursor
        # and exit restartable; the relaunch restores the snapshot and the
        # cumulative span count keeps climbing
        sup.finalize()
        now = cursor_now()
        write_cursor(durable.cursor_path, now)
        _emit(config="config4", window=now["windows"], window_tripped=tripped,
              window_exit=EX_RESTART, resumed_from_spans=resumed_spans, spans=sent,
              target_spans=total, supervisor=sup.stats(), restore=dict(store.restore_stats),
              window_spans_per_sec=round(
                  (sent - warm) / max(time.perf_counter() - start, 1e-9)),
              recompiles_in_window=_recompiles() - recompiles0, cursor=now)
        sys.exit(EX_RESTART)

    if not lat["dependencies"]:
        query_round(lat)  # never skip the query half at small smoke scales
    elapsed = time.perf_counter() - start
    recompiles = _recompiles() - recompiles0

    # Quiesced rounds: the mid-stream numbers include queueing behind the
    # asynchronous ingest (reads and writes share the card). With the stream
    # drained these measure the query programs themselves — the first round
    # pays the per-version link-context rebuild, later rounds ride the
    # cached context (the polling-UI path between writes). The staleness
    # cache is disabled here: quiesced rounds must measure device reads,
    # not cache hits.
    store._deps_max_stale_ms = 0.0
    query_round(quiesced)
    for _ in range(7):
        query_round(quiesced, fresh_version=False)

    # Program time: each spmd_* program's device time from the device
    # observatory's CUDA events over one FRESH round (write_version bumps,
    # so it includes the link-context read and spmd_edges_fresh — the
    # first-query-after-write programs) plus the BOUNDED amortized programs
    # (rollup, flush), dispatched so that their presence check can fail
    # loudly if a rename or regression hides them. The round's walls are
    # not kept: they would count twice.
    store.agg.block_until_ready()
    before = _program_snapshot()
    round_lat: dict = {k: [] for k in KINDS}
    query_round(round_lat, fresh_version=True)
    store.agg.rollup_now()
    store.agg.flush_now()
    store.agg.block_until_ready()
    program_ms, missing = program_device_ms(before, _program_snapshot())
    on_card = store.agg.device.type == "cuda"
    if on_card:
        slo_program_ok = program_gate(program_ms, missing)
        slo_gate = "program_device_time"
    else:
        # no device events on the CPU: nothing to gate, and no wall clock
        # stands in for device time
        slo_program_ok = None
        slo_gate = "none_on_cpu"

    def stats(xs):
        if not xs:
            return None
        xs = sorted(xs)
        return {"min": round(xs[0], 1), "p50": round(xs[len(xs) // 2], 1),
                "p99": round(xs[min(len(xs) - 1, int(len(xs) * 0.99))], 1)}

    counters = store.ingest_counters()
    q_stats = {k: stats(v) for k, v in lat.items()}
    quiesced_stats = {k: stats(v) for k, v in quiesced.items()}
    # under-load p50 < 500 ms for every UI read (the staleness cache and
    # rolled-only reads are what a polling client rides); the under-load
    # from-scratch dependency rebuild p50 < 5 s
    load_ok = all(
        s is None or s["p50"] < 500.0
        for k, s in q_stats.items() if k not in HOST_SIDE
    )
    fresh_ok = (
        q_stats["dependencies_fresh"] is None
        or q_stats["dependencies_fresh"]["p50"] < 5000.0
    )
    slo_ok = slo_program_ok is not False and load_ok and fresh_ok
    trace_readable = bool(store.get_service_names().execute())

    # realism gates ---------------------------------------------------------
    # (a) HLL vs the EXACT distinct-trace count (disjoint byte-patched
    #     prefixes make it closed-form); the warm-up ingested the template
    #     itself, contributing its distinct set once more
    hll_gate = None
    if distinct_traces:
        true_distinct = distinct_traces + distinct_per_batch  # + warm
        est = store.trace_cardinalities()["_global"]
        hll_err = abs(est - true_distinct) / true_distinct
        hll_bound = 3 * hll.standard_error(cfg.hll_precision)
        hll_gate = {
            "distinct_trace_ids": true_distinct,
            "hll_estimate": round(est),
            "rel_err": round(hll_err, 5),
            "bound_3sigma": round(hll_bound, 5),
            "passed": hll_err < hll_bound,
        }
    # (b) complete-trace probes from the live archive under load
    probe_gate = None
    if arc_dir and probes:
        ps = sorted(probes)
        probe_gate = {
            "probes": len(probes),
            "incomplete": probes_incomplete,
            "p50_ms": round(ps[len(ps) // 2], 1),
            "max_ms": round(ps[-1], 1),
            "passed": probes_incomplete == 0,
        }
    # (c) vocab churn kept the catch-all overflow path live whenever the
    #     rotation schedule pushed past capacity
    epochs = batches // rotate_every + 1
    # per-epoch vocab footprint derived from the template itself (every
    # epoch re-interns the same shape under rotated names)
    svcs_per_epoch = len(
        {s.local_service_name for s in template}
        | {s.remote_service_name for s in template if s.remote_service_name}
    )
    keys_per_epoch = len({(s.local_service_name, s.name) for s in template})
    churn_expected = (
        svcs_per_epoch * epochs > cfg.max_services
        or keys_per_epoch * epochs > cfg.max_keys
    )
    overflow_seen = int(
        counters.get("serviceVocabOverflow", 0)
        + counters.get("keyVocabOverflow", 0)
        + counters.get("nativeVocabOverflow", 0)
    )
    churn_gate = None
    if churn_expected:
        churn_gate = {
            "rotation_epochs": epochs,
            "vocab_overflow_updates": overflow_seen,
            "passed": overflow_seen > 0,
        }
    # (d) selective search pruned by zone maps: once the rotation has moved
    #     past epoch 0 AND at least one later segment sealed, the epoch-0
    #     service query must have skipped segments without touching their
    #     pages; with nothing to prune yet the gate stays disarmed
    #     (reported, trivially passing) — the churn gate's policy
    search_gate = None
    if arc_dir and lat["search_selective"]:
        seg_count = int(counters.get("archiveSegments", 0))
        skipped = int(counters.get("archiveSearchSegmentsSkipped", 0) - search_skipped0)
        armed = epochs >= 2 and seg_count >= 2
        search_gate = {
            "selective_service": sel_service,
            "segments": seg_count,
            "segments_skipped": skipped,
            "armed": armed,
            "passed": (skipped > 0) if armed else True,
        }
    realism_ok = all(
        g is None or g["passed"]
        for g in (hll_gate, probe_gate, churn_gate, search_gate)
    )
    ok = (
        counters["spans"] == sent
        and bool(lat["dependencies"])
        and trace_readable  # the native path must stay queryable
        and realism_ok
        and recompiles == 0
    )
    durability = None
    if durable is not None:
        # the final snapshot truncates the last WAL tail
        durable.snapshots += store.snapshot() is not None
        durability = {
            "snapshots_taken": durable.snapshots,
            "wal_bytes_final": dir_bytes(durable.directory + "/wal"),
            "snapshot_bytes_final": dir_bytes(durable.directory + "/snap"),
        }
    archive_stats = None
    if arc_dir:
        archive_stats = {k: v for k, v in counters.items() if k.startswith("archive")}
    now = cursor_now()
    if resume:
        write_cursor(durable.cursor_path, now)
    _emit(config="config4", passed=bool(ok and slo_ok), spans=sent,
          target_spans=total, wall_deadline_hit=deadline_hit,
          window=now["windows"] if resume else None,
          resumed_from_spans=resumed_spans if resume else None,
          restore=dict(store.restore_stats) if resume else None,
          supervisor=sup.stats() if sup is not None else None,
          cursor=now if resume else None,
          fast_path=True,
          sustained_spans_per_sec=round((sent - warm) / elapsed),
          distinct_identity_gate=hll_gate,
          archive_probe_gate=probe_gate,
          vocab_churn_gate=churn_gate,
          search_probe_gate=search_gate,
          archive=archive_stats,
          rotate_every_batches=rotate_every,
          sync_every_batches=sync_every,
          query_rounds=len(lat["dependencies"]),
          query_latency_under_load_ms=q_stats,
          query_latency_quiesced_ms=quiesced_stats,
          relay_floor_ms=None,
          query_program_device_ms=program_ms,
          programs_missing_device_time=missing,
          slo_gate=slo_gate,
          capture_error=None,
          slo_program_device_under_50ms=slo_program_ok,
          under_load_p50_under_500ms=load_ok,
          archive_readable_in_fast_mode=trace_readable,
          recompiles_in_window=recompiles,
          durability=durability)
    return bool(ok and slo_ok)


WORKER_START_S = 120.0  # the longest a fan-out pool may take to start


def _wait_workers(server: ZipkinServer) -> None:
    """Wait until the server's fan-out tier reports every parse worker
    ready (``wait_ready``): a pool still starting answers payloads with
    backpressure, and that is set-up, not the window's traffic."""
    if not server._mp_ingester.wait_ready(WORKER_START_S):
        raise RuntimeError("a parse worker did not start")


def config5(device=None, cfg: Optional[AggConfig] = None) -> bool:
    """The parse fan-out tier's wire-to-ack gate: proto3 spans/s through
    the server's HTTP boundary with device sampling armed (~50% hash drop:
    every service's rate at ``RATE_ONE // 2``, the link table at 1000) and
    the WAL attached.

    Leg 0 is the same-run in-process budget: the same store and payloads
    through ``ingest_json_fast`` with no server. Then, on a host of at
    least 2 cores, one wire leg through ``ZipkinServer(tpu_fast_ingest,
    tpu_mp_workers=min(4, cores))`` must reach EVAL_FANOUT_TARGET (the
    reference's 1M spans/s); on one core the gate is graceful degradation
    instead: the serial leg (0 workers) must hold EVAL_FANOUT_DEGRADE_FRAC
    (0.8) of leg 0, and a 2-worker leg is reported beside it. Each leg's
    store captures its graphs and warms before its window, and each window
    reports its recompiles; every answer must be a 202 or a 429 retried
    after 5 ms (:func:`zipkin_tpu_torch.evals.wire.drive`, two requests in
    flight).

    Departures: the reference's aiohttp client and fixed port
    (EVAL_FANOUT_PORT) are a thread client on an ephemeral port; a wire
    leg's window opens once the tier reports its parse workers ready
    (:func:`_wait_workers`), where the reference's opens on a pool that may
    still be starting. ``cfg`` (default
    ``AggConfig(sampling=True)``, full width) is for the CPU tests; the
    sampling tier is always on.
    """
    if not native.available():
        _emit(config="config5", passed=False, error="native codec unavailable")
        return False
    cores = os.cpu_count() or 1
    total = int(os.environ.get("EVAL_FANOUT_SPANS", 1_048_576))
    target = float(os.environ.get("EVAL_FANOUT_TARGET", 1_000_000))
    degrade_frac = float(os.environ.get("EVAL_FANOUT_DEGRADE_FRAC", 0.8))
    cfg = dataclasses.replace(cfg or AggConfig(), sampling=True)
    batch = BATCH
    payloads = fanout_payloads(batch)
    armed = {"sampling": True, "wal": True}

    def make_store(td: str) -> DurableStorage:
        store = DurableStorage(config=cfg, batch_size=batch, wal_dir=td + "/wal", **_on(device))
        rate = np.full_like(store.sampler.rate, RATE_ONE // 2)
        link = np.full_like(store.sampler.link, 1000)
        store.sampler.set_tables(rate, store.sampler.tail, link)
        store.install_sampler()
        return store

    def check_armed(store: DurableStorage) -> None:
        sampler = store.agg.sampler
        armed["sampling"] &= bool(sampler is not None and (sampler.rate == RATE_ONE // 2).all()
                                  and (sampler.link == 1000).all())
        armed["wal"] &= store.wal is not None

    recompiles = {}
    # leg 0: the same-run in-process proto3 budget (parse, pack, route, feed
    # with sampling and the WAL; no server boundary), the one-core gate's
    # denominator
    with tempfile.TemporaryDirectory() as td:
        store = make_store(td)
        try:
            store.warm(payloads[0])
            store.capture_steps()
            check_armed(store)
            rec0 = _recompiles()
            posted = i = 0
            t0 = time.perf_counter()
            while posted < total:
                accepted, dropped = store.ingest_json_fast(payloads[i % len(payloads)])
                posted += accepted + dropped
                i += 1
            store.agg.block_until_ready()
            inproc_rate = posted / (time.perf_counter() - t0)
            recompiles["inprocess"] = _recompiles() - rec0
        finally:
            store.close()

    stats = {"backpressure": 0, "responses": {}}

    def wire_leg(name: str, workers: int) -> float:
        with tempfile.TemporaryDirectory() as td:
            storage = make_store(td)
            # the server captures the store's graphs when it is built
            server = ZipkinServer(
                ServerConfig(host="127.0.0.1", port=0, storage_type="tpu",
                             tpu_fast_ingest=True, tpu_mp_workers=workers),
                storage=storage, device=device).start()
            try:
                storage.warm(payloads[0])
                check_armed(storage)
                if server._mp_ingester is not None:
                    _wait_workers(server)
                rec0 = _recompiles()
                elapsed = wire.drive(server.port, "proto3", payloads, batch, total, stats)
                if server._mp_ingester is not None:
                    t1 = time.perf_counter()
                    server._mp_ingester.drain()
                    elapsed += time.perf_counter() - t1
                storage.agg.block_until_ready()
                recompiles[name] = _recompiles() - rec0
            finally:
                server.stop()
            # posted spans over wall time: sampling drops on the ack path are
            # work done, not throughput lost
            return total / elapsed

    legs = {}
    if cores >= 2:
        fan_workers = min(4, cores)
        name = f"fanout_w{fan_workers}"
        legs[name] = round(wire_leg(name, fan_workers), 1)
        rate_ok = legs[name] >= target
        gate = "multi_core_absolute"
    else:
        legs["serial_w0"] = round(wire_leg("serial_w0", 0), 1)
        # the degradation record: the fan-out under core starvation
        legs["fanout_w2"] = round(wire_leg("fanout_w2", 2), 1)
        rate_ok = legs["serial_w0"] >= degrade_frac * inproc_rate
        gate = "one_core_degradation"
    responses_ok = set(stats["responses"]) <= {"202", "429"} and \
        stats["responses"].get("429", 0) == stats["backpressure"]
    gates = {"rate": rate_ok, "responses": responses_ok, "sampling_armed": armed["sampling"],
             "wal_attached": armed["wal"],
             "no_recompiles": all(v == 0 for v in recompiles.values())}
    ok = all(gates.values())
    _emit(config="config5", passed=bool(ok), cores=cores, gate=gate,
          wire_to_ack_spans_per_sec=legs,
          inprocess_proto3_spans_per_sec=round(inproc_rate, 1),
          target_spans_per_sec=target, degrade_frac=degrade_frac,
          spans_posted=total,
          sampling="~50% hash drop" if armed["sampling"] else "off",
          wal="attached" if armed["wal"] else "detached",
          responses=stats["responses"], backpressure=stats["backpressure"],
          recompiles_in_window=recompiles, gates=gates)
    return bool(ok)


SLO_CFG = dict(max_services=64, max_keys=256, hll_precision=9, ring_capacity=1 << 13)


def _statusz(base: str) -> dict:
    ans = wire.request("GET", base + "/api/v2/tpu/statusz")
    if ans.status != 200:
        raise RuntimeError(f"statusz answered {ans.status}")
    return json.loads(ans.body)


def config6(device=None) -> bool:
    """SLO watchdog trip and clear: a real burn on the ``query_fresh``
    latency SLO through the production record site; the watchdog must trip
    within one long window, show the alert on ``/prometheus``, and clear
    after recovery.

    The burn is physical: forced fresh dependency reads (the read cache
    dropped each time) run the real read path, and the over-threshold
    latencies go through the same ``obs.record("query_fresh", ...)`` the
    read path uses, so recorder -> windowed rings -> burn rates -> alert
    gauges is the production chain. The windows are shrunk through the
    server's settings (a 0.25 s tick, short 2 s and long 4 s windows).

    Who ticks: the reference drives an unstarted aiohttp app whose reads
    tick the windows when due; the port's started server ticks them on its
    own windows ticker, and a route ticks only when that ticker is not
    running, so the ticker is the one owner and no tick comes twice.

    Departure: phase A starts two seal periods after the POST, so the
    ticker's time-tier seal, not phase A's first fresh read, flushes the
    POST's pending digest points. That flush sorts the whole 131,072-point
    buffer: ~28 ms on one CPU thread, past the watchdog's bucket edge
    (32.8 ms) under load, while the reference counts on it being cheap.
    """
    short_s, long_s = 2.0, 4.0
    storage = DurableStorage(config=AggConfig(digest_centroids=32, **SLO_CFG), **_on(device))
    # warm the read path before the server builds its windowed plane: the
    # first fresh read's set-up cost is recorded as query_fresh too, a real
    # but uninteresting burn; the windows' baseline excludes what came before
    storage.accept(TRACE).execute()
    end_ts = max(s.timestamp for s in TRACE) // 1000 + 60_000
    deps = f"/api/v2/dependencies?endTs={end_ts}&lookback=86400000"
    for _ in range(3):
        storage.invalidate_read_cache()
        storage.get_dependencies(end_ts, 86_400_000).execute()
    server = ZipkinServer(
        ServerConfig(host="127.0.0.1", port=0, storage_type="tpu", obs_windows_tick_s=0.25,
                     obs_slo_short_s=short_s, obs_slo_long_s=long_s),
        storage=storage, device=device).start()
    base = f"http://127.0.0.1:{server.port}"

    def verdict():
        slo = _statusz(base)["slo"]
        return next(v for v in slo["specs"] if v["name"] == "query_fresh_p99"), slo

    try:
        wire.post(base + "/api/v2/spans", json_v2.encode_span_list(TRACE))
        # two seal periods and a tick: a seal of the windows ticker flushes
        # the POST's pending digest points, not phase A's first read
        time.sleep(2 * server.seal_interval_s + 0.25)
        # phase A, healthy: fast fresh reads, no alert
        for _ in range(4):
            storage.invalidate_read_cache()
            wire.request("GET", base + deps)
            time.sleep(0.3)
        v, _ = verdict()
        healthy = not v["alert"]

        # phase B, burn: every fresh read's latency lands far over the
        # 50 ms threshold (recorded through the production site)
        burn_t0 = time.perf_counter()
        tripped_after = None
        while time.perf_counter() - burn_t0 < 3 * long_s:
            storage.invalidate_read_cache()
            wire.request("GET", base + deps)
            for _ in range(4):
                obs.record("query_fresh", 0.080)
            v, _ = verdict()
            if v["alert"]:
                tripped_after = time.perf_counter() - burn_t0
                break
            time.sleep(0.3)
        text = wire.request("GET", base + "/prometheus").body.decode()
        alert_on_prom = 'zipkin_tpu_slo_alert{slo="query_fresh_p99"} 1' in text
        burn_on_prom = any(
            ln.startswith('zipkin_tpu_slo_burn_rate{slo="query_fresh_p99"')
            and float(ln.rsplit(" ", 1)[1]) >= 2.0 for ln in text.splitlines())

        # phase C, recovery: healthy traffic only; the burn ages out of the
        # long window and the alert clears
        rec_t0 = time.perf_counter()
        cleared_after = None
        slo = {"trips": 0, "clears": 0}
        while time.perf_counter() - rec_t0 < 4 * long_s:
            storage.invalidate_read_cache()
            wire.request("GET", base + deps)
            v, slo = verdict()
            if not v["alert"]:
                cleared_after = time.perf_counter() - rec_t0
                break
            time.sleep(0.3)
        r = {
            "healthy_baseline": healthy,
            "tripped_after_s": tripped_after and round(tripped_after, 2),
            "alert_on_prometheus": alert_on_prom,
            "burn_rate_on_prometheus": burn_on_prom,
            "cleared_after_s": cleared_after and round(cleared_after, 2),
            "trips": slo["trips"], "clears": slo["clears"],
        }
    finally:
        server.stop()
    ok = bool(
        r["healthy_baseline"]
        # the trip lands within one long window of the burn becoming
        # visible, with one tick and poll of slack
        and r["tripped_after_s"] is not None
        and r["tripped_after_s"] <= long_s + 1.0
        and r["alert_on_prometheus"] and r["burn_rate_on_prometheus"]
        and r["cleared_after_s"] is not None
        and r["trips"] >= 1 and r["clears"] >= 1
    )
    _emit(config="config6", passed=ok, short_s=short_s, long_s=long_s, threshold_ms=50.0, **r)
    return ok


def config7(device=None) -> bool:
    """Accuracy drift trip and clear: a deliberately undersized t-digest
    (C=4) fed a bimodal duration stream it cannot summarize. The accuracy
    plane's shadow measures the real digest-against-truth p99 gap, the
    drift gauge (the excess over the shadow's own sampling noise) crosses
    the 0.20 limit and ``digest_p99_relerr`` trips within one long window;
    recovery (the store cleared, the shadow reset, a unimodal stream)
    clears it.

    The drift is physical: spans go through ``POST /api/v2/spans``, the
    shadow taps the production ingest path, and the rollup pulls the
    card's digest through the packed read. The healthy phase proves the
    converse: the same C=4 digest on a narrow unimodal stream shows near-0
    drift, so the alert keys on genuine mis-sizing.

    Who ticks: the server's own windows ticker (0.25 s), which rolls up the
    accuracy plane on every tick (``obs_shadow_rollup_s=0``); the routes
    tick only when that ticker is not running (config6's docstring).
    """
    short_s, long_s = 2.0, 4.0
    seq = [0]
    rng = random.Random(23)

    def make_spans(durs):
        out = drift_spans(durs, seq[0], int(time.time() * 1e6))
        seq[0] += len(durs)
        return out

    def unimodal(n):
        return [rng.gauss(1000, 40) for _ in range(n)]

    def bimodal(n):
        return [100_000 if rng.random() < 0.10 else 1000 for _ in range(n)]

    storage = DurableStorage(config=AggConfig(digest_centroids=4, **SLO_CFG), **_on(device))
    # warm the packed read programs before the server builds its windowed
    # plane: the first rollup's set-up must not count as phase A's time
    storage.accept(make_spans(unimodal(64))).execute()
    storage.agg.merged_digest()
    storage.agg.cardinalities()
    storage.agg.dependency_edges(0, (1 << 32) - 1)
    server = ZipkinServer(
        ServerConfig(host="127.0.0.1", port=0, storage_type="tpu", obs_windows_tick_s=0.25,
                     obs_slo_short_s=short_s, obs_slo_long_s=long_s,
                     obs_shadow_rollup_s=0.0),  # roll up on every tick
        storage=storage, device=device).start()
    base = f"http://127.0.0.1:{server.port}"

    def verdict():
        body = _statusz(base)
        return next(x for x in body["slo"]["specs"] if x["name"] == "digest_p99_relerr"), body

    def post(spans) -> None:
        status = wire.post(base + "/api/v2/spans", json_v2.encode_span_list(spans)).status
        if status != 202:
            raise RuntimeError(f"POST /api/v2/spans answered {status}")

    try:
        # phase A, healthy: the undersized digest still summarizes a narrow
        # unimodal stream; drift stays under the limit
        post(make_spans(unimodal(2000)))
        time.sleep(4 * 0.25)
        v, body = verdict()
        healthy = not v["alert"]
        healthy_drift = body["accuracy"]["gauges"]["accuracyDigestP99Drift"]

        # phase B, drift: a bimodal stream the C=4 digest cannot hold
        post(make_spans(bimodal(4000)))
        burn_t0 = time.perf_counter()
        tripped_after = None
        drift_seen = 0.0
        while time.perf_counter() - burn_t0 < 3 * long_s:
            v, body = verdict()
            drift_seen = max(drift_seen, body["accuracy"]["gauges"]["accuracyDigestP99Drift"])
            if v["alert"]:
                tripped_after = time.perf_counter() - burn_t0
                break
            time.sleep(0.2)
        prom = wire.request("GET", base + "/prometheus").body.decode()
        alert_on_prom = 'zipkin_tpu_slo_alert{slo="digest_p99_relerr"} 1' in prom

        # phase C, recovery: drop the poisoned state on both sides of the
        # comparison and return to well-behaved traffic
        storage.clear()
        server._obs_shadow.reset()
        post(make_spans(unimodal(2000)))
        rec_t0 = time.perf_counter()
        cleared_after = None
        while time.perf_counter() - rec_t0 < 4 * long_s:
            v, body = verdict()
            if not v["alert"]:
                cleared_after = time.perf_counter() - rec_t0
                break
            time.sleep(0.2)
        r = {
            "healthy_baseline": healthy,
            "healthy_drift": round(healthy_drift, 4),
            "drift_seen": round(drift_seen, 4),
            "tripped_after_s": tripped_after and round(tripped_after, 2),
            "alert_on_prometheus": alert_on_prom,
            "cleared_after_s": cleared_after and round(cleared_after, 2),
            "trips": body["slo"]["trips"],
            "clears": body["slo"]["clears"],
        }
    finally:
        server.stop()
    ok = bool(
        r["healthy_baseline"]
        and r["healthy_drift"] < 0.20
        and r["drift_seen"] > 0.20
        and r["tripped_after_s"] is not None
        and r["tripped_after_s"] <= long_s + 1.0
        and r["alert_on_prometheus"]
        and r["cleared_after_s"] is not None
        and r["trips"] >= 1 and r["clears"] >= 1
    )
    _emit(config="config7", passed=ok, short_s=short_s, long_s=long_s, drift_limit=0.20,
          digest_centroids=4, **r)
    return ok


# configs 8 and 9's store: a small config, batches of 512
FLOOD_CFG = dict(max_services=64, max_keys=256, hll_precision=8, digest_centroids=16,
                 digest_buffer=1 << 14, ring_capacity=1 << 14, link_buckets=4, hist_slices=2)
LONG_WINDOW_TICKS = 300  # one long SLO window at the production 1 Hz tick


def _flood_store(tmp: str, device) -> DurableStorage:
    """A store on ``tmp``'s checkpoint and WAL dirs: the live one, or a
    cold boot from what the live one made durable."""
    return DurableStorage(config=AggConfig(**FLOOD_CFG), batch_size=512,
                          checkpoint_dir=os.path.join(tmp, "ckpt"),
                          wal_dir=os.path.join(tmp, "wal"), **_on(device))


def _revived_spans(tmp: str, device) -> int:
    """The span count a cold boot from ``tmp``'s dirs replays to: the acked
    set a crash at this instant would keep. The live store has no rate
    controller (no sampling budget) and its tier is drained, so nothing
    writes the dirs while the twin boots."""
    revived = _flood_store(tmp, device)
    try:
        return int(revived.agg.host_counters["spans"])
    finally:
        revived.close()


def config8(device=None) -> bool:
    """Overload flood gate: a flood of at least 3x the tier's queue capacity
    through the HTTP boundary while the device feed is slowed and the WAL
    hits ENOSPC mid-flood. The gate:

    - admitted traffic's wire-to-ack p99 within the ack SLO (250 ms),
    - every shed guided: ``Retry-After``/``X-Retry-After-Ms`` on each 429,
      and a real-channel gRPC Report shed at B3 lands as
      ``RESOURCE_EXHAUSTED`` with ``retry-delay`` trailing metadata,
    - the disk-full window degrades to the at-risk flag (not a crash) and
      the next committed snapshot clears it,
    - no acked span lost: a cold boot from the same WAL and checkpoint dirs
      replays to exactly the acked span set,
    - the brownout ladder back at B0 within one long window (300 ticks) of
      the flood's end.

    Who ticks: the server runs with its windows off and no seal thread
    (``seal_interval_s=0``), and the eval steps the ladder by hand
    (``evaluate``), as the reference does; the 300 ticks are counted.
    Every fault is disarmed in a ``finally``. The reference's concurrent
    aiohttp posts go out from one event loop (:func:`wire.flood`), on
    warmed connections as config9's do (see its docstring), its
    ``grpc.aio`` channel a blocking one.

    Departure: the flood starts once the tier reports its parse worker
    ready (:func:`_wait_workers`), where the reference's starts on a pool
    that may still be starting; a spawned worker loads for longer than the
    port's server takes to start, so without the wait the flood would be
    shed for the spawn, not for the overload.
    """
    workers, depth = 1, 2
    capacity = workers * depth
    per = int(os.environ.get("EVAL_FLOOD_PER", 40))
    n_flood = int(os.environ.get("EVAL_FLOOD_N", 18))
    ack_slo_ms = float(os.environ.get("EVAL_FLOOD_ACK_SLO_MS", 250.0))
    with tempfile.TemporaryDirectory(prefix="eval_config8_") as tmp:
        storage = _flood_store(tmp, device)
        server = ZipkinServer(
            ServerConfig(host="127.0.0.1", port=0, storage_type="tpu", tpu_fast_ingest=True,
                         tpu_mp_workers=workers, tpu_mp_queue_depth=depth,
                         obs_windows_enabled=False),
            storage=storage, seal_interval_s=0, device=device).start()
        base = f"http://127.0.0.1:{server.port}"
        try:
            _wait_workers(server)
            # the flood window: the device feed slowed (the real reason
            # queues back up) and ENOSPC on the first WAL append: the disk
            # fills while the tier is overloaded
            faults.arm_resource("feed.latency", nth=1, count=6, latency_ms=120)
            faults.arm_resource("wal.append", nth=1, count=1)
            results = wire.flood([
                ("POST", base + "/api/v2/spans",
                 json_v2.encode_span_list(flood_spans(i, per, 0xE800_0000)),
                 {"Content-Type": "application/json"})
                for i in range(n_flood)])
            acked = [r for r in results if r.status == 202]
            shed = [r for r in results if r.status == 429]
            guided = [r for r in shed if int(r.headers.get("Retry-After", 0)) >= 1
                      and int(r.headers.get("X-Retry-After-Ms", 0)) > 0]
            ack_p99_ms = float(np.percentile([r.ms for r in acked], 99)) if acked else None
            server._mp_ingester.drain()
            faults.disarm()

            counters = storage.ingest_counters()
            degraded = (counters.get("walEnospc") == 1
                        and counters.get("walMissedRecords") == 1
                        and counters.get("durabilityAtRisk") == 1)
            acked_spans = per * len(acked)
            device_parity = int(storage.agg.host_counters["spans"]) == acked_spans
            # recovery: a committed snapshot covers the lost WAL record (the
            # state it captures holds that batch) and the flag clears
            snap_ok = storage.snapshot() is not None
            at_risk_cleared = storage.ingest_counters()["durabilityAtRisk"] == 0
            durable_parity = _revived_spans(tmp, device) == acked_spans

            # the gRPC twin of the 429: pin the ladder at B3 (the flood in
            # signal form) and Report over a real channel; B3 keeps a 5%
            # bulk lifeline, so probe a few times for a shed
            ctl = server._overload
            for _ in range(8):
                ctl.evaluate({"critpathQueueSaturation": 0.9})
            grpc_guided = False
            with wire.GrpcCollector(server.collector) as gsrv:
                for k in range(5):
                    code, md = wire.report(gsrv.port, proto3.encode_span_list(
                        flood_spans(0x9000 + k, 4, 0xE800_0000)))
                    if code != "OK":
                        grpc_guided = (code == "RESOURCE_EXHAUSTED"
                                       and md.get("retry-delay", "").endswith("s")
                                       and int(md.get("retry-delay-ms", 0)) > 0)
                        break

            # the flood's end: calm ticks only; B0 must come back inside one
            # long window (3 levels x dwell 5 + the EMA's decay is ~20 ticks)
            ticks_to_b0 = None
            for t in range(1, LONG_WINDOW_TICKS + 1):
                if ctl.evaluate({"critpathQueueSaturation": 0.0}) == 0:
                    ticks_to_b0 = t
                    break
            r = {
                "offered": n_flood,
                "queue_capacity": capacity,
                "offered_over_capacity": round(n_flood / capacity, 1),
                "acked": len(acked), "shed": len(shed),
                "sheds_with_guidance": len(guided),
                "acked_ack_p99_ms": ack_p99_ms and round(ack_p99_ms, 2),
                "enospc_degraded_not_crashed": degraded,
                "device_parity": device_parity,
                "snapshot_cleared_at_risk": snap_ok and at_risk_cleared,
                "durable_parity": durable_parity,
                "grpc_shed_guided": grpc_guided,
                "calm_ticks_to_b0": ticks_to_b0,
                "ladder_transitions": len(ctl.status()["history"]),
            }
        finally:
            faults.disarm()
            server.stop()
    ok = bool(
        r["offered_over_capacity"] >= 3.0
        and r["acked"] > 0 and r["shed"] > 0
        and r["acked"] + r["shed"] == r["offered"]
        and r["sheds_with_guidance"] == r["shed"]
        and r["acked_ack_p99_ms"] is not None
        and r["acked_ack_p99_ms"] <= ack_slo_ms
        and r["enospc_degraded_not_crashed"]
        and r["device_parity"] and r["durable_parity"]
        and r["snapshot_cleared_at_risk"]
        and r["grpc_shed_guided"]
        and r["calm_ticks_to_b0"] is not None
        and r["calm_ticks_to_b0"] <= LONG_WINDOW_TICKS
    )
    _emit(config="config8", passed=ok, ack_slo_ms=ack_slo_ms,
          long_window_ticks=LONG_WINDOW_TICKS, **r)
    return ok


def config9(device=None) -> bool:
    """Tenant flood containment gate: three tenants share one server;
    tenant B floods 4x its per-tenant ingest budget through the HTTP
    boundary (``X-Tenant-Id``) while A and C stay inside theirs. The gate:

    - every 429 is B's, carries ``X-Shed-Scope: tenant``/``X-Shed-Tenant:
      B`` and ``Retry-After`` guidance from B's own bucket deficit; A and C
      are never shed,
    - A's and C's wire-to-ack p99 and the mid-flood query p99 within SLO
      (250 ms each), and the global brownout ladder never leaves B0 (0
      transitions): containment, not degradation,
    - per-tenant posture: B at level >= 2, A and C at 0, on ``/statusz``
      and as ``{tenant=}`` Prometheus families,
    - per-tenant acked attribution through the fan-out tier exact
      (``mpTenantTable`` spans == per x that tenant's 202s),
    - a gRPC Report as B over a real channel sheds ``RESOURCE_EXHAUSTED``
      with ``shed-scope: tenant`` trailing metadata,
    - no acked span lost for any tenant across a mid-flood crash-resume (a
      cold boot between the flood's two waves replays exactly the acked
      set) and again at the flood's end,
    - calm ticks bring B back to level 0 within one long window (300).

    Who ticks: as config8 (windows off, no seal thread, the ladder stepped
    by hand, the ticks counted; the calm ticks paced 20 ms apart so the
    bucket refills in real time). The queue capacity is far above the
    offered load, so the tenant budget is the only control that sheds.

    Departures: the flood starts once the tier reports its parse workers
    ready, as in config8. The second wave starts one burst period (1 s)
    after the first began. A and C send 3 payloads a wave against a bucket of 4 that
    refills at 4 payloads/s, so they stay in budget only when at least
    0.5 s separates the waves; the reference's cold boot between them
    takes that long on its TPU (a new store's first compiles), the port's
    takes less, and without the wait A and C would be shed for the
    crash-resume's speed, not for their own traffic. A wave's 38 requests
    go out at once from one thread (:func:`wire.flood`), their bodies
    encoded before it starts, each on a connection that has answered a
    ``GET /health`` first, as a pooled client's connections have; the
    reference's first wave opens its connections inside the wave. The
    port's threaded server starts a thread for each new connection, one
    accept at a time, and on a loaded CPU 38 new connections alone took
    120-190 ms, the whole of the measured ack time and no part of the
    containment this gate measures; the reference's aiohttp server
    accepts on its one event loop without a thread.
    """
    workers, depth = 2, 16
    per = int(os.environ.get("EVAL_TENANT_SPANS_PER", 40))
    n_flood = int(os.environ.get("EVAL_TENANT_FLOOD_N", 16))
    n_calm_posts = 3
    ack_slo_ms = float(os.environ.get("EVAL_TENANT_ACK_SLO_MS", 250.0))
    query_slo_ms = float(os.environ.get("EVAL_TENANT_QUERY_SLO_MS", 250.0))
    # B's budget sized off the real wire payload: a burst of 4 payloads, so
    # a 16-payload burst is a 4x flood while A's and C's 3 stay inside
    body_len = len(json_v2.encode_span_list(flood_spans(0, per, 0xE900_0000)))
    budget_bytes_per_s = 4.0 * body_len
    burst_s = 1.0
    with tempfile.TemporaryDirectory(prefix="eval_config9_") as tmp:
        storage = _flood_store(tmp, device)
        server = ZipkinServer(
            ServerConfig(host="127.0.0.1", port=0, storage_type="tpu", tpu_fast_ingest=True,
                         tpu_mp_workers=workers, tpu_mp_queue_depth=depth,
                         obs_windows_enabled=False,
                         tenant_ingest_bytes_per_s=budget_bytes_per_s,
                         tenant_ingest_burst_s=burst_s, tenant_flood_ratio=2.0,
                         tenant_dwell_ticks=3),
            storage=storage, seal_interval_s=0, device=device).start()
        base = f"http://127.0.0.1:{server.port}"
        ctl = server._overload
        seq = iter(range(1, 1 << 20))
        try:
            _wait_workers(server)

            def wave():
                # the bodies are encoded before the wave starts (see the docstring)
                tenants = ["B"] * n_flood + ["A"] * n_calm_posts + ["C"] * n_calm_posts
                posts = [("POST", base + "/api/v2/spans",
                          json_v2.encode_span_list(flood_spans(next(seq), per, 0xE900_0000)),
                          {"Content-Type": "application/json", TENANT_HEADER: t}) for t in tenants]
                out = wire.flood(posts + [("GET", base + "/api/v2/services", None, None)] * 8)
                return ([(t, a.status, a.headers, a.ms) for t, a in zip(tenants, out)],
                        [(a.status, a.ms) for a in out[len(posts):]])

            wave_t0 = time.monotonic()
            results, queries = wave()
            server._mp_ingester.drain()
            acked_so_far = per * sum(1 for r in results if r[1] == 202)
            # the mid-flood crash-resume: a cold boot between the waves
            durable_parity_mid = _revived_spans(tmp, device) == acked_so_far
            # the calm tenants' buckets refill over one burst period before
            # the flood resumes (see the docstring)
            time.sleep(max(0.0, burst_s - (time.monotonic() - wave_t0)))
            res2, q2 = wave()  # the flood resumes after the "crash"
            results += res2
            queries += q2
            server._mp_ingester.drain()

            by = {t: [r for r in results if r[0] == t] for t in ("A", "B", "C")}
            sheds = [r for r in results if r[1] == 429]
            guided = [r for r in sheds
                      if r[2].get("X-Shed-Scope") == "tenant" and r[2].get("X-Shed-Tenant") == "B"
                      and int(r[2].get("Retry-After", 0)) >= 1
                      and int(r[2].get("X-Retry-After-Ms", 0)) > 0]
            ac_ack_ms = [r[3] for t in ("A", "C") for r in by[t] if r[1] == 202]
            ack_p99_ms = float(np.percentile(ac_ack_ms, 99)) if ac_ack_ms else None
            q_ms = [ms for st, ms in queries if st == 200]
            query_p99_ms = float(np.percentile(q_ms, 99)) if len(q_ms) == len(queries) else None
            acked_n = {t: sum(1 for r in by[t] if r[1] == 202) for t in by}
            mp_table = server._mp_ingester.stats()["mpTenantTable"]
            attribution_exact = all(mp_table.get(t, {}).get("spans", 0) == per * acked_n[t]
                                    for t in ("A", "B", "C"))

            # the aggregate posture at the flood's peak: the ladder gets the
            # real fan-out queue saturation; containment keeps it at B0
            stats = server._mp_ingester.stats()
            qsat = max(row["queueDepth"] for row in stats["mpWorkerTable"]) / depth
            ctl.evaluate({"critpathQueueSaturation": qsat})
            c = ctl.counters()
            global_b0 = c["overloadLevel"] == 0 and c["overloadTransitions"] == 0
            levels = {t: c.get(f"tenantLevel_{t}") for t in ("A", "B", "C")}
            statusz_b_level = _statusz(base)["overload"]["tenants"]["tenants"]["B"]["level"]
            prom = wire.request("GET", base + "/prometheus").body.decode()
            prom_lines = [ln for ln in prom.splitlines()
                          if ln.startswith("zipkin_tpu_tenant_") and "{" in ln]
            prom_ok = (
                any('zipkin_tpu_tenant_level{tenant="B"}' in ln for ln in prom_lines)
                and any('tenant="A"' in ln for ln in prom_lines)
                and all(len(ln.rsplit(" ", 1)) == 2 and float(ln.rsplit(" ", 1)[1]) >= 0.0
                        for ln in prom_lines))

            # the gRPC twin: Report as B over a real channel while B's bucket
            # is dry, with payloads big enough that the refill cannot outrun
            # the probes; an admitted probe is budget headroom working
            grpc_guided = False
            grpc_admitted_spans = 0
            with wire.GrpcCollector(server.collector) as gsrv:
                for k in range(6):
                    n = per * 2
                    code, md = wire.report(
                        gsrv.port,
                        proto3.encode_span_list(flood_spans(0x9100 + k, n, 0xE900_0000)),
                        metadata=(("x-tenant-id", "B"),))
                    if code == "OK":
                        grpc_admitted_spans += n
                        continue
                    grpc_guided = (code == "RESOURCE_EXHAUSTED"
                                   and md.get("shed-scope") == "tenant"
                                   and md.get("shed-tenant") == "B"
                                   and int(md.get("retry-delay-ms", 0)) > 0)
                    break
            server._mp_ingester.drain()
            acked_spans = per * sum(acked_n.values()) + grpc_admitted_spans
            device_parity = int(storage.agg.host_counters["spans"]) == acked_spans
            durable_parity = _revived_spans(tmp, device) == acked_spans

            # calm: pressure decays tick by tick and the bucket refills in
            # real time; the ticks are paced so both can happen
            ticks_to_calm = None
            for t in range(1, LONG_WINDOW_TICKS + 1):
                ctl.evaluate({"critpathQueueSaturation": 0.0})
                c = ctl.counters()
                if c["overloadLevel"] == 0 and c.get("tenantLevel_B", 0) == 0:
                    ticks_to_calm = t
                    break
                time.sleep(0.02)
            r = {
                "budget_payloads_per_burst": 4,
                "b_offered_over_budget": round(n_flood / 4.0, 1),
                "acked": {t: acked_n[t] for t in ("A", "B", "C")},
                "shed": len(sheds),
                "sheds_tenant_scoped_to_b": len(guided),
                "a_c_sheds": sum(1 for t in ("A", "C") for r in by[t] if r[1] == 429),
                "ac_ack_p99_ms": ack_p99_ms and round(ack_p99_ms, 2),
                "query_p99_ms": query_p99_ms and round(query_p99_ms, 2),
                "attribution_exact": attribution_exact,
                "global_stays_b0": global_b0,
                "tenant_levels": levels,
                "statusz_b_level": statusz_b_level,
                "prom_tenant_families_ok": prom_ok,
                "grpc_shed_guided": grpc_guided,
                "device_parity": device_parity,
                "durable_parity_mid_flood": durable_parity_mid,
                "durable_parity": durable_parity,
                "calm_ticks_to_level0": ticks_to_calm,
            }
        finally:
            server.stop()
    ok = bool(
        r["b_offered_over_budget"] >= 3.0
        and r["acked"]["A"] == 2 * n_calm_posts
        and r["acked"]["C"] == 2 * n_calm_posts
        and r["a_c_sheds"] == 0
        and r["acked"]["B"] >= 1 and r["shed"] >= 1
        and r["acked"]["B"] + r["shed"] == 2 * n_flood
        and r["sheds_tenant_scoped_to_b"] == r["shed"]
        and r["ac_ack_p99_ms"] is not None
        and r["ac_ack_p99_ms"] <= ack_slo_ms
        and r["query_p99_ms"] is not None
        and r["query_p99_ms"] <= query_slo_ms
        and r["attribution_exact"]
        and r["global_stays_b0"]
        and r["tenant_levels"]["B"] >= 2
        and r["tenant_levels"]["A"] == 0
        and r["tenant_levels"]["C"] == 0
        and r["statusz_b_level"] >= 2
        and r["prom_tenant_families_ok"]
        and r["grpc_shed_guided"]
        and r["device_parity"]
        and r["durable_parity_mid_flood"] and r["durable_parity"]
        and r["calm_ticks_to_level0"] is not None
        and r["calm_ticks_to_level0"] <= LONG_WINDOW_TICKS
    )
    _emit(config="config9", passed=ok, ack_slo_ms=ack_slo_ms, query_slo_ms=query_slo_ms,
          long_window_ticks=LONG_WINDOW_TICKS, **r)
    return ok


ALL = {"config0": config0, "config1": config1, "config2": config2,
       "config3": config3, "config4": config4, "config5": config5,
       "config6": config6, "config7": config7, "config8": config8,
       "config9": config9}


def launch_counts() -> dict:
    """Each hand kernel's launches so far in this process."""
    return {"hll_update": hll_kernel.update.launches,
            "hll_update_step": hll_kernel.update_step.launches,
            "ring_append": ring_kernel.append.launches,
            "link_chase": chase_kernel.chase.launches}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("configs", nargs="*", metavar="config",
                        help=f"configs to run, in order (default all: {' '.join(ALL)})")
    parser.add_argument("--device", default=None,
                        help="the device to run on (default the card; 'cpu' runs the plain path)")
    args = parser.parse_args(argv)
    unknown = [c for c in args.configs if c not in ALL]
    if unknown:
        parser.error(f"unknown config(s) {unknown}; known: {list(ALL)}")
    if args.device is None and not torch.cuda.is_available():
        print("run_configs: no CUDA device is available; pass --device cpu to run on the CPU",
              file=sys.stderr)
        return 2
    ok = True
    launches = {}
    for name in args.configs or list(ALL):
        before = launch_counts()
        ok &= ALL[name](args.device)
        launches[name] = {k: v - before[k] for k, v in launch_counts().items()}
    launches["total"] = {k: sum(c[k] for c in launches.values()) for k in launch_counts()}
    print(json.dumps({"launches": launches}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

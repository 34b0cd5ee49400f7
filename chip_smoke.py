#!/usr/bin/env python3
"""Smoke run of the PyTorch port (zipkin_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--seed N] [--spans N]

Builds the hand-written kernels from the sources in the checkout, then:

(a) holds the single-target HLL kernel against its plain PyTorch version
    at the main path's shapes, on uniform random rows, on the card
    (results must be equal) and times kernel, plain version and the
    nearest single PyTorch call;
(b) drives the same seeded batches through TorchAggregator on the card
    and on the CPU at a small config (flushes, rollups, ring wraps) and
    compares every state leaf and every read; then once more with
    sampling on, tables published twice mid-stream, a WAL hook and a
    TimeTier sealing after every step, comparing leaves, time-tier reads,
    window answers and WAL records, and that every read on the card makes
    one transfer;
(c) drives the main path at the default AggConfig: 2**20 synthetic spans
    in 8 x 8192-span coalesced steps through ingest_fused_multi, then the
    quantile, cardinality and dependency reads, checked against what the
    generator knows, with each kernel's launch count and each read's
    transfers;
(a2) holds the fused HLL update against its plain version and the four
    single-target launches it replaced, on the main path's own lanes at
    its first step (fresh register files) and its last (the files (c)
    left), and times them in turns;
(d) the same traffic at the default AggConfig with sampling on: a
    RateController ticking every 4 steps at a quarter of the span rate, a
    TimeTier sealing after every step; checks each step's ring verdicts
    against the host sampler, the sketches against an unsampled twin that
    replays the run's flushes, and every sealed epoch and window against
    what the generator knows; times the sampled step, the host sampler,
    the seal read, window reads and the controller's tick;
(e) the storage SPI's object path at the default AggConfig: 2**18 spans
    rendered as Span objects and encoded as 4,096-span JSON v2 and proto3
    payloads, each through codec.decode_spans -> TorchStorage's
    span_consumer().accept(); checks get_trace, dependencies, cardinalities,
    percentile rows, names, and after tt_seal() sealed and mixed windows
    against the generator, the transfers of every store read and that
    update_step launched once per device batch; times each stage and read;
(f1) the line-rate path: phase e's payloads through
    Collector(fast_ingest=True) -> TorchStorage.ingest_json_fast (native
    parser, pack_parsed, a 1/64 archive sample); checks that the parser took
    every payload, that every state leaf equals phase e's, that update_step
    launched once per device batch, and the same reads against the
    generator; times each stage;
(f2) the server in-process (ZipkinServer, STORAGE_TYPE=tpu, TPU_FAST_INGEST=1,
    an ephemeral port): 4 threads POST the payloads over HTTP, then gzip,
    protobuf, v1, malformed (400) and gzip-bomb (413) bodies; every ported
    route is checked against the generator and the store's direct answer
    and timed;
(f3) ``python -m zipkin_tpu_torch.server --storage tpu`` as a subprocess:
    /health UP, a trace POSTed and read back, SIGTERM -> exit code 0;
(g1) durable boot in process: the resume adapter
    (zipkin_tpu_torch.storage.tpu.TorchStorage) with a checkpoint dir and a
    WAL dir takes phase e's payloads through the line-rate path, snapshots
    after payload 32 and crashes after payload 48; a new adapter on the same
    dirs restores and replays to the victim's leaves, wal_seq and reads, with
    one update_step launch per replayed device batch; a rotted newest
    generation falls back one generation to the same leaves; times the
    save, restore (and its crc share), replay and WAL append;
(g2) ``python -m zipkin_tpu_torch.server --resume-dir D`` as a subprocess:
    payloads, POST /api/v2/tpu/snapshot, more payloads, SIGKILL; restarted
    on D it replays its WAL (/metrics), answers the device-served routes
    as before the kill and every trace acked before it from D/archive;
    SIGTERM -> exit 0 with a new snapshot generation;
(h) the disk span archive: phase e's payloads through the line-rate path
    into TorchStorage(archive_dir) on the card (h1: leaves equal phase e's,
    every trace read back complete, queries and names equal phase e's host
    archive), a reopen after a crash that recovers the unsealed tail (h2),
    a rotted sealed segment quarantined by Scrubber.scan_once with later
    reads partial and never an error (h3), and retention under a small byte
    budget (h4); times the append, the reads, the recovery and the scan;
(i) the parse fan-out on phase e's payloads: the multi-process tier behind
    Collector(mp_ingester=...) with one worker and no coalescing (i1: every
    leaf equals phase e's, 64 update_step launches), with up to 4 workers
    coalescing 8 chunks a step (i2: launches equal the dispatcher's groups,
    fewer than 64; planes by name and reads equal i1's), over a WAL with a
    worker SIGKILLed (i3: no acked span lost, the replay equals the live
    leaves), behind the server with TPU_MP_WORKERS=2 (i4: 202s, 429s on a
    full tier, stop() drains before its final snapshot), and the threaded
    AsyncIngestFeeder (i5); times each against f1;
(j) the observability plane: f1's path with the plane on and off in
    pairs after a warm-up (j1: spans/s, each pair's ratio and their median,
    the plane's own host cost a payload, the device observatory's
    hll_update_step calls equal to the kernel's launches and its CUDA-event
    ms beside a2's), an in-process server with every plane on
    (j2: statusz's stage table, device, windows, SLO, accuracy and query
    sections, self-spans under a posted B3 trace, /prometheus), the same
    server over TPU_MP_WORKERS=2 (j3: relayed and mp_* stages, the workers'
    rows, the shadow's fused taps), the entry point's /prometheus (j4) and
    i2's fan-out tier with the plane on and off in pairs (j5). Phases a and a2 time the kernels with the device observatory off;
(k) the critical-path tracer, the read mirror and scale-out readers: i2's
    tier with the tracer on and off in pairs, every traced payload a
    stitched timeline whose segments sum to its wall, a SIGKILLed worker
    leaving no slot open (k1); one store fed at the line rate while 8
    threads read, the mirror off and on: read walls, zero lock
    acquisitions in mirror serves, the publish's lock hold, serve ages, and
    mirror answers equal to fresh reads once quiet (k2); an in-process
    server with a mirror segment and ``python -m zipkin_tpu_torch.serving``
    with 2 reader processes: answers equal the server's at one generation,
    503s on staleness, a miss served next epoch, a SIGKILLed reader
    respawned, no torch in a reader (k3); the entry point with the tier,
    the tracer and a segment: statusz's critpath, mirror and serving
    sections and their families (k4);
(l) admission: the mirror's repairs (l0: k2's memoized serves, a key that
    outgrows a 4 MiB segment left out while the rest serve from a reader
    process, a reader of an idle server serving past the staleness bound),
    the overload ladder under a paced client and an 8-client flood through
    a server with the tier (l1: each tick's level and top signal, sheds by
    class, every error-class payload admitted, Retry-After on every 429,
    read p99 by level, the seconds back to B0, every acked span read back),
    tenant budgets (l2: a tenant at 4x its budget shed alone, with scope
    tenant, while another at 0.5x and the global ladder are untouched),
    deadlines and the resume supervisor (l3: 504 on a spent budget; a
    supervised process trips, snapshots and exits 75, a relaunch restores
    every acked span and trace) and admission's cost on the line-rate path
    in on/off pairs with admit()'s own ns (l4);
(m) the shard mesh at the default AggConfig, 8 shards on one card (the
    reference's 8-device deployment laid onto the card): (c)'s traffic into
    an 8-shard and a 1-shard TorchAggregator, whose merges (sums, register
    max, the digests' recluster) must equal exactly where the reference's
    are exact and fall in the digest's rank band where they are not, with
    update_step launched 8 times a step and each shard's lanes held against
    the plain version (m1); (e)'s payloads into TorchStorage(mesh=[card] * 8)
    through the line-rate path and through the fan-out tier, every acked
    trace read back, the reads equal a 1-shard store's, an 8-shard snapshot
    restored by an 8-shard store and refused by a 1-shard one (m2); and the
    entry point with TPU_DEVICES=1 (serves) and one past the cards (refuses
    to start) (m3);
(n) the wire entry points at the default AggConfig on the card: (e)'s
    payloads in a replay log drained by TransportCollector(workers=4) into
    TorchStorage through the line-rate path (planes equal (e)'s, reads as
    the generator says, every trace read back, the marker at the end), a
    resume leg from the marker and a QueueSource leg at 1 and 4 workers
    (n1); (e)'s spans as scribe frames into a server with
    COLLECTOR_SCRIBE_ENABLED, every reply OK, equal to a store fed the
    decoded frames through accept, then stop() and a boot from the
    checkpoint (n2); the UI's routes on that server (n3); the entry point
    with scribe, and with gRPC (refused where grpc is missing) (n4); and
    the ZipkinMock test kit (n5).

Prints the card's name and power limit, the measurements, a ``kernels``
JSON line, and as its last line ``{"ok": true, "device": {...}}``. Exits
non-zero without a CUDA device, outside the repository, or when any
phase fails.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
QS = [0.5, 0.9, 0.99]
# a server's aggregate routes, asked for an exact answer: a default read may
# serve the last published mirror epoch while the server's ticker holds the
# aggregator lock (the mirror's contract; phase k measures it), and the
# checks of phases f-j hold the routes to the state just written
FRESH = {"staleness_ms": 0}


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int, torch) -> float:
    """Mean ms per call on the stream over calls ``fn(0..iters-1)`` after
    three warm-up calls ``fn(iters..iters+2)`` (CUDA events: includes any
    gap while the host enqueues the next call)."""
    for i in range(3):
        fn(iters + i)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def device_profile(fn, iters: int, torch, warm: bool = True):
    """(device-busy ms per call, [(kernel name, ms per call)], wall ms per
    call) from a torch.profiler trace of ``fn(0..iters-1)`` after one
    warm-up call ``fn(iters)``: the kernels' own time on the card, without
    the host's launch gaps."""
    from torch.profiler import ProfilerActivity, profile

    if warm:
        fn(iters)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(iters):
            fn(i)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / iters
    # device-side events only (kernels, memsets, copies): a host op's own
    # device time repeats the kernels it launched
    rows = [(e.key, _device_us(e) / 1e3 / iters) for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA")]
    rows = sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])
    return sum(r[1] for r in rows), rows, wall


def busy_ms(fn, iters: int, torch, reset=lambda: None):
    """Device-busy ms per call from the profiler; a trace that saw no
    device event is taken again (``reset`` runs before each try), and a
    third empty one raises."""
    for _ in range(3):
        reset()
        busy, rows, _ = device_profile(fn, iters, torch)
        if busy > 0:
            return busy, rows
    raise RuntimeError("the profiler saw no device time in three traces")


def time_calls(fn, reset, iters: int, torch):
    """(device ms, stream ms, profiled kernels) per call ``fn(i)``;
    ``reset`` restores the register files before each measurement."""
    dev, rows = busy_ms(fn, iters, torch, reset)
    reset()
    return dev, cuda_ms(fn, iters, torch), rows


def phase_kernels(seed: int, torch):
    """(a) HLL kernel vs plain version at [1025, 2048] and [4100, 2048],
    timed on fresh (zeroed) register files, where most valid lanes raise
    their register, and on filled ones, where none does."""
    from zipkin_tpu_torch.ops import hll_kernel

    dev = torch.device("cuda")
    lanes, m, iters = 65536, 2048, {"kernel": 100, "plain": 30, "library": 100}
    rng = np.random.default_rng(seed)
    cases = []
    for rows_n in (1025, 4100):
        batches = []
        for _ in range(8):
            rows = torch.from_numpy(rng.integers(0, rows_n, lanes, dtype=np.int32)).to(dev)
            # the kernel's hash form: the u32 bits as int32
            bits = rng.integers(0, 1 << 32, lanes, dtype=np.uint32).view(np.int32)
            valid = torch.from_numpy(rng.random(lanes) < 0.9).to(dev)
            batches.append((rows, torch.from_numpy(bits).to(dev), valid))
        regs_k = torch.zeros((rows_n, m), dtype=torch.uint8, device=dev)
        regs_p = regs_k.clone()
        for b in batches:
            hll_kernel.update(regs_k, *b)
            hll_kernel.update_plain(regs_p, *b)
        torch.cuda.synchronize()
        err = int((regs_k.int() - regs_p.int()).abs().max())
        if err != 0:
            raise AssertionError(f"hll kernel disagrees with plain at [{rows_n}, {m}]: {err}")
        filled = regs_k
        # the library yardstick: one scatter_reduce_(amax) over the flat
        # register index with rho precomputed
        lib_in, flat_ix = [], []
        for rows, bits, valid in batches:
            bucket, rho = hll_kernel.rho_of(bits, 11)
            flat_ix.append((rows.long() * m + bucket)[valid])
            lib_in.append((flat_ix[-1], rho[valid].to(torch.uint8)))
        lib = lambda regs, ix, rho: regs.view(-1).scatter_reduce_(0, ix, rho, "amax")
        fns = {"kernel": (hll_kernel.update, batches), "plain": (hll_kernel.update_plain, batches),
               "library": (lib, lib_in)}
        pool = [torch.zeros_like(filled) for _ in range(max(iters.values()) + 3)]

        def reset_pool():
            for r in pool:
                r.zero_()

        for state in ("fresh", "filled"):
            if state == "fresh":
                files, reset = pool, reset_pool
            else:
                files, reset = [filled] * len(pool), (lambda: None)
            got = {}
            for name, (fn, args) in fns.items():
                call = lambda i, fn=fn, args=args: fn(files[i], *args[i % len(args)])
                got[name] = time_calls(call, reset, iters[name], torch)
            log(f"profiled kernels, {state} [{rows_n}, {m}]: {got['kernel'][2]}")
            if state == "fresh":
                # each pool file holds one batch's update by one of the three
                # (the library's went last); a fresh kernel run must equal it
                for i in range(8):
                    want = pool[i].clone()
                    pool[i].zero_()
                    hll_kernel.update(pool[i], *batches[i])
                    if not torch.equal(pool[i], want):
                        raise AssertionError(f"hll kernel != scatter_reduce_ on a fresh file, batch {i}")
            elif not torch.equal(filled, regs_p):
                raise AssertionError(f"filled register file changed at [{rows_n}, {m}]")
            # bytes this run's data needs moved per call: each lane's row
            # (i32), hash bits (i32) and valid flag (1 B) read once; the
            # 4-byte word of each distinct register a valid lane names read
            # once; each word that rises written once
            start = torch.zeros_like(filled) if state == "fresh" else filled
            read_w, write_w = [], []
            for b, ix in zip(batches, flat_ix):
                after = hll_kernel.update(start.clone(), *b)
                read_w.append(torch.unique(ix // 4).numel())
                write_w.append(int((after.view(torch.int32) != start.view(torch.int32)).sum()))
            nbytes = lanes * 9 + 4 * (sum(read_w) + sum(write_w)) / len(batches)
            bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
            case = dict(shape=[rows_n, m], registers=state, lanes=lanes,
                        ms=got["kernel"][0], plain_ms=got["plain"][0], library_ms=got["library"][0],
                        stream_ms=got["kernel"][1], stream_plain_ms=got["plain"][1],
                        stream_library_ms=got["library"][1], bound_ms=bound_ms,
                        words_read=sum(read_w) / len(batches), words_written=sum(write_w) / len(batches),
                        max_abs_err=err)
            cases.append(case)
            log(f"hll_update {state} [{rows_n}, {m}] x {lanes} lanes, device busy per call (profiler): "
                f"kernel {case['ms']:.5f} ms, plain {case['plain_ms']:.5f} ms, scatter_reduce_ "
                f"{case['library_ms']:.5f} ms; per call on the stream (events): kernel "
                f"{case['stream_ms']:.5f} ms, plain {case['stream_plain_ms']:.5f} ms, scatter_reduce_ "
                f"{case['stream_library_ms']:.5f} ms; bound {bound_ms:.6f} ms "
                f"({case['words_read']:.0f} words read, {case['words_written']:.0f} written)")
        del pool
    hll_kernel.update.launches = 0
    return cases


def phase_step(torch, agg, traffic, chunk: int):
    """(a2, after c) the step's HLL update on the main path's own lanes:
    "fresh" is the first step's lanes on zeroed register files, "filled"
    the last step's lanes on the files (c) left after its 2**20 spans, so
    that none of them rises. Timed in turns on one card: the four
    single-target launches as the main path made them before the fused
    kernel (rows and masks precomputed, and once more with them built as
    that step built them), ``update_step`` (and on the same lanes with none
    live: the launch's floor), ``update_step_plain``, and two ``scatter_reduce_(amax)`` calls (one
    per file) on precomputed flat indices and rho. Every one of them must
    leave the registers that ``update_step_plain`` leaves."""
    from zipkin_tpu_torch import u32
    from zipkin_tpu_torch.ops import hll_kernel
    from zipkin_tpu_torch.parallel.aggregator import unfuse_columns
    from zipkin_tpu_torch.tpu import ingest as ing
    from zipkin_tpu_torch.tpu.columnar import fuse_columns
    from zipkin_tpu_torch.workload import slice_columns

    cfg, dev, st = agg.config, agg.device, agg.states[0]
    s_, r_, g_ = cfg.max_services, cfg.hll_rows, cfg.global_hll_row
    kw = dict(max_services=s_, hll_rows=r_, global_row=g_)
    step = 8 * chunk
    iters = dict(four=100, four_built=100, step=100, step_inert=100, plain=30, library=100)
    turns = ["four", "step", "four_built", "plain", "step_inert", "library", "four_built", "step", "four"]
    cases = []
    for state in ("fresh", "filled"):
        k = 0 if state == "fresh" else traffic.cols.size // step - 1
        image = fuse_columns(slice_columns(traffic.cols, k * step, (k + 1) * step))
        batch = unfuse_columns(u32.from_numpy(image, dev))
        if state == "fresh":
            start = (torch.zeros_like(st.hll), torch.zeros_like(st.tb_hll))
            epoch = torch.full_like(st.tb_epoch, -1)
        else:
            start, epoch = (st.hll.clone(), st.tb_hll.clone()), st.tb_epoch
        lanes, _, wipe = ing.hll_lanes(cfg, epoch, batch)
        start[1].masked_fill_(wipe[:, None, None], 0)
        start = (start[0], start[1].view(-1, start[1].shape[-1]))
        args = tuple(lanes[x] for x in ("hashes", "svc", "valid", "tb_keep", "slot"))
        h, svc, valid, keep, slot = args
        n = h.shape[0]
        # the same lanes with none live: what a launch costs that reads the
        # lanes and raises nothing
        inert = (h, svc, torch.zeros_like(valid), torch.zeros_like(keep), slot)

        def four_rows():
            """The row and mask vectors of the four calls, built as the
            step built them before the fused kernel."""
            svc_rows = torch.clamp(svc, 0, s_ - 1)
            named = svc > 0
            tt_rows = slot.to(torch.int32) * r_
            return [(0, svc_rows, valid & named), (0, torch.full_like(svc_rows, g_), valid),
                    (1, tt_rows + svc_rows, keep & named), (1, tt_rows + g_, keep)]

        four_args = four_rows()
        m = start[0].shape[1]
        bucket, rho = hll_kernel.rho_of(h, cfg.hll_precision)
        lib_in = [(torch.cat([(rows.long() * m + bucket)[mask] for ff, rows, mask in four_args if ff == f]),
                   torch.cat([rho[mask] for ff, rows, mask in four_args if ff == f]).to(torch.uint8))
                  for f in (0, 1)]

        def four(files, built=False):
            for which, rows, mask in (four_rows() if built else four_args):
                hll_kernel.update(files[which], rows, h, mask)

        fns = dict(
            four=four,
            four_built=lambda f: four(f, built=True),
            step=lambda f: hll_kernel.update_step(*f, *args, **kw),
            step_inert=lambda f: hll_kernel.update_step(*f, *inert, **kw),
            plain=lambda f: hll_kernel.update_step_plain(*f, *args, **kw),
            library=lambda f: [f[i].view(-1).scatter_reduce_(0, ix, rh, "amax")
                               for i, (ix, rh) in enumerate(lib_in)],
        )
        want = tuple(x.clone() for x in start)
        hll_kernel.update_step_plain(*want, *args, **kw)
        err = 0
        for name, fn in fns.items():
            got = tuple(x.clone() for x in start)
            fn(got)
            torch.cuda.synchronize()
            ref = start if name == "step_inert" else want
            err = max(err, max(int((a.int() - b.int()).abs().max()) for a, b in zip(got, ref)))
            if err:
                raise AssertionError(f"{name} != update_step_plain on the main path's lanes ({state}): {err}")
        # bytes this data needs moved: each lane's columns read once (11 B
        # in the fused form, 9 B per call in each of the four), one 4-byte
        # word read per distinct register word a live target names, one
        # written per word that rises
        words = sum(torch.unique(ix // 4).numel() for ix, _ in lib_in)
        written = sum(int((a.view(torch.int32) != b.view(torch.int32)).sum()) for a, b in zip(start, want))
        # the same at the card's access granularity, 32-byte sectors (shown
        # beside the bound, not in it: why a random 4-byte word costs more)
        sectors = sum(torch.unique(ix // 32).numel() for ix, _ in lib_in)
        sectors_written = sum(int((a.view(torch.int64).view(-1, 4) != b.view(torch.int64).view(-1, 4))
                                  .any(1).sum()) for a, b in zip(start, want))
        if state == "filled":
            # time on the files after this step's update: nothing rises
            log(f"the last step's lanes raise {written} words of the files phase c left")
            start, written, sectors_written = want, 0, 0
            files = [want] * (max(iters.values()) + 3)
            snapshot = tuple(x.clone() for x in want)
            reset = lambda: None
        else:
            files = [tuple(torch.zeros_like(x) for x in start) for _ in range(max(iters.values()) + 3)]

            def reset():
                for pair in files:
                    for x in pair:
                        x.zero_()
        lane_bytes = n * sum(t.element_size() for t in args)
        bound_ms = (lane_bytes + 4 * (words + written)) / HBM_BYTES_PER_S * 1e3
        bound_four_ms = (4 * 9 * n + 4 * (words + written)) / HBM_BYTES_PER_S * 1e3
        sector_ms = (lane_bytes + 32 * (sectors + sectors_written)) / HBM_BYTES_PER_S * 1e3
        got = {name: [] for name in fns}
        for name in turns:
            fn = fns[name]
            got[name].append(time_calls(lambda i, fn=fn: fn(files[i]), reset, iters[name], torch))
        if state == "filled" and not all(torch.equal(a, b) for a, b in zip(want, snapshot)):
            raise AssertionError("a filled register file changed")
        dev_ms = {name: [t[0] for t in v] for name, v in got.items()}
        stream_ms = {name: [t[1] for t in v] for name, v in got.items()}
        mean = lambda xs: sum(xs) / len(xs)
        case = dict(registers=state, lanes=n, lane_bytes=lane_bytes, ms=mean(dev_ms["step"]),
                    four_launch_ms=mean(dev_ms["four"]), four_built_ms=mean(dev_ms["four_built"]),
                    inert_ms=mean(dev_ms["step_inert"]),
                    plain_ms=mean(dev_ms["plain"]), library_ms=mean(dev_ms["library"]),
                    bound_ms=bound_ms, four_launch_bound_ms=bound_four_ms,
                    words_read=words, words_written=written, max_abs_err=err,
                    sectors_read=sectors, sectors_written=sectors_written, sector_bytes_ms=sector_ms,
                    turns=dev_ms, stream_ms=stream_ms)
        cases.append(case)
        log(f"hll step, {state} files, main path's lanes ({n}, {lane_bytes} B of lane columns), "
            f"device busy per step (profiler), in turns {turns}: "
            + json.dumps({k2: [round(x, 6) for x in v] for k2, v in dev_ms.items()}))
        log(f"hll step, {state}: update_step {case['ms']:.5f} ms, "
            f"no live lane {case['inert_ms']:.5f} ms, four launches "
            f"{case['four_launch_ms']:.5f} ms "
            f"(with their row/mask ops {case['four_built_ms']:.5f} ms), plain {case['plain_ms']:.5f} ms, "
            f"scatter_reduce_ x2 {case['library_ms']:.5f} ms; bound {bound_ms:.6f} ms fused, "
            f"{bound_four_ms:.6f} ms as four calls ({words} words read, {written} written; in 32-byte "
            f"sectors {sectors} read, {sectors_written} written: {sector_ms:.6f} ms); per step on "
            f"the stream (events): " + json.dumps({k2: round(mean(v), 5) for k2, v in stream_ms.items()}))
        log(f"profiled kernels, {state}, update_step: {got['step'][0][2]}")
        del files
    return cases


def step_parts(cols, lo: int, hi: int, chunk: int, cfg, n_shards: int = 1):
    """The ``chunk``-span wire images of lanes ``[lo, hi)`` (identity id
    maps), each routed across ``n_shards`` as a parse worker routes its
    chunk, and the step's counts, as ``ingest_fused_multi`` takes them."""
    from zipkin_tpu_torch.tpu.columnar import route_fused
    from zipkin_tpu_torch.workload import slice_columns

    ident_svc = np.arange(1 << 16, dtype=np.uint32)
    ident_key = np.arange(cfg.max_keys, dtype=np.uint32)
    parts = [(route_fused(slice_columns(cols, a, min(a + chunk, hi)), n_shards), ident_svc, ident_key)
             for a in range(lo, hi, chunk)]
    v = cols.valid[lo:hi]
    ts = cols.ts_min[lo:hi][v]
    return parts, (int(v.sum()), int((v & cols.has_dur[lo:hi]).sum()),
                   int((v & cols.err[lo:hi]).sum()), (int(ts.min()), int(ts.max())))


def drive(agg, traffic, step_spans: int, chunk: int, cfg, after=None) -> list:
    """Deliver ``traffic`` in coalesced steps of ``step_spans`` spans cut
    into ``chunk``-span images; returns the wall ms of each step.
    ``after(i)`` runs after step ``i``, outside its wall."""
    cols = traffic.cols
    walls = []
    for i, lo in enumerate(range(0, cols.size, step_spans)):
        parts, counts = step_parts(cols, lo, min(lo + step_spans, cols.size), chunk, cfg,
                                   agg.n_shards)
        t0 = time.perf_counter()
        agg.ingest_fused_multi(parts, *counts)
        agg.block_until_ready()
        walls.append((time.perf_counter() - t0) * 1e3)
        if after is not None:
            after(i)
    return walls


def counted(agg, fn):
    """(fn(), readpack transfers it made, read_stats["host_transfers"] it
    added)."""
    from zipkin_tpu_torch import readpack

    t0, r0 = readpack.transfer_count(), agg.read_stats["host_transfers"]
    out = fn()
    return out, readpack.transfer_count() - t0, agg.read_stats["host_transfers"] - r0


def one_transfer(agg, fn, what: str):
    """fn() on the card, which must make exactly one counted transfer."""
    out, n, r = counted(agg, fn)
    if (n, r) != (1, 1):
        raise AssertionError(f"{what}: {n} transfers ({r} counted by read_stats), want 1")
    return out


class WalLog:
    """A WAL hook that keeps every record as bytes and can pass the
    explicit flush/rollup markers on to another aggregator (replay)."""

    def __init__(self, replay_to=None):
        self.records = []
        self.replay_to = replay_to
        self.replay_ms = 0.0  # host wall spent replaying markers

    def __call__(self, fused, n_spans, n_dur, n_err, ts_range, extra=None):
        f = np.ascontiguousarray(fused, np.uint32)
        self.records.append((f.shape, f.tobytes(), n_spans, n_dur, n_err,
                             None if ts_range is None else tuple(int(x) for x in ts_range),
                             None if extra is None else sorted(extra.items())))
        if self.replay_to is not None and extra:
            t0 = time.perf_counter()
            if "ttflush" in extra:
                self.replay_to.flush_now()
            if "ttroll" in extra:
                self.replay_to.rollup_now()
            self.replay_to.block_until_ready()
            self.replay_ms += (time.perf_counter() - t0) * 1e3
        return len(self.records)


class TimedSampler:
    """A HostSampler whose per-batch calls (verdict, observe, compaction)
    are timed on the host clock; keeps the last batch's verdicts."""

    def __init__(self, inner):
        self.inner = inner
        self.ms = 0.0
        self.last_keep = None

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def _timed(self, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        self.ms += (time.perf_counter() - t0) * 1e3
        return out

    def verdict_fused(self, fused):
        self.last_keep = self._timed(self.inner.verdict_fused, fused)
        return self.last_keep

    def observe(self, fused, keep):
        return self._timed(self.inner.observe, fused, keep)

    def compact_fused(self, fused, keep):
        return self._timed(self.inner.compact_fused, fused, keep)


def assert_parts_equal(got, want, what: str) -> None:
    """Time-tier parts or window answers: (epochs|None, regs, digest,
    calls, errs); digest weights exact, means rtol 1e-5."""
    for name, g, w in zip(("epochs", "hll", "digest", "calls", "errs"), got, want):
        if g is None:
            continue
        if name == "digest":
            np.testing.assert_array_equal(g[..., 1], w[..., 1], err_msg=f"{what} digest weights")
            np.testing.assert_allclose(g[..., 0], w[..., 0], rtol=1e-5, err_msg=f"{what} digest")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {name}")


def window_parts(ans):
    return (None, ans.hll, ans.digest, ans.calls, ans.errs)


def phase_gpu_vs_cpu(seed: int, torch) -> None:
    """(b) the card's path against the CPU path at a small config."""
    from zipkin_tpu_torch import convert
    from zipkin_tpu_torch.parallel.aggregator import TorchAggregator
    from zipkin_tpu_torch.tpu.state import AggConfig, AggState
    from zipkin_tpu_torch.workload import BASE_MINUTE, generate

    cfg = AggConfig(max_services=16, max_keys=64, hll_precision=6, digest_centroids=8,
                    digest_buffer=512, ring_capacity=2048, link_buckets=4, bucket_minutes=10,
                    hist_slices=3, hist_slice_minutes=5, time_buckets=4,
                    time_bucket_minutes=3, time_digest_centroids=4)
    traffic = generate(8192, seed=seed, services=12, names_per_service=4, minutes=40)
    gpu, cpu = TorchAggregator(cfg), TorchAggregator(cfg, device="cpu")
    drive(gpu, traffic, 256, 64, cfg)
    drive(cpu, traffic, 256, 64, cfg)
    assert gpu.ctx_stats["ctx_advances"] >= 6, gpu.ctx_stats
    windows = [(0, (1 << 32) - 1), (BASE_MINUTE, BASE_MINUTE + 6), (BASE_MINUTE + 30, BASE_MINUTE + 45)]
    for source in ("hist", "digest"):
        (gq, gn), (cq, cn) = gpu.quantiles(QS, source), cpu.quantiles(QS, source)
        np.testing.assert_allclose(gq, cq, rtol=1e-5)
        np.testing.assert_array_equal(gn, cn)
    np.testing.assert_allclose(gpu.cardinalities(), cpu.cardinalities(), rtol=1e-6)
    for lo, hi in windows:
        for g, c in zip(gpu.dependency_edges(lo, hi), cpu.dependency_edges(lo, hi)):
            np.testing.assert_array_equal(g, c)
        np.testing.assert_array_equal(gpu.windowed_histograms(lo, hi), cpu.windowed_histograms(lo, hi))
    # digests: weights exact; means rtol 1e-5 (float atomics sum in a
    # run-dependent order on the card)
    for name, g, c in zip(AggState._fields, convert.state_to_numpy(gpu.states),
                          convert.state_to_numpy(cpu.states)):
        if name in ("digest", "tb_digest"):
            np.testing.assert_array_equal(g[..., 1], c[..., 1], err_msg=name)
            np.testing.assert_allclose(g[..., 0], c[..., 0], rtol=1e-5, err_msg=name)
        else:
            np.testing.assert_array_equal(g, c, err_msg=name)
    log(f"phase b: card == CPU over {len(AggState._fields)} leaves and every read "
        f"({gpu.ctx_stats['ctx_advances']} rollups, {traffic.cols.size} spans, ring {cfg.ring_capacity})")
    phase_sampled_small(seed, torch, cfg, traffic)


def phase_sampled_small(seed: int, torch, cfg, traffic) -> None:
    """(b, sampled) card and CPU with sampling on, the same tables
    published twice mid-stream, a WAL hook and a TimeTier sealing after
    every step; every read on the card makes one transfer."""
    import dataclasses
    import tempfile

    from zipkin_tpu_torch import convert
    from zipkin_tpu_torch.parallel.aggregator import TorchAggregator
    from zipkin_tpu_torch.sampling import RATE_ONE, HostSampler
    from zipkin_tpu_torch.tpu.state import AggState
    from zipkin_tpu_torch.tpu.timetier import TimeTier

    cfg = dataclasses.replace(cfg, sampling=True)
    rng = np.random.default_rng(seed + 1)
    with tempfile.TemporaryDirectory() as tmp:
        gpu, cpu = TorchAggregator(cfg), TorchAggregator(cfg, device="cpu")
        tiers = {}
        for name, agg in (("gpu", gpu), ("cpu", cpu)):
            agg.sampler = HostSampler(cfg.max_services, cfg.max_keys, cfg.sample_rare_min)
            agg.wal_hook = WalLog()
            tiers[name] = TimeTier(cfg, directory=f"{tmp}/{name}")
        steps = traffic.cols.size // 256
        publish_at = {steps // 3, 2 * steps // 3}
        seals = []

        def after(i, agg, name):
            seals.append(tiers[name].seal_up_to(agg))
            if i in publish_at:
                # the same tables on both: seeded rates below RATE_ONE, tail
                # cuts from the CPU's digest (the card reads it too, so both
                # flush here), link counts from the CPU's host sampler
                if name == "gpu":
                    one_transfer(gpu, lambda: gpu.quantiles([0.9], "digest"), "publish quantiles")
                else:
                    q, n = cpu.quantiles([0.9], "digest")
                    tail = np.full(cfg.max_keys, 0xFFFFFFFF, np.uint32)
                    tail[n > 0] = np.ceil(np.maximum(q[n > 0, 0], 1.0)).astype(np.uint32)
                    rate = rng.integers(RATE_ONE // 8, RATE_ONE // 2, cfg.max_services, dtype=np.uint32)
                    tables[i] = (rate, tail, cpu.sampler.link_snapshot())
                rate, tail, link = tables[i]
                agg.sampler.set_tables(rate, tail, link)
                agg.set_sampler_tables(rate, tail, link)

        tables = {}  # step -> the tables published after it
        # the CPU runs first so that its tables exist when the card publishes
        drive(cpu, traffic, 256, 64, cfg, after=lambda i: after(i, cpu, "cpu"))
        drive(gpu, traffic, 256, 64, cfg, after=lambda i: after(i, gpu, "gpu"))
        np.testing.assert_array_equal(gpu.sampler.link_snapshot(), cpu.sampler.link_snapshot())
        for name, g, c in zip(AggState._fields, convert.state_to_numpy(gpu.states),
                              convert.state_to_numpy(cpu.states)):
            if name in ("digest", "tb_digest"):
                np.testing.assert_array_equal(g[..., 1], c[..., 1], err_msg=name)
                np.testing.assert_allclose(g[..., 0], c[..., 0], rtol=1e-5, err_msg=name)
            else:
                np.testing.assert_array_equal(g, c, err_msg=f"sampled {name}")
        assert gpu.host_counters == cpu.host_counters and gpu.host_counters["sampledDropped"] > 0
        if gpu.wal_hook.records != cpu.wal_hook.records:
            raise AssertionError("WAL-hook records differ between the card and the CPU")
        tg, tc = tiers["gpu"], tiers["cpu"]
        assert tg.sealed_through == tc.sealed_through and tg.counters["ttSeals"] == tc.counters["ttSeals"] > 5
        top, sealed = gpu.tt_max_epoch, tg.sealed_through
        for lo, hi in ((top - 3, top), (top, top), (top - 1, top - 1), (0, (1 << 31) - 1)):
            g = one_transfer(gpu, lambda: gpu.tt_read(lo, hi), "tt_read")
            assert_parts_equal(g, cpu.tt_read(lo, hi), f"tt_read({lo}, {hi})")
        first = min(tg._fine)
        for lo, hi in ((first, sealed), (sealed - 1, top), (top, top), (first - 5, first + 1)):
            g, n, _ = counted(gpu, lambda: tg.window(gpu, lo, hi))
            if n != (1 if hi > sealed else 0):
                raise AssertionError(f"window {lo}-{hi}: {n} transfers")
            c = tc.window(cpu, lo, hi)
            assert (g.covered, g.missing, g.unsealed) == (c.covered, c.missing, c.unsealed)
            assert_parts_equal(window_parts(g), window_parts(c), f"window {lo}-{hi}")
        reads = {
            "quantiles": lambda a: a.quantiles(QS, "digest"),
            "hist_quantiles": lambda a: a.quantiles(QS, "hist"),
            "cardinalities": lambda a: a.cardinalities(),
            "sketch_overview": lambda a: a.sketch_overview(QS),
            "merged_sketches": lambda a: a.merged_sketches(),
            "merged_digest": lambda a: a.merged_digest(),
            "edges": lambda a: a.dependency_edges(0, (1 << 32) - 1),
        }
        for name, fn in reads.items():
            g = one_transfer(gpu, lambda: fn(gpu), name)
            c = fn(cpu)
            for x, y in zip(g if isinstance(g, tuple) else (g,), c if isinstance(c, tuple) else (c,)):
                if x.dtype == np.float32:
                    np.testing.assert_allclose(x, y, rtol=1e-5, err_msg=name)
                else:
                    np.testing.assert_array_equal(x, y, err_msg=name)
    log(f"phase b, sampled: card == CPU over every leaf (r_keep, counters 5/6 "
        f"{gpu.host_counters['sampledKept']}/{gpu.host_counters['sampledDropped']}), "
        f"{len(gpu.wal_hook.records)} WAL records byte-equal, {tg.counters['ttSeals']} seals, "
        f"tt_read and window answers equal; one transfer per read on the card")


def median_ms(fn, reps: int = 5) -> float:
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        walls.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(walls)


def phase_main(seed: int, n_spans: int, torch, cfg=None, chunk: int = 8192, device=None):
    """(c) the main path (default AggConfig, 8 chunks of ``chunk`` spans
    per step, on the card unless ``device`` says otherwise); returns the
    kernel launches of the run by wrapper, the aggregator and the traffic."""
    from zipkin_tpu_torch.ops import hll_kernel, tdigest
    from zipkin_tpu_torch.parallel.aggregator import TorchAggregator
    from zipkin_tpu_torch.tpu.state import CTR_BATCHES, CTR_ERRORS, CTR_SPANS, AggConfig, state_bytes
    from zipkin_tpu_torch.workload import BASE_MINUTE, generate

    cfg = cfg or AggConfig()
    traffic = generate(n_spans, seed=seed)
    cols = traffic.cols
    agg = TorchAggregator(cfg, device=device)
    agg.block_until_ready()
    log(f"state: {state_bytes(agg.states[0]) / 2**30:.3f} GiB on {agg.device} for {cfg}")

    hll_kernel.update.launches = hll_kernel.update_step.launches = 0
    walls = drive(agg, traffic, 8 * chunk, chunk, cfg)
    launches = {"update": hll_kernel.update.launches, "update_step": hll_kernel.update_step.launches}
    steps = len(walls)
    if launches != {"update": 0, "update_step": steps}:
        raise AssertionError(f"hll kernel launches over {steps} steps: {launches}, "
                             f"want update_step once a step and update never")
    log(f"ingest: {n_spans} spans in {steps} steps, {n_spans / (sum(walls) / 1e3):.0f} spans/s "
        f"(first step {walls[0]:.1f} ms, median step {statistics.median(walls):.2f} ms); "
        f"{agg.ctx_stats['ctx_advances']} rollups; step walls ms {[round(w, 2) for w in walls]}")

    # --- reads, timed (median wall of a few, each ending in a host copy)
    reads = {}
    t0 = time.perf_counter()
    (dq, dn), *first_transfers = counted(agg, lambda: agg.quantiles(QS, "digest"))  # flush-then-read
    reads["digest_quantiles_first_ms"] = (time.perf_counter() - t0) * 1e3
    reads["digest_quantiles_ms"] = median_ms(lambda: agg.quantiles(QS, "digest"))
    reads["hist_quantiles_ms"] = median_ms(lambda: agg.quantiles(QS, "hist"))
    win = (BASE_MINUTE, BASE_MINUTE + 60)
    reads["windowed_quantiles_ms"] = median_ms(lambda: agg.quantiles(QS, ts_lo_min=win[0], ts_hi_min=win[1]))
    reads["cardinalities_ms"] = median_ms(agg.cardinalities)
    reads["sketch_overview_ms"] = median_ms(lambda: agg.sketch_overview(QS))
    full = (0, (1 << 32) - 1)
    t0 = time.perf_counter()
    _, *fresh_transfers = counted(agg, lambda: agg.dependency_edges(*full))
    reads["edges_fresh_ms"] = (time.perf_counter() - t0) * 1e3
    reads["edges_cached_ms"] = median_ms(lambda: agg.dependency_edges(*full))
    old = (BASE_MINUTE, BASE_MINUTE + 2)
    if not agg.window_fully_rolled(*old):
        raise AssertionError("the earliest minutes should have left the ring")
    reads["edges_rolled_only_ms"] = median_ms(lambda: agg.dependency_edges(*old))
    log("read wall ms: " + json.dumps({k: round(v, 4) for k, v in reads.items()}))
    # transfers each read makes: one packed buffer, counted at the chokepoint
    read_fns = {
        "digest_quantiles": lambda: agg.quantiles(QS, "digest"),
        "hist_quantiles": lambda: agg.quantiles(QS, "hist"),
        "windowed_quantiles": lambda: agg.quantiles(QS, ts_lo_min=win[0], ts_hi_min=win[1]),
        "cardinalities": agg.cardinalities,
        "sketch_overview": lambda: agg.sketch_overview(QS),
        "merged_digest": agg.merged_digest,
        "merged_sketches": agg.merged_sketches,
        "windowed_histograms": lambda: agg.windowed_histograms(*win),
        "dependency_matrices": lambda: agg.dependency_matrices(*full),
        "edges_cached": lambda: agg.dependency_edges(*full),
        "edges_rolled_only": lambda: agg.dependency_edges(*old),
    }
    transfers = {"digest_quantiles_flush_first": tuple(first_transfers),
                 "edges_fresh": tuple(fresh_transfers)}
    transfers.update({name: counted(agg, fn)[1:] for name, fn in read_fns.items()})
    log("transfers per read (readpack, read_stats): " + json.dumps(transfers))
    if any(t != (1, 1) for t in transfers.values()):
        raise AssertionError(f"a read made other than one transfer: {transfers}")

    # --- checks against the generator -------------------------------------
    ctr = agg.states[0].counters.cpu().numpy()
    want_err = int((cols.valid & cols.err).sum())
    assert ctr[CTR_SPANS] == n_spans and ctr[CTR_ERRORS] == want_err and ctr[CTR_BATCHES] == steps, ctr
    assert agg.host_counters["spans"] == n_spans and agg.host_counters["spansWithError"] == want_err
    key_counts = np.bincount(cols.key[cols.valid], minlength=cfg.max_keys)
    hq, hn = agg.quantiles(QS, "hist")
    np.testing.assert_array_equal(hn, key_counts)
    np.testing.assert_array_equal(dn, key_counts)
    if not np.isfinite(dq).all() or not np.isfinite(hq).all():
        raise AssertionError("non-finite quantiles")

    # cardinality: global within 3 sigma; per service within 4 sigma with
    # the RMS relative error within 1.5 sigma (200 services at 3 sigma each
    # would fail by chance about one run in three)
    est = agg.cardinalities()
    sig = 1.04 / math.sqrt(1 << cfg.hll_precision)
    pairs = np.unique(np.stack([cols.svc.astype(np.int64), cols.trace_h.astype(np.int64)], 1), axis=0)
    true = np.bincount(pairs[:, 0], minlength=cfg.hll_rows).astype(np.float64)
    true[cfg.global_hll_row] = len(np.unique(cols.trace_h))
    seen = true > 0
    rel = np.abs(est[seen] - true[seen]) / true[seen]
    g_rel = abs(est[-1] - true[-1]) / true[-1]
    if g_rel > 3 * sig or rel.max() > 4 * sig or math.sqrt((rel ** 2).mean()) > 1.5 * sig:
        raise AssertionError(f"cardinality off: global {g_rel:.4f}, max {rel.max():.4f}, sigma {sig:.4f}")

    # digest p99 inside the digest's own rank resolution: between the exact
    # quantiles at 0.99 -/+ cluster_q_width (the bound obs/accuracy.py uses)
    w = tdigest.cluster_q_width(cfg.digest_centroids, 0.99)
    order = np.argsort(cols.key, kind="stable")
    starts = np.searchsorted(cols.key[order], np.arange(cfg.max_keys + 1))
    big = np.nonzero(key_counts >= 1000)[0]
    rel_p99 = []
    for k in big:
        v = np.sort(cols.dur[order[starts[k]:starts[k + 1]]].astype(np.float64))
        lo_v, ex, hi_v = np.quantile(v, [0.99 - w, 0.99, min(0.99 + w, 1.0)])
        got = dq[k, QS.index(0.99)]
        if not lo_v <= got <= hi_v:
            raise AssertionError(f"key {k}: digest p99 {got} outside [{lo_v}, {hi_v}]")
        rel_p99.append(abs(got - ex) / ex)
    log(f"digest p99 vs exact over {len(big)} keys with >= 1000 points: all inside the "
        f"rank band +-{w:.4f}; relative value error median {statistics.median(rel_p99):.4f}, "
        f"max {max(rel_p99):.4f}")

    # every generated caller -> callee edge with its exact counts
    calls, errors = agg.dependency_matrices(*full)
    s = cfg.max_services
    want_calls = np.zeros((s, s), np.int64)
    want_errs = np.zeros((s, s), np.int64)
    for (a, b), (c, e) in traffic.edges.items():
        want_calls[a, b], want_errs[a, b] = c, e
    np.testing.assert_array_equal(calls, want_calls)
    np.testing.assert_array_equal(errors, want_errs)
    idx, ec, ee = agg.dependency_edges(*full)
    live = ec > 0
    np.testing.assert_array_equal(ec[live], calls.reshape(-1)[idx[live]])
    np.testing.assert_array_equal(ee[live], errors.reshape(-1)[idx[live]])
    r_idx, r_calls, _ = agg.dependency_edges(*old)
    rl = r_calls > 0
    if not rl.any() or (r_calls[rl] > calls.reshape(-1)[r_idx[rl]]).any():
        raise AssertionError("rolled-only edges empty or above the full counts")
    log(f"edges: {len(traffic.edges)} generated caller->callee edges exact; "
        f"{int(live.sum())} returned by the compacted read; rolled-only read {int(rl.sum())} edges")
    if agg.device.type == "cuda":
        profile_steps(agg, traffic, chunk, cfg, torch)
    peak = torch.cuda.max_memory_allocated() / 2**30 if agg.device.type == "cuda" else float("nan")
    log(f"read stats: {json.dumps(agg.read_stats)}; peak device memory {peak:.3f} GiB")
    return launches, agg, traffic


def profile_steps(agg, traffic, chunk: int, cfg, torch) -> None:
    """Where a step's time goes: four more steps (the first 4 x 8 chunks
    of the traffic again, after every check) under the profiler — wall,
    device-busy share and the costliest device ops."""
    from zipkin_tpu_torch.workload import slice_columns

    sub = type(traffic)(cols=slice_columns(traffic.cols, 0, 4 * 8 * chunk), edges={})
    busy, rows, wall = device_profile(lambda i: drive(agg, sub, 8 * chunk, chunk, cfg), 1, torch,
                                      warm=False)
    log(f"profiled 4 steps: wall {wall:.1f} ms (profiler on), device busy {busy:.1f} ms "
        f"({100 * busy / wall:.1f}% of wall)")
    log("top device ops over those steps (ms): " + json.dumps(
        [[k[:60], round(v, 3)] for k, v in rows[:12]]))


def np_registers(cols, mask, cfg) -> np.ndarray:
    """The HLL register file ([S+1, m] u8) that the lanes in ``mask``
    raise, in numpy: per-service rows for named services, the global row
    for all (the rules of zipkin_tpu/ops/hll.py:update)."""
    from zipkin_tpu_torch.tpu.columnar import _mix32

    p = cfg.hll_precision
    h = _mix32(cols.trace_h[mask]).astype(np.int64)
    bucket = h >> (32 - p)
    rest = h & ((1 << (32 - p)) - 1)
    rho = np.where(rest == 0, 33 - p, (32 - p) - np.floor(np.log2(np.maximum(rest, 1))).astype(np.int64))
    regs = np.zeros((cfg.hll_rows, 1 << p), np.uint8)
    svc = cols.svc[mask].astype(np.int64)
    named = svc > 0
    rows = np.clip(svc, 0, cfg.max_services - 1)
    np.maximum.at(regs, (rows[named], bucket[named]), rho[named].astype(np.uint8))
    np.maximum.at(regs, (np.full(bucket.shape, cfg.global_hll_row), bucket), rho.astype(np.uint8))
    return regs


def check_window(ans, cols, epochs, cfg, what: str) -> None:
    """A window answer (or one sealed segment) against the generator's
    lanes whose bucket epoch is in ``epochs`` (none: an empty segment): HLL
    registers exact, digest weight per key = span count, calls/errors =
    client lanes with a remote service."""
    ep = cols.ts_min.astype(np.int64) // cfg.time_bucket_minutes
    mask = cols.valid & np.isin(ep, list(epochs))
    np.testing.assert_array_equal(ans.hll, np_registers(cols, mask, cfg), err_msg=f"{what} hll")
    want_w = np.bincount(cols.key[mask & cols.has_dur], minlength=cfg.max_keys)
    got_w = ans.digest[..., 1].astype(np.float64).sum(-1)
    np.testing.assert_array_equal(got_w, want_w, err_msg=f"{what} digest weights")
    s = cfg.max_services
    client = mask & (cols.rsvc > 0)
    flat = cols.svc[client].astype(np.int64) * s + cols.rsvc[client]
    want_c = np.bincount(flat, minlength=s * s).reshape(s, s)
    want_e = np.bincount(flat, weights=cols.err[client], minlength=s * s).reshape(s, s)
    np.testing.assert_array_equal(np.asarray(ans.calls, np.int64), want_c, err_msg=f"{what} calls")
    np.testing.assert_array_equal(np.asarray(ans.errs, np.int64), want_e.astype(np.int64),
                                  err_msg=f"{what} errors")


def phase_sampled(seed: int, n_spans: int, torch, card: str, cfg=None, chunk: int = 8192) -> dict:
    """(d) the default AggConfig with sampling on, through the same traffic
    as (c): a RateController ticking every 4 steps at a quarter of the
    span rate and a TimeTier sealing after every step. An unsampled twin
    takes the same steps and replays the run's explicit flushes and
    rollups from its WAL markers (the sealer's and the controller's
    flush-then-read move where digest points fold), so its sketches must
    equal the sampled run's. ``cfg`` (sampling on) defaults to the
    default AggConfig. Returns the figures."""
    import dataclasses
    import gc
    import tempfile
    import types

    from zipkin_tpu_torch.ops import hll_kernel
    from zipkin_tpu_torch.parallel.aggregator import TorchAggregator
    from zipkin_tpu_torch.sampling import HostSampler, RateController
    from zipkin_tpu_torch.tpu.state import CTR_SAMPLED_DROPPED, CTR_SAMPLED_KEPT, AggConfig, AggState
    from zipkin_tpu_torch.tpu.timetier import TimeTier
    from zipkin_tpu_torch.workload import generate

    cfg = cfg or AggConfig(sampling=True)
    traffic = generate(n_spans, seed=seed)
    cols = traffic.cols
    step = 8 * chunk
    twin = TorchAggregator(dataclasses.replace(cfg, sampling=False))
    agg = TorchAggregator(cfg)
    agg.sampler = sampler = TimedSampler(HostSampler(cfg.max_services, cfg.max_keys, cfg.sample_rare_min))
    agg.wal_hook = WalLog(replay_to=twin)
    # one synthetic second per 4 steps; the budget keeps a quarter of them
    ctl = RateController(types.SimpleNamespace(agg=agg), budget_spans_per_sec=0.25 * 4 * step)
    fig = dict(step_ms=[], sampler_ms=[], seal_ms=[], tick_ms=[], seals=[], launches=[], kept=[],
               persist_ms=[], tick_tail_ms=[], tick_publish_ms=[], tick_gc=[])

    def timed(fn, key):
        """``fn`` with its host wall appended to ``fig[key]``, less the
        twin's replayed flushes inside it."""
        def run(*a, **k):
            replay0, t0 = agg.wal_hook.replay_ms, time.perf_counter()
            out = fn(*a, **k)
            fig[key].append((time.perf_counter() - t0) * 1e3 - (agg.wal_hook.replay_ms - replay0))
            return out
        return run

    # the interpreter's garbage-collector pauses, so that a tick or seal
    # that pays one says so: (generation, ms) each
    gc_pauses = []

    def gc_watch(phase, info, start=[0.0]):
        if phase == "start":
            start[0] = time.perf_counter()
        else:
            gc_pauses.append((info["generation"], (time.perf_counter() - start[0]) * 1e3))

    # the tick's two halves: the tail cuts (a digest quantile read, which
    # flushes first) and the publish (sctl diff, WAL record, table swap)
    ctl._tail_thresholds = timed(ctl._tail_thresholds, "tick_tail_ms")
    ctl._publish = timed(ctl._publish, "tick_publish_ms")
    r = cfg.ring_capacity
    hll_kernel.update.launches = 0
    gc.callbacks.append(gc_watch)
    with tempfile.TemporaryDirectory() as tmp:
        tier = TimeTier(cfg, directory=tmp)
        tier._persist = timed(tier._persist, "persist_ms")  # npz + fsync + manifest
        for i, lo in enumerate(range(0, cols.size, step)):
            parts, counts = step_parts(cols, lo, min(lo + step, cols.size), chunk, cfg)
            cursor = int(agg._shard_cursor[0])
            sampler.ms = 0.0
            hll_kernel.update_step.launches = 0
            t0 = time.perf_counter()
            agg.ingest_fused_multi(parts, *counts)
            agg.block_until_ready()
            fig["step_ms"].append((time.perf_counter() - t0) * 1e3)
            fig["launches"].append(hll_kernel.update_step.launches)
            fig["sampler_ms"].append(sampler.ms)
            twin.ingest_fused_multi(parts, *counts)
            # the ring's new lanes hold the host verdicts of the step's live
            # lanes, in order, under the tables the step read
            hi = min(lo + step, cols.size)
            keep = sampler.last_keep[0][:hi - lo][cols.valid[lo:hi]]
            pos = torch.from_numpy((cursor + np.arange(keep.size)) % r).to(agg.device)
            got = agg.states[0].r_keep[pos].cpu().numpy()
            if not np.array_equal(got, keep):
                raise AssertionError(f"step {i}: r_keep != HostSampler.verdict_fused "
                                     f"({int((got != keep).sum())} lanes)")
            fig["kept"].append(int(keep.sum()) / keep.size)
            # seal and tick walls leave out the twin's replayed flushes
            replay0, t0 = agg.wal_hook.replay_ms, time.perf_counter()
            fig["seals"].append(tier.seal_up_to(agg))
            fig["seal_ms"].append((time.perf_counter() - t0) * 1e3 - (agg.wal_hook.replay_ms - replay0))
            if i % 4 == 3:
                replay0, t0, gc0 = agg.wal_hook.replay_ms, time.perf_counter(), len(gc_pauses)
                ctl.tick(1.0)
                fig["tick_gc"].append(gc_pauses[gc0:])
                fig["tick_ms"].append((time.perf_counter() - t0) * 1e3 - (agg.wal_hook.replay_ms - replay0))
        steps = len(fig["step_ms"])
        fig["update_launches"] = hll_kernel.update.launches
        if fig["launches"] != [1] * steps or hll_kernel.update.launches:
            raise AssertionError(f"update_step launches per sampled step: {fig['launches']}, "
                                 f"update {hll_kernel.update.launches}")
        ctr = agg.states[0].counters.cpu().numpy()
        hc = agg.host_counters
        if (ctr[CTR_SAMPLED_KEPT], ctr[CTR_SAMPLED_DROPPED]) != (hc["sampledKept"], hc["sampledDropped"]):
            raise AssertionError(f"counters 5/6 {ctr[5:7]} != host tallies {hc}")
        if not 0 < hc["sampledDropped"] < n_spans or ctl.publishes != steps // 4:
            raise AssertionError(f"verdicts did not vary: {hc}, {ctl.publishes} publishes")
        # sampling gates retention, never the sketches
        skip = {"r_keep", "counters", "s_rate", "s_tail", "s_link"}
        for name, a, b in zip(AggState._fields, agg.states[0], twin.states[0]):
            if name in skip:
                continue
            if name in ("digest", "tb_digest"):
                same = torch.equal(a[..., 1], b[..., 1]) and torch.allclose(a[..., 0], b[..., 0],
                                                                         rtol=1e-5, atol=0)
            else:
                same = torch.equal(a, b)
            if not same:
                raise AssertionError(f"sampled leaf {name} != the unsampled twin's")
        agg.wal_hook.replay_to = None
        del twin

        top, sealed = agg.tt_max_epoch, tier.sealed_through
        gen_epochs = set((cols.ts_min[cols.valid].astype(np.int64) // cfg.time_bucket_minutes).tolist())
        first = min(gen_epochs)
        if sealed != top - 1 or not gen_epochs - {top} <= set(tier._fine) or len(gen_epochs) < 4:
            raise AssertionError(f"sealed {sorted(tier._fine)}, generated {sorted(gen_epochs)}, top {top}")
        for e in sorted(tier._fine):
            check_window(tier._fine[e], cols, [e], cfg, f"sealed epoch {e}")
        win_sealed, win_mixed = (first, first + 2), (sealed - 1, top)
        for lo, hi in (win_sealed, win_mixed):
            ans, n, _ = counted(agg, lambda: tier.window(agg, lo, hi))
            if n != (1 if hi > sealed else 0):
                raise AssertionError(f"window {lo}-{hi}: {n} transfers")
            check_window(ans, cols, range(lo, hi + 1), cfg, f"window {lo}-{hi}")
        fig["transfers"] = {
            "tt_read_seal": counted(agg, lambda: agg.tt_read(sealed, sealed))[1:],
            "window_sealed_only": counted(agg, lambda: tier.window(agg, *win_sealed))[1:],
            "window_mixed": counted(agg, lambda: tier.window(agg, *win_mixed))[1:],
        }
        fig["tt_read_ms"] = median_ms(lambda: agg.tt_read(sealed, sealed))
        fig["window_sealed_only_ms"] = median_ms(lambda: tier.window(agg, *win_sealed))
        fig["window_mixed_ms"] = median_ms(lambda: tier.window(agg, *win_mixed))
    gc.callbacks.remove(gc_watch)
    fig["gc_pauses_over_1ms"] = [(g, round(ms, 2)) for g, ms in gc_pauses if ms > 1.0]
    fig.update(steps=steps, spans_per_s=n_spans / (sum(fig["step_ms"]) / 1e3),
               sampled_kept=hc["sampledKept"], sampled_dropped=hc["sampledDropped"],
               rate_min=int(agg.sampler.rate.min()), rate_mean=float(agg.sampler.rate.mean()),
               sealed_epochs=sorted(tier._fine), card=card)
    log(f"phase d ({card}): {n_spans} spans in {steps} sampled steps, {fig['spans_per_s']:.0f} spans/s "
        f"(median step {statistics.median(fig['step_ms']):.2f} ms); host sampler per step median "
        f"{statistics.median(fig['sampler_ms']):.3f} ms; kept {hc['sampledKept']}, dropped "
        f"{hc['sampledDropped']}; kept share per step {[round(k, 4) for k in fig['kept']]}; "
        f"rates min {fig['rate_min']}, mean {fig['rate_mean']:.0f} of 65536 after {ctl.publishes} ticks")
    log(f"phase d ({card}): tt_read seal read {fig['tt_read_ms']:.3f} ms; window sealed-only "
        f"{fig['window_sealed_only_ms']:.3f} ms, mixed {fig['window_mixed_ms']:.3f} ms; controller tick ms "
        f"{[round(t, 2) for t in fig['tick_ms']]} (tail cuts {[round(t, 2) for t in fig['tick_tail_ms']]}, "
        f"publish {[round(t, 2) for t in fig['tick_publish_ms']]}; garbage-collector ms in each tick "
        f"{[round(sum(ms for _, ms in t), 2) for t in fig['tick_gc']]}); seals per step {fig['seals']} "
        f"(seal ms {[round(t, 2) for t in fig['seal_ms']]}; of which segment persist "
        f"{[round(t, 2) for t in fig['persist_ms']]}); transfers {json.dumps(fig['transfers'])}")
    log(f"phase d: step walls ms {[round(w, 2) for w in fig['step_ms']]}; host sampler ms "
        f"{[round(w, 3) for w in fig['sampler_ms']]}; sealed epochs {fig['sealed_epochs']} and windows "
        f"{win_sealed}, {win_mixed} equal the generator's HLL registers, key counts and edges; "
        f"garbage-collector pauses over 1 ms in phase d (generation, ms): {fig['gc_pauses_over_1ms']}")
    return fig


def store_truth(traffic, cfg):
    """What the generator knows, by name, for the store-level checks: the
    sorted durations of each (service, span name), every caller -> callee
    edge with its counts, distinct traces per service, and a query window
    (epoch ms) past the last span."""
    import types

    from zipkin_tpu_torch.workload import BASE_MINUTE, service_name, span_name

    cols = traffic.cols
    svc_of = lambda i: service_name(int(i))  # noqa: E731
    key_name = lambda k: (svc_of(k // traffic.names_per_service), span_name(traffic, int(k)))  # noqa: E731
    trace64 = (cols.tl1.astype(np.uint64) << np.uint64(32)) | cols.tl0
    order = np.argsort(cols.key, kind="stable")
    bounds = np.searchsorted(cols.key[order], np.arange(cfg.max_keys + 1))
    pairs = np.unique(np.stack([cols.svc.astype(np.uint64), trace64], 1), axis=0)
    return types.SimpleNamespace(
        cols=cols, cfg=cfg, svc_of=svc_of, key_name=key_name,
        t_end=(BASE_MINUTE + 60) * 60_000, lookback=2 * 60 * 60_000,
        key_durs={key_name(k): np.sort(cols.dur[order[bounds[k]:bounds[k + 1]]].astype(np.float64))
                  for k in np.nonzero(np.diff(bounds))[0]},
        edges={(svc_of(a), svc_of(b)): ce for (a, b), ce in traffic.edges.items()},
        cards={svc_of(s): n for s, n in zip(*np.unique(pairs[:, 0], return_counts=True))},
        n_traces=len(np.unique(trace64)),
    )


def link_map(links):
    return {(x.parent, x.child): (x.call_count, x.error_count) for x in links}


def check_store_answers(store, agg, truth, spans, traces, what: str, per_trace: int = 8,
                        archived=None) -> dict:
    """The store's answers (or an adapter over its HTTP routes) against
    the generator: ``traces`` (trace indices) read back span for span,
    every edge exact, cardinalities within phase c's HLL band, histogram
    quantiles inside the log2 buckets of the bracketing order statistics
    (1/32 of an octave), digest p99s inside the digest's rank band for keys
    with >= 1000 points, the overview equal to the reads it coalesces,
    service and span names: those of ``archived`` (the spans the archive
    holds) when given, else every generated one. Returns the figures."""
    from zipkin_tpu_torch.model import json_v2
    from zipkin_tpu_torch.ops import tdigest
    from zipkin_tpu_torch.ops.histogram import SUB

    cfg, key_durs = truth.cfg, truth.key_durs
    fig = {}
    # 1. traces: every span as the generator rendered it
    for t in traces:
        want = sorted(json_v2.encode_span(s) for s in spans[t * per_trace:(t + 1) * per_trace])
        got = sorted(json_v2.encode_span(s) for s in store.get_trace(spans[t * per_trace].trace_id).execute())
        if got != want:
            raise AssertionError(f"{what}: get_trace({spans[t * per_trace].trace_id}) != the generated spans")

    # 2. dependencies over the whole window: every edge, exact counts (the
    # first read builds the link context: one transfer)
    t0 = time.perf_counter()
    deps, *first = counted(agg, lambda: store.get_dependencies(truth.t_end, truth.lookback).execute())
    fig["dependencies_first_ms"] = (time.perf_counter() - t0) * 1e3
    if tuple(first) != (1, 1) or link_map(deps) != truth.edges:
        raise AssertionError(f"{what}: get_dependencies: {len(deps)} links != {len(truth.edges)} "
                             f"generated, transfers {first}")

    # 3. cardinalities within phase c's HLL band
    est = store.trace_cardinalities()
    sig = 1.04 / math.sqrt(1 << cfg.hll_precision)
    rel = np.array([abs(est[name] - n) / n for name, n in truth.cards.items()])
    g_rel = abs(est["_global"] - truth.n_traces) / truth.n_traces
    if set(est) != set(truth.cards) | {"_global"} or g_rel > 3 * sig or rel.max() > 4 * sig \
            or math.sqrt((rel ** 2).mean()) > 1.5 * sig:
        raise AssertionError(f"{what}: cardinality off: global {g_rel:.4f}, max {rel.max():.4f}, "
                             f"sigma {sig:.4f}")

    # 4. percentile rows: counts exact, quantiles inside their bounds
    w99 = tdigest.cluster_q_width(cfg.digest_centroids, 0.99)

    def check_rows(rows, kind, digest):
        if {(r["serviceName"], r["spanName"]) for r in rows} != set(key_durs):
            raise AssertionError(f"{what}: {kind}: rows {len(rows)} != keys {len(key_durs)}")
        checked = 0
        for r in rows:
            v = key_durs[(r["serviceName"], r["spanName"])]
            n = len(v)
            if r["count"] != n:
                raise AssertionError(f"{what}: {kind}: count {r['count']} != {n} for "
                                     f"{r['serviceName']}/{r['spanName']}")
            for q, got in r["quantiles"].items():
                if digest:
                    if q != 0.99 or n < 1000:
                        continue
                    lo_v, hi_v = np.quantile(v, [0.99 - w99, min(0.99 + w99, 1.0)])
                else:
                    rank = math.ceil(q * n)
                    lo_v = v[max(0, rank - 2)] * (1 - 1 / SUB)
                    hi_v = v[min(n - 1, rank)] * (1 + 1 / SUB)
                if not lo_v <= got <= hi_v:
                    raise AssertionError(f"{what}: {kind}: q{q} {got} outside [{lo_v}, {hi_v}]")
                checked += 1
        return checked

    fig["hist_checked"] = check_rows(store.latency_quantiles(QS, use_digest=False), "hist rows", False)
    fig["digest_checked"] = check_rows(store.latency_quantiles(QS), "digest rows", True)
    overview = store.sketch_overview(QS)
    check_rows(overview["percentiles"], "overview rows", True)
    if overview["cardinalities"] != est or overview["counters"]["spans"] != len(spans):
        raise AssertionError(f"{what}: sketch_overview disagrees with the reads it coalesces")

    # 5. names, which the archive answers
    pairs = set(key_durs) if archived is None else {(s.local_service_name, s.name) for s in archived}
    names = store.get_service_names().execute()
    if names != sorted({svc for svc, _ in pairs}):
        raise AssertionError(f"{what}: service names: {len(names)} != {len({svc for svc, _ in pairs})}")
    for name in names[:8]:
        want = sorted({s for (svc, s) in pairs if svc == name})
        if store.get_span_names(name).execute() != want:
            raise AssertionError(f"{what}: span names of {name}")
    fig.update(traces=len(traces), edges=len(truth.edges), names=len(names), keys=len(key_durs),
               hll_global_rel=g_rel, hll_max_rel=float(rel.max()), hll_sigma=sig)
    return fig


def phase_store(seed: int, n_spans: int, torch, card: str, cfg=None, per_payload: int = 4096,
                services: int = 60, device=None) -> dict:
    """(e) the storage SPI's object path at the default AggConfig: the
    traffic rendered as Span objects and encoded as payloads of
    ``per_payload`` spans, JSON v2 and proto3 by turns; each payload goes
    through ``codec.decode_spans`` -> ``span_consumer().accept(...)`` of a
    TorchStorage on the card. Then every store read is checked against what
    the generator knows, before and after ``tt_seal()``, with its transfers
    and its wall. ``services`` keeps the whole window's edges (3,522 at 2**18
    spans) inside the store's 4,096-edge compaction, so each dependency read
    is one device read. Returns the figures, with the payloads, the traffic,
    its spans and the state leaves right after ingest (phase f feeds the
    same payloads)."""
    import types

    from zipkin_tpu_torch.model import codec
    from zipkin_tpu_torch.ops import hll_kernel
    from zipkin_tpu_torch.tpu import store as store_mod
    from zipkin_tpu_torch.tpu.state import AggConfig
    from zipkin_tpu_torch.tpu.store import TorchStorage
    from zipkin_tpu_torch.workload import generate, payloads, render_spans

    cfg = cfg or AggConfig()
    t0 = time.perf_counter()
    traffic = generate(n_spans, seed=seed + 7, services=services)
    cols = traffic.cols
    spans = render_spans(traffic)
    wire = payloads(spans, per_payload)
    setup_s = time.perf_counter() - t0
    store = TorchStorage(config=cfg, device=device)
    store._deps_max_stale_ms = 0.0  # no cached answer hides a write
    agg = store.agg
    fig = dict(card=card, spans=n_spans, payloads=len(wire), setup_s=setup_s,
               stage_ms={"decode": 0.0, "pack_spans": 0.0, "archive_write": 0.0, "device_step": 0.0})
    stage = fig["stage_ms"]
    batches = []

    def timed(fn, name, sync=False):
        def run(*a, **k):
            t = time.perf_counter()
            out = fn(*a, **k)
            if sync:  # the step's device time belongs to the step
                agg.block_until_ready()
            stage[name] += (time.perf_counter() - t) * 1e3
            return out
        return run

    def count_batch(c):
        batches.append(int(c.valid.sum()))
        return ingest(c)

    ingest = timed(agg.ingest, "device_step", sync=True)
    agg.ingest = count_batch
    archive_accept = store._archive.accept

    def timed_archive(kept):
        # the archive's work runs in the Call's execute()
        return types.SimpleNamespace(execute=timed(archive_accept(kept).execute, "archive_write"))

    store._archive.accept = timed_archive
    pack = store_mod.pack_spans
    store_mod.pack_spans = timed(pack, "pack_spans")
    try:
        hll_kernel.update.launches = hll_kernel.update_step.launches = 0
        t0 = time.perf_counter()
        for p in wire:
            t = time.perf_counter()
            got = codec.decode_spans(p)
            stage["decode"] += (time.perf_counter() - t) * 1e3
            store.span_consumer().accept(got).execute()
        agg.block_until_ready()
        wall_ms = (time.perf_counter() - t0) * 1e3
        launches = {"update": hll_kernel.update.launches, "update_step": hll_kernel.update_step.launches}
    finally:
        store_mod.pack_spans = pack
        del agg.ingest
        del store._archive.accept
    if sum(batches) != n_spans:
        raise AssertionError(f"device batches carried {sum(batches)} spans, want {n_spans}")
    if launches["update"] or launches["update_step"] != len(batches) or not batches:
        raise AssertionError(f"hll launches {launches} over {len(batches)} device batches")
    # the leaves as ingest left them (a digest read flushes into them); the
    # host archive, which holds every span, is phase h's query oracle
    fig.update(wire=wire, traffic=traffic, spans=spans, state=agg.state_arrays(),
               archive=store._archive)
    fig.update(device_batches=len(batches), launches=launches["update_step"],
               update_launches=launches["update"], wall_ms=wall_ms,
               spans_per_s=n_spans / (wall_ms / 1e3),
               stage_spans_per_s={k: n_spans / (v / 1e3) for k, v in stage.items()})
    log(f"phase e ({card}): {n_spans} spans in {len(wire)} payloads (JSON v2 and proto3 by turns, "
        f"rendered in {setup_s:.1f} s) through decode_spans -> accept: {fig['spans_per_s']:.0f} spans/s "
        f"end to end ({wall_ms:.0f} ms); per stage ms {json.dumps({k: round(v, 1) for k, v in stage.items()})}"
        f", spans/s {json.dumps({k: round(v) for k, v in fig['stage_spans_per_s'].items()})}; "
        f"{len(batches)} device batches, update_step launches {launches['update_step']}, "
        f"update {launches['update']}")

    truth = store_truth(traffic, cfg)
    t_end, lookback, key_name = truth.t_end, truth.lookback, truth.key_name

    def fresh(fn):
        """``fn`` after dropping the store's caches: what a first read pays
        (the aggregator's link context stays built)."""
        def run():
            store.invalidate_read_cache()
            return fn()
        return run

    def measure(reads, want_transfers):
        """Transfers of each read from a dropped cache, then its wall (median
        of 5) from a dropped cache and served by the cache."""
        transfers = {name: counted(agg, fresh(fn))[1:] for name, fn in reads.items()}
        if transfers != {name: want_transfers for name in reads}:
            raise AssertionError(f"transfers per read {transfers}, want {want_transfers} each")
        fig["transfers"].update(transfers)
        fig["read_ms"].update({name: median_ms(fresh(fn)) for name, fn in reads.items()})
        fig["read_cached_ms"].update({name: median_ms(fn) for name, fn in reads.items()})

    fig.update(transfers={}, read_ms={}, read_cached_ms={})

    # 1-5. 64 sampled traces, edges, cardinalities, percentile rows, names
    rng = np.random.default_rng(seed)
    checked = check_store_answers(store, agg, truth, spans, rng.choice(n_spans // 8, 64, replace=False),
                                  "phase e")
    fig["read_ms"]["dependencies_first"] = checked.pop("dependencies_first_ms")

    # 7a. the ring's reads: one transfer each
    measure({
        "digest_quantiles": lambda: store.latency_quantiles(QS),
        "hist_quantiles": lambda: store.latency_quantiles(QS, use_digest=False),
        "windowed_hist_quantiles": lambda: store.latency_quantiles(
            QS, use_digest=False, end_ts=t_end, lookback=lookback),
        "cardinalities": lambda: store.trace_cardinalities(),
        "sketch_overview": lambda: store.sketch_overview(QS),
        "dependencies": lambda: store.get_dependencies(t_end, lookback).execute(),
        # the device read under the last one, without the store's link shaping
        "aggregator_dependency_edges": lambda: agg.dependency_edges(
            (t_end - lookback) // 60_000, t_end // 60_000),
    }, (1, 1))

    # 6. seal, then windows over sealed buckets and through the unsealed one
    g = cfg.time_bucket_minutes
    t0 = time.perf_counter()
    sealed_n = store.tt_seal()
    fig["tt_seal_ms"] = (time.perf_counter() - t0) * 1e3
    sealed, top = store.timetier.sealed_through, agg.tt_max_epoch
    if sealed != top - 1 or sealed_n < 2:
        raise AssertionError(f"tt_seal sealed {sealed_n}, through {sealed}, top {top}")
    ep = cols.ts_min.astype(np.int64) // g
    svc_of = truth.svc_of

    def window(lo_ep, hi_ep):
        """(end_ts, lookback) in epoch ms covering buckets lo_ep..hi_ep."""
        end = (hi_ep * g + g - 1) * 60_000 + 30_000
        return end, end - lo_ep * g * 60_000 - 30_000

    def check_window(lo_ep, hi_ep, what):
        end_ts, lb = window(lo_ep, hi_ep)
        mask = (ep >= lo_ep) & (ep <= hi_ep)
        want = np.bincount(cols.key[mask], minlength=cfg.max_keys)
        got = {(r["serviceName"], r["spanName"]): r
               for r in store.latency_quantiles(QS, end_ts=end_ts, lookback=lb)}
        for k in np.nonzero(want)[0]:
            r = got.pop(key_name(k))
            qv = list(r["quantiles"].values())
            if r["count"] != want[k] or not np.isfinite(qv).all() or qv != sorted(qv):
                raise AssertionError(f"{what}: key {k} row {r}, want count {want[k]}")
        if got:
            raise AssertionError(f"{what}: {len(got)} rows past the generator's keys")
        client = mask & (cols.rsvc > 0)
        flat = cols.svc[client].astype(np.int64) * cfg.max_services + cols.rsvc[client]
        uniq, inv = np.unique(flat, return_inverse=True)
        calls = np.bincount(inv)
        errs = np.bincount(inv, weights=cols.err[client])
        want_e = {(svc_of(f // cfg.max_services), svc_of(f % cfg.max_services)): (int(c), int(e))
                  for f, c, e in zip(uniq, calls, errs)}
        if link_map(store.get_dependencies(end_ts, lb).execute()) != want_e:
            raise AssertionError(f"{what}: windowed dependencies != the generator's")
        return end_ts, lb

    s_end, s_lb = check_window(sealed - 1, sealed, "sealed window")
    m_end, m_lb = check_window(sealed, top, "mixed window")

    # 7b. a window of sealed buckets reads no device; one through the
    # unsealed bucket reads it once
    measure({
        "sealed_quantiles": lambda: store.latency_quantiles(QS, end_ts=s_end, lookback=s_lb),
        "sealed_dependencies": lambda: store.get_dependencies(s_end, s_lb).execute(),
        "sealed_cardinalities": lambda: store.trace_cardinalities(end_ts=s_end, lookback=s_lb),
    }, (0, 0))
    measure({
        "mixed_quantiles": lambda: store.latency_quantiles(QS, end_ts=m_end, lookback=m_lb),
        "mixed_dependencies": lambda: store.get_dependencies(m_end, m_lb).execute(),
        "mixed_cardinalities": lambda: store.trace_cardinalities(end_ts=m_end, lookback=m_lb),
    }, (1, 1))
    fig["get_trace_ms"] = median_ms(lambda: store.get_trace(spans[0].trace_id).execute())
    fig["service_names_ms"] = median_ms(lambda: store.get_service_names().execute())
    fig.update(sealed=sealed_n, hist_checked=checked["hist_checked"],
               digest_checked=checked["digest_checked"], edges=checked["edges"])
    log(f"phase e: transfers per store read (readpack, read_stats): {json.dumps(fig['transfers'])}")
    log(f"phase e ({card}): store read wall ms, median of 5 from a dropped cache: "
        + json.dumps({k: round(v, 3) for k, v in fig["read_ms"].items()})
        + "; served by the cache: " + json.dumps({k: round(v, 4) for k, v in fig["read_cached_ms"].items()})
        + f"; get_trace {fig['get_trace_ms']:.3f} ms, get_service_names {fig['service_names_ms']:.1f} ms, "
        f"tt_seal {fig['tt_seal_ms']:.1f} ms")
    log(f"phase e: 64 traces equal the generated spans; {checked['edges']} edges exact; cardinalities "
        f"within the HLL band (global {checked['hll_global_rel']:.4f}, max {checked['hll_max_rel']:.4f}, "
        f"sigma {checked['hll_sigma']:.4f}); {checked['hist_checked']} histogram and "
        f"{checked['digest_checked']} digest quantiles inside their bounds over {checked['keys']} keys; "
        f"{checked['names']} service names; {sealed_n} epochs sealed, sealed and mixed windows exact")
    return fig


def assert_leaves_equal(got, want, what: str) -> None:
    """State leaves of two runs over the same batches: integer leaves bit
    for bit; digest weights exact, means rtol 1e-5 (float atomics sum in a
    run-dependent order on the card)."""
    from zipkin_tpu_torch.tpu.state import AggState

    for name, g, w in zip(AggState._fields, got, want):
        if name in ("digest", "tb_digest"):
            np.testing.assert_array_equal(g[..., 1], w[..., 1], err_msg=f"{what} {name} weights")
            np.testing.assert_allclose(g[..., 0], w[..., 0], rtol=1e-5, err_msg=f"{what} {name}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {name}")


def sampled_traces(traffic, every: int = 64, per_trace: int = 8):
    """Indices of the traces the fast path's 1/``every`` archive sample
    keeps (the store's rule: fmix32 of the id's xor-folded lanes)."""
    from zipkin_tpu_torch.tpu.columnar import _mix32

    c = traffic.cols
    first = np.arange(0, c.size, per_trace)
    return np.nonzero(_mix32(c.tl0[first] ^ c.tl1[first]) % np.uint32(every) == 0)[0]


def phase_fast(seed: int, torch, card: str, stored: dict, cfg=None, device=None) -> dict:
    """(f1) the line-rate path: phase e's payloads through
    ``Collector(store, fast_ingest=True).accept_spans_bytes`` into a fresh
    TorchStorage on the card. The native parser must take every payload;
    the state leaves must equal phase e's; update_step launches once per
    device batch; the reads answer as the generator says, trace reads for
    the 1/64 sample. Times parse + intern, ``pack_parsed``, the archive
    sample and the device step (with a sync)."""
    from zipkin_tpu_torch import native
    from zipkin_tpu_torch.collector import Collector
    from zipkin_tpu_torch.ops import hll_kernel
    from zipkin_tpu_torch.tpu import store as store_mod
    from zipkin_tpu_torch.tpu.state import AggConfig
    from zipkin_tpu_torch.tpu.store import TorchStorage

    if not native.available():
        raise AssertionError("phase f: the native parser did not build")
    cfg = cfg or AggConfig()
    wire, traffic, spans = stored["wire"], stored["traffic"], stored["spans"]
    n_spans = len(spans)
    store = TorchStorage(config=cfg, device=device)
    store._deps_max_stale_ms = 0.0
    agg = store.agg
    stage = {"fast_parse": 0.0, "pack_parsed": 0.0, "archive_sample": 0.0, "device_step": 0.0}
    batches, results = [], []

    def timed(fn, name, sync=False):
        def run(*a, **k):
            t = time.perf_counter()
            out = fn(*a, **k)
            if sync:
                agg.block_until_ready()
            stage[name] += (time.perf_counter() - t) * 1e3
            return out
        return run

    def count_batch(c):
        batches.append(int(c.valid.sum()))
        return ingest(c)

    def recorded(data, sampler=None):
        results.append(fast(data, sampler))
        return results[-1]

    ingest = timed(agg.ingest, "device_step", sync=True)
    agg.ingest = count_batch
    fast = store.ingest_json_fast
    store.ingest_json_fast = recorded
    store._fast_parse = timed(store._fast_parse, "fast_parse")
    store._archive_fast_sample = timed(store._archive_fast_sample, "archive_sample")
    pack = store_mod.pack_parsed
    store_mod.pack_parsed = timed(pack, "pack_parsed")
    collector = Collector(store, fast_ingest=True)
    try:
        hll_kernel.update.launches = hll_kernel.update_step.launches = 0
        t0 = time.perf_counter()
        for p in wire:
            collector.accept_spans_bytes(p)
        agg.block_until_ready()
        wall_ms = (time.perf_counter() - t0) * 1e3
        launches = {"update": hll_kernel.update.launches, "update_step": hll_kernel.update_step.launches}
    finally:
        store_mod.pack_parsed = pack
        del agg.ingest, store.ingest_json_fast, store._fast_parse, store._archive_fast_sample
    # the parse + intern stage is _fast_parse without its pack_parsed calls
    stage["parse_intern"] = stage.pop("fast_parse") - stage["pack_parsed"]
    if len(results) != len(wire) or None in results or sum(a for a, _ in results) != n_spans:
        raise AssertionError(f"phase f: the native path refused or dropped a payload: {results}")
    if sum(batches) != n_spans:
        raise AssertionError(f"phase f: device batches carried {sum(batches)} spans, want {n_spans}")
    if launches["update"] or launches["update_step"] != len(batches):
        raise AssertionError(f"phase f: hll launches {launches} over {len(batches)} device batches")
    assert_leaves_equal(agg.state_arrays(), stored["state"], "phase f vs phase e")
    if agg.host_counters["spans"] != n_spans:
        raise AssertionError(f"phase f: host counters {agg.host_counters}")

    truth = store_truth(traffic, cfg)
    picked = sampled_traces(traffic)
    if store._archive.span_count != 8 * len(picked):
        raise AssertionError(f"phase f: archive holds {store._archive.span_count} spans, "
                             f"want the 1/64 sample's {8 * len(picked)}")
    rng = np.random.default_rng(seed)
    archived = [s for t in picked for s in spans[8 * t:8 * t + 8]]
    checked = check_store_answers(store, agg, truth, spans,
                                  rng.choice(picked, min(64, len(picked)), replace=False), "phase f1",
                                  archived=archived)
    fig = dict(card=card, spans=n_spans, payloads=len(wire), wall_ms=wall_ms,
               spans_per_s=n_spans / (wall_ms / 1e3), stage_ms=stage,
               stage_spans_per_s={k: n_spans / (v / 1e3) for k, v in stage.items()},
               device_batches=len(batches), launches=launches["update_step"],
               update_launches=launches["update"], archived_traces=len(picked), **checked)
    log(f"phase f1 ({card}): {n_spans} spans in {len(wire)} payloads through Collector(fast_ingest) -> "
        f"ingest_json_fast: {fig['spans_per_s']:.0f} spans/s end to end ({wall_ms:.0f} ms; phase e "
        f"{stored['spans_per_s']:.0f}); per stage ms {json.dumps({k: round(v, 1) for k, v in stage.items()})}"
        f", spans/s {json.dumps({k: round(v) for k, v in fig['stage_spans_per_s'].items()})}; "
        f"{len(batches)} device batches, update_step launches {launches['update_step']}, update "
        f"{launches['update']}; every payload parsed natively; state leaves equal phase e's")
    log(f"phase f1: {len(picked)} traces archived (1/64), {checked['traces']} read back exact; "
        f"{checked['edges']} edges exact; cardinalities within the HLL band (global "
        f"{checked['hll_global_rel']:.4f}, max {checked['hll_max_rel']:.4f}); {checked['hist_checked']} "
        f"histogram and {checked['digest_checked']} digest quantiles inside their bounds; "
        f"{checked['names']} service names; first dependency read {checked['dependencies_first_ms']:.1f} ms")
    return fig


class HttpStore:
    """The store-shaped view of a server's HTTP routes, for
    :func:`check_store_answers`: each call is one GET, decoded to the
    port's model objects."""

    def __init__(self, base: str) -> None:
        self.base = base

    def get(self, path: str, params=None, want=200):
        import urllib.error
        import urllib.parse
        import urllib.request

        url = self.base + path + ("?" + urllib.parse.urlencode(params) if params else "")
        try:
            with urllib.request.urlopen(url, timeout=120) as resp:
                status, body = resp.status, resp.read()
        except urllib.error.HTTPError as e:
            status, body = e.code, e.read()
        if status != want:
            raise AssertionError(f"GET {path} {params}: {status} {body[:200]!r}, want {want}")
        return json.loads(body) if body and status == 200 else body

    @staticmethod
    def _call(value):
        import types

        return types.SimpleNamespace(execute=lambda: value)

    @staticmethod
    def _rows(rows):
        return [{**r, "quantiles": {float(q): v for q, v in r["quantiles"].items()}} for r in rows]

    def get_trace(self, trace_id):
        from zipkin_tpu_torch.model import json_v2

        return self._call([json_v2.span_from_dict(d) for d in self.get(f"/api/v2/trace/{trace_id}")])

    def get_dependencies(self, end_ts, lookback):
        from zipkin_tpu_torch.model import json_v2

        body = self.get("/api/v2/dependencies", {"endTs": end_ts, "lookback": lookback, **FRESH})
        return self._call(json_v2.decode_link_list(json.dumps(body).encode()))

    def trace_cardinalities(self):
        return self.get("/api/v2/tpu/cardinalities", FRESH)

    def latency_quantiles(self, qs, use_digest=True):
        return self._rows(self.get("/api/v2/tpu/percentiles", {
            "q": ",".join(map(str, qs)), "sketch": "digest" if use_digest else "hist", **FRESH}))

    def sketch_overview(self, qs):
        body = self.get("/api/v2/tpu/overview", {"q": ",".join(map(str, qs)), **FRESH})
        return {**body, "percentiles": self._rows(body["percentiles"])}

    def get_service_names(self):
        return self._call(self.get("/api/v2/services"))

    def get_span_names(self, service):
        return self._call(self.get("/api/v2/spans", {"serviceName": service}))


def small_trace(tid: int, service: str, ts_us: int):
    """A client/server pair of one trace (ids chosen by the caller)."""
    from zipkin_tpu_torch.model.span import Endpoint, Kind, Span

    front, back = Endpoint.create(service), Endpoint.create(f"{service}-db")
    t = f"{tid:016x}"
    return [Span.create(t, "1", name="get", kind=Kind.CLIENT, timestamp=ts_us, duration=900,
                        local_endpoint=front, remote_endpoint=back),
            Span.create(t, "1", name="get", kind=Kind.SERVER, timestamp=ts_us + 10, duration=700,
                        local_endpoint=back, shared=True, tags={"env": "smoke"})]


def archived_ids(n: int, every: int = 64):
    """``n`` 64-bit trace ids above the generator's that the 1/``every``
    archive sample keeps."""
    from zipkin_tpu_torch.tpu.columnar import _mix32

    out, tid = [], 1 << 62
    while len(out) < n:
        tid += 1
        if int(_mix32(np.array([(tid & 0xFFFFFFFF) ^ (tid >> 32)], np.uint32))[0]) % every == 0:
            out.append(tid)
    return out


def phase_server(seed: int, torch, card: str, stored: dict, cfg=None, device=None) -> dict:
    """(f2) the server in-process: ZipkinServer with STORAGE_TYPE=tpu and
    TPU_FAST_INGEST=1 on 127.0.0.1 (ephemeral port), its TorchStorage
    built on the card by build_storage. 4 threads POST phase e's payloads
    over urllib; then a gzip, a protobuf, a v1 JSON, a malformed body
    (400) and a gzip bomb (413). Every ported route is read, checked
    against the generator and against the store's direct answer, and
    timed (median of 5). ``device`` other than None builds the store
    there instead (a rehearsal off the card)."""
    import concurrent.futures
    import dataclasses
    import gzip
    import urllib.error
    import urllib.request
    import zlib

    from zipkin_tpu_torch.model import json_v1, json_v2, proto3
    from zipkin_tpu_torch.ops import hll_kernel
    from zipkin_tpu_torch.server.app import ZipkinServer
    from zipkin_tpu_torch.server.config import ServerConfig
    from zipkin_tpu_torch.tpu.state import AggConfig

    cfg = cfg or AggConfig()
    wire, traffic, spans = stored["wire"], stored["traffic"], stored["spans"]
    n_spans = len(spans)
    config = ServerConfig(host="127.0.0.1", port=0, storage_type="tpu", tpu_fast_ingest=True,
                          tpu_deps_max_stale_ms=0.0, autocomplete_keys=("env",),
                          obs_shadow_enabled=False, tpu_agg=dataclasses.asdict(cfg))
    # no seal and no accuracy rollup on the ticker here: their device reads
    # would mix into the counted transfers of the checks (phase f3 runs the
    # entry point with them, phase j2 checks them)
    storage = None
    if device is not None:  # a rehearsal off the card
        from zipkin_tpu_torch.tpu.store import TorchStorage

        storage = TorchStorage(config=cfg, device=device, deps_max_stale_ms=0.0,
                               autocomplete_keys=("env",))
    server = ZipkinServer(config, storage=storage, seal_interval_s=0).start()
    store, base = server.storage, f"http://127.0.0.1:{server.port}"
    agg = store.agg
    batches = []
    ingest = agg.ingest

    def count_batch(c):
        batches.append(int(c.valid.sum()))
        return ingest(c)

    agg.ingest = count_batch

    def post(body, headers=None, path="/api/v2/spans"):
        req = urllib.request.Request(base + path, data=body, headers=headers or {}, method="POST")
        try:
            with urllib.request.urlopen(req, timeout=300) as resp:
                return resp.status
        except urllib.error.HTTPError as e:
            return e.code

    http = HttpStore(base)
    fig = dict(card=card)
    try:
        hll_kernel.update.launches = hll_kernel.update_step.launches = 0
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(4) as pool:
            statuses = list(pool.map(post, wire))
        agg.block_until_ready()
        post_ms = (time.perf_counter() - t0) * 1e3
        launches, n_batches = hll_kernel.update_step.launches, len(batches)
        if statuses != [202] * len(wire):
            raise AssertionError(f"phase f2: POST statuses {sorted(set(statuses))}")
        if sum(batches) != n_spans or launches != n_batches or hll_kernel.update.launches:
            raise AssertionError(f"phase f2: {sum(batches)} spans in {n_batches} batches, "
                                 f"update_step launches {launches}")
        counters = http.get("/api/v2/tpu/counters")
        if counters["spans"] != n_spans or counters["nativeVocabOverflow"]:
            raise AssertionError(f"phase f2: counters {counters}")
        truth = store_truth(traffic, cfg)
        picked = sampled_traces(traffic)
        checked = check_store_answers(http, agg, truth, spans,
                                      np.random.default_rng(seed + 1).choice(picked, 16, replace=False),
                                      "phase f2", archived=[s for t in picked for s in spans[8 * t:8 * t + 8]])

        # the other encodings and the error answers
        ts_us = (truth.t_end - 30 * 60_000) * 1000
        extra = [small_trace(t, f"smoke{i}", ts_us) for i, t in enumerate(archived_ids(3))]
        bomb = zlib.compressobj(1, zlib.DEFLATED, 31)
        zeros = b"\0" * (1 << 24)
        bomb_body = b"".join(bomb.compress(zeros) for _ in range((server.MAX_INFLATED >> 24) + 1))
        bomb_body += bomb.flush()
        v1_body = json_v1.encode_v1_span_list(extra[2])
        answers = {
            "gzip": post(gzip.compress(json_v2.encode_span_list(extra[0])), {"Content-Encoding": "gzip"}),
            "protobuf": post(proto3.encode_span_list(extra[1]), {"Content-Type": "application/x-protobuf"}),
            "v1": post(v1_body, {"Content-Type": "application/json"}, "/api/v1/spans"),
            "malformed": post(b"\xffnot-spans"),
            "gzip_bomb": post(bomb_body, {"Content-Encoding": "gzip"}),
        }
        if answers != {"gzip": 202, "protobuf": 202, "v1": 202, "malformed": 400, "gzip_bomb": 413}:
            raise AssertionError(f"phase f2: POST answers {answers}")
        # the fast path archives the exact slices; v1 converts on the way in
        v1_spans = json_v1.decode_v1_span_list(v1_body)
        for trace in extra[:2] + [v1_spans]:
            got = http.get(f"/api/v2/trace/{trace[0].trace_id}")
            if sorted(json.dumps(d, sort_keys=True) for d in got) != \
                    sorted(json.dumps(json_v2.span_to_dict(s), sort_keys=True) for s in trace):
                raise AssertionError(f"phase f2: trace {trace[0].trace_id} read back {got}")
        metrics = http.get("/metrics")
        # the bomb is refused before the collector sees a message
        want_metrics = {"messages": len(wire) + 4, "messages_dropped": 1,
                        "spans": n_spans + 4 + len(v1_spans)}
        if {k: metrics[f"counter.zipkin_collector.{k}.http"] for k in want_metrics} != want_metrics:
            raise AssertionError(f"phase f2: metrics {metrics}")

        # every route against the store's direct answer, then its wall
        window = {"endTs": truth.t_end, "lookback": truth.lookback}
        svc = sorted(truth.cards)[0]
        some = [spans[8 * int(t)].trace_id for t in picked[:5]]
        from zipkin_tpu_torch.storage.spi import QueryRequest

        query = QueryRequest(end_ts=truth.t_end, lookback=truth.lookback, limit=10, service_name=svc)
        routes = {
            "traces": ("/api/v2/traces", {"serviceName": svc, **window},
                       lambda: [[json_v2.span_to_dict(s) for s in t]
                                for t in store.get_traces_query(query).execute()]),
            "trace": (f"/api/v2/trace/{some[0]}", None,
                      lambda: [json_v2.span_to_dict(s) for s in store.get_trace(some[0]).execute()]),
            "traceMany": ("/api/v2/traceMany", {"traceIds": ",".join(some)},
                          lambda: [[json_v2.span_to_dict(s) for s in t]
                                   for t in store.get_traces(some).execute()]),
            "services": ("/api/v2/services", None, lambda: store.get_service_names().execute()),
            "spans": ("/api/v2/spans", {"serviceName": svc}, lambda: store.get_span_names(svc).execute()),
            "remoteServices": ("/api/v2/remoteServices", {"serviceName": svc},
                               lambda: store.get_remote_service_names(svc).execute()),
            "dependencies": ("/api/v2/dependencies", {**window, **FRESH},
                             lambda: [json_v2.link_to_dict(x) for x in store.get_dependencies(
                                 truth.t_end, truth.lookback, staleness_ms=0).execute()]),
            "autocompleteKeys": ("/api/v2/autocompleteKeys", None, lambda: store.get_keys().execute()),
            "autocompleteValues": ("/api/v2/autocompleteValues", {"key": "env"},
                                   lambda: store.get_values("env").execute()),
            "tpu/percentiles": ("/api/v2/tpu/percentiles", {"q": "0.5,0.9,0.99", **FRESH},
                                lambda: store.latency_quantiles(QS, staleness_ms=0)),
            "tpu/cardinalities": ("/api/v2/tpu/cardinalities", FRESH,
                                  lambda: store.trace_cardinalities(staleness_ms=0)),
            "tpu/overview": ("/api/v2/tpu/overview", {"q": "0.5,0.9,0.99", **FRESH},
                             lambda: {**store.sketch_overview(QS, staleness_ms=0), "counters": None}),
            "tpu/counters": ("/api/v2/tpu/counters", None, None),
            "health": ("/health", None, lambda: {"status": "UP", "zipkin": {"tpu": {"status": "UP"}}}),
            "info": ("/info", None, None),
            "metrics": ("/metrics", None, None),
        }
        for name, (path, params, direct) in routes.items():
            got = http.get(path, params)
            if name == "tpu/overview":
                got["counters"] = None  # wall-clock gauges move between two calls
            if direct is not None and got != json.loads(json.dumps(direct())):
                raise AssertionError(f"phase f2: {name} differs from the store's direct answer")
            if name in ("traces", "traceMany", "trace") and not got:
                raise AssertionError(f"phase f2: {name} answered nothing")
        if http.get("/api/v2/autocompleteValues", {"key": "env"}) != ["smoke"]:
            raise AssertionError("phase f2: autocomplete values")
        http.get("/api/v2/trace/feed", want=404)
        http.get("/api/v2/trace/nothex!", want=400)
        http.get("/api/v2/dependencies", want=400)
        route_ms = {name: median_ms(lambda p=path, q=params: http.get(p, q))
                    for name, (path, params, _) in routes.items()}
    finally:
        del agg.ingest
        server.stop()
    fig.update(post_ms=post_ms, post_spans_per_s=n_spans / (post_ms / 1e3), device_batches=n_batches,
               launches=launches, route_ms=route_ms, **checked)
    log(f"phase f2 ({card}): 4 threads POST {len(wire)} payloads over HTTP: {fig['post_spans_per_s']:.0f} "
        f"spans/s ({post_ms:.0f} ms), {n_batches} device batches, update_step launches {launches}; "
        f"gzip, protobuf, v1 202 and read back, malformed 400, gzip bomb 413; every route equals the "
        f"store's direct answer and the generator ({checked['edges']} edges, {checked['hist_checked']} "
        f"histogram and {checked['digest_checked']} digest quantiles, {checked['names']} services)")
    log(f"phase f2 ({card}): route wall ms, median of 5: "
        + json.dumps({k: round(v, 3) for k, v in route_ms.items()}))
    return fig


def phase_entry(card: str, timeout_s: float = 120.0, storage: str = "tpu", env_extra=None,
                what: str = "f3") -> dict:
    """(f3) ``python -m zipkin_tpu_torch.server --port P --storage tpu``
    with TPU_FAST_INGEST=1, TPU_FAST_ARCHIVE_SAMPLE=1 and TPU_ARCHIVE_DIR=off
    (and ``env_extra``) as a subprocess:
    /health UP within ``timeout_s``, a small trace POSTed and read back
    through trace/{id}, dependencies and tpu/percentiles, then SIGTERM and
    exit code 0 within 30 s. ``storage="mem"`` rehearses it off the card
    (no sketch routes)."""
    import os
    import signal
    import socket
    import tempfile
    import urllib.error
    import urllib.request

    from zipkin_tpu_torch.model import json_v2

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    # the disk archive off: f3 reads the host archive's sample, as it did
    # before the fast path's default turned the disk archive on
    env = dict(os.environ, TPU_FAST_INGEST="1", TPU_FAST_ARCHIVE_SAMPLE="1", TPU_ARCHIVE_DIR="off",
               TPU_DEPS_MAX_STALE_MS="0", QUERY_HOST="127.0.0.1", **(env_extra or {}))
    root = os.path.dirname(os.path.abspath(__file__))
    http = HttpStore(f"http://127.0.0.1:{port}")
    fig = dict(card=card, port=port)
    with tempfile.TemporaryFile() as out:
        t0 = time.perf_counter()
        proc = subprocess.Popen([sys.executable, "-m", "zipkin_tpu_torch.server", "--port", str(port),
                                 "--storage", storage], cwd=root, env=env, stdout=out,
                                stderr=subprocess.STDOUT)
        try:
            while True:
                if proc.poll() is not None:
                    raise AssertionError(f"phase {what}: the server exited {proc.returncode} before /health")
                try:
                    if http.get("/health")["status"] == "UP":
                        break
                except (OSError, AssertionError):
                    pass
                if time.perf_counter() - t0 > timeout_s:
                    raise AssertionError(f"phase {what}: /health not UP within {timeout_s} s")
                time.sleep(0.25)
            fig["boot_s"] = time.perf_counter() - t0
            now_ms = int(time.time() * 1000)
            trace = small_trace(0x1234567890ABCDEF, "entry", (now_ms - 60_000) * 1000)
            req = urllib.request.Request(http.base + "/api/v2/spans", method="POST",
                                         data=json_v2.encode_span_list(trace),
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as resp:
                if resp.status != 202:
                    raise AssertionError(f"phase {what}: POST {resp.status}")
            got = http.get(f"/api/v2/trace/{trace[0].trace_id}")
            deps = http.get("/api/v2/dependencies", {"endTs": now_ms + 60_000, "lookback": 3_600_000,
                                                     **FRESH})
            rows = [{"serviceName": "entry", "count": 1}, {"serviceName": "entry-db", "count": 1}]
            if storage == "tpu":
                rows = http.get("/api/v2/tpu/percentiles", {"q": "0.5", **FRESH})
            if len(got) != 2 or deps != [{"parent": "entry", "child": "entry-db", "callCount": 1}] \
                    or sorted((r["serviceName"], r["count"]) for r in rows) != [("entry", 1), ("entry-db", 1)]:
                raise AssertionError(f"phase {what}: read back {got}, {deps}, {rows}")
            t1 = time.perf_counter()
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=30)
            fig["stop_s"] = time.perf_counter() - t1
            if rc != 0:
                raise AssertionError(f"phase {what}: exit code {rc} after SIGTERM")
        except BaseException:
            out.seek(0)
            log(f"phase {what}: server output:\n" + out.read().decode(errors="replace")[-4000:])
            raise
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
    log(f"phase {what} ({card}): python -m zipkin_tpu_torch.server --storage {storage}: /health UP in "
        f"{fig['boot_s']:.1f} s; a trace POSTed and read back through trace/{{id}}, dependencies and "
        f"tpu/percentiles; SIGTERM -> exit 0 in {fig['stop_s']:.2f} s")
    return fig


def store_reads(store, truth) -> dict:
    """The device-served reads of a store, for comparing two stores: the
    dependencies, histogram and digest percentile rows and cardinalities
    over the generator's window, and the host counters. The digest read
    flushes the pending points (a ttflush record with a WAL attached)."""
    return dict(
        dependencies=link_map(store.get_dependencies(truth.t_end, truth.lookback).execute()),
        hist=store.latency_quantiles(QS, use_digest=False),
        digest=store.latency_quantiles(QS),
        cardinalities=store.trace_cardinalities(),
        counters=dict(store.agg.host_counters),
    )


def assert_reads_equal(got: dict, want: dict, what: str) -> None:
    """Integer answers and histogram rows exact; digest rows with equal
    counts and quantiles within rtol 1e-4 (their means agree within the
    leaves' rtol 1e-5: float atomics sum in a run-dependent order)."""
    for name in ("dependencies", "hist", "cardinalities", "counters"):
        if got[name] != want[name]:
            raise AssertionError(f"{what}: {name} differs")
    g, w = got["digest"], want["digest"]
    if [(r["serviceName"], r["spanName"], r["count"]) for r in g] != \
            [(r["serviceName"], r["spanName"], r["count"]) for r in w] or not g:
        raise AssertionError(f"{what}: digest rows differ")
    np.testing.assert_allclose([list(r["quantiles"].values()) for r in g],
                               [list(r["quantiles"].values()) for r in w], rtol=1e-4,
                               err_msg=f"{what} digest quantiles")


def dir_bytes(path: str) -> dict:
    import os

    return {n: os.path.getsize(os.path.join(path, n)) for n in sorted(os.listdir(path))}


def phase_durable(torch, card: str, stored: dict, fast: dict, cfg=None, device=None,
                  snap_at: int = 32, crash_at: int = 48) -> dict:
    """(g1) durable boot in process: the resume adapter
    (``zipkin_tpu_torch.storage.tpu.TorchStorage``) at the default AggConfig
    with a checkpoint dir and a WAL dir under a temp dir takes phase e's
    payloads through ``Collector(fast_ingest=True)``, snapshots after
    payload ``snap_at`` and "crashes" after payload ``crash_at`` (its reads
    taken, nothing closed, flushed or snapshotted). A new adapter on the same
    dirs restores and replays: its leaves (integer bit for bit, digests rtol
    1e-5), wal_seq and reads equal the victim's, and update_step launches
    once per replayed device batch. Then a fresh save rots at rest (the
    ``snapshot.state`` corrupt site) and a third boot falls back one
    generation to the same leaves. Times the save, the restore and its crc
    share, the replay and the WAL append (and the append with fsync off and
    on)."""
    import os
    import shutil
    import tempfile

    from zipkin_tpu_torch import faults
    from zipkin_tpu_torch.collector import Collector
    from zipkin_tpu_torch.ops import hll_kernel
    from zipkin_tpu_torch.storage.tpu import TorchStorage
    from zipkin_tpu_torch.tpu import snapshot as snap_mod
    from zipkin_tpu_torch.tpu import wal as wal_mod
    from zipkin_tpu_torch.tpu.state import AggConfig

    cfg = cfg or AggConfig()
    wire, traffic = stored["wire"], stored["traffic"]
    truth = store_truth(traffic, cfg)
    root = tempfile.mkdtemp(prefix="zt-durable-")
    dirs = dict(checkpoint_dir=os.path.join(root, "snap"), wal_dir=os.path.join(root, "wal"))
    boot = lambda: TorchStorage(config=cfg, device=device, deps_max_stale_ms=0.0, **dirs)  # noqa: E731
    fig = dict(card=card, payloads=crash_at, snapshot_after=snap_at)
    crc_ms = [0.0]
    digests = snap_mod.leaf_digests

    def timed_digests(arrays):
        t = time.perf_counter()
        out = digests(arrays)
        crc_ms[0] += (time.perf_counter() - t) * 1e3
        return out

    try:
        hll_kernel.update.launches = hll_kernel.update_step.launches = 0
        victim = boot()
        agg = victim.agg
        batches, append_s = [], [0.0]
        ingest, append = agg.ingest, victim.wal.append

        def count_batch(c):
            batches.append(int(c.valid.sum()))
            return ingest(c)

        def timed_append(*a, **k):
            t = time.perf_counter()
            out = append(*a, **k)
            append_s[0] += time.perf_counter() - t
            return out

        agg.ingest, victim.wal.append = count_batch, timed_append
        collector = Collector(victim, fast_ingest=True)
        ingest_s, per = 0.0, []
        for i, p in enumerate(wire[:crash_at]):
            t0 = time.perf_counter()
            per.append(collector.accept_spans_bytes(p))
            agg.block_until_ready()
            ingest_s += time.perf_counter() - t0
            if i + 1 == snap_at:
                t0 = time.perf_counter()
                if victim.snapshot() is None:
                    raise AssertionError("phase g1: the snapshot was not taken")
                fig["save_ms"] = (time.perf_counter() - t0) * 1e3
        n_in = sum(per)
        if sum(batches) != n_in or victim.ingest_counters()["spans"] != n_in:
            raise AssertionError(f"phase g1: {sum(batches)} spans in device batches, want {n_in}")
        fig["state_bytes"] = max(v for k, v in dir_bytes(dirs["checkpoint_dir"]).items()
                                 if k.endswith(".npz"))
        fig.update(ingest_spans_per_s=n_in / ingest_s, f1_spans_per_s=fast["spans_per_s"],
                   append_us_per_batch=append_s[0] / len(batches) * 1e6, device_batches=len(batches))
        # the victim's reads, then the crash: its leaves, wal_seq and log as
        # they stand; nothing closed, flushed or snapshotted
        want = store_reads(victim, truth)
        want_leaves, want_seq = agg.state_arrays(), agg.wal_seq
        del agg.ingest, victim.wal.append
        left = dir_bytes(dirs["wal_dir"])
        replayed = [f.shape[-1] for _, _, f in victim.wal.records(
            snap_mod.retained_coverage(dirs["checkpoint_dir"]))]
        replay_batches = sum(1 for n in replayed if n)
        # the same records appended again to fresh logs, with TPU_WAL_FSYNC
        # off and on, alternating, in this run
        records = [(f, m) for _, m, f in victim.wal.records() if f.shape[-1]]
        logs = {sync: wal_mod.WriteAheadLog(os.path.join(root, f"wal-fsync{int(sync)}"), fsync=sync)
                for sync in (False, True)}
        spent = {False: 0.0, True: 0.0}
        for f, m in records:
            for sync, w in logs.items():
                t0 = time.perf_counter()
                w.append(f, m)
                spent[sync] += time.perf_counter() - t0
        for w in logs.values():
            w.close()
        fig.update(append_us_nosync=spent[False] / len(records) * 1e6,
                   append_us_fsync=spent[True] / len(records) * 1e6, append_records=len(records))
        del victim, agg, collector
        if dir_bytes(dirs["wal_dir"]) != left:
            raise AssertionError("phase g1: the victim's WAL grew after the crash")

        snap_mod.leaf_digests = timed_digests
        launches0 = hll_kernel.update_step.launches
        reborn = boot()
        launches_replay = hll_kernel.update_step.launches - launches0
        stats = dict(reborn.restore_stats)
        if launches_replay != replay_batches or stats["walReplayBatches"] != len(replayed):
            raise AssertionError(f"phase g1: replay launched update_step {launches_replay} times for "
                                 f"{replay_batches} device batches ({stats})")
        assert_leaves_equal(reborn.agg.state_arrays(), want_leaves, "phase g1 reborn vs victim")
        if reborn.agg.wal_seq != want_seq or reborn.resume_offset != n_in:
            raise AssertionError(f"phase g1: wal_seq {reborn.agg.wal_seq}, want {want_seq}")
        assert_reads_equal(store_reads(reborn, truth), want, "phase g1 reborn")
        replay_spans = sum(per[snap_at:])
        fig.update(restore_ms=stats["restoreMs"], crc_ms=crc_ms[0],
                   crc_share=crc_ms[0] / stats["restoreMs"], replay_ms=stats["walReplayMs"],
                   replay_records=stats["walReplayBatches"], replay_batches=replay_batches,
                   replay_batches_per_s=replay_batches / (stats["walReplayMs"] / 1e3),
                   replay_spans_per_s=replay_spans / (stats["walReplayMs"] / 1e3))

        # a fresh save that rots at rest: the next boot falls back a generation
        faults.arm_corrupt("snapshot.state")
        try:
            if reborn.snapshot() is None:
                raise AssertionError("phase g1: the second snapshot was not taken")
        finally:
            faults.disarm()
        del reborn
        launches0 = hll_kernel.update_step.launches
        third = boot()
        launches_fallback = hll_kernel.update_step.launches - launches0
        stats3 = dict(third.restore_stats)
        quarantined = [n for n in os.listdir(dirs["checkpoint_dir"])
                       if n.endswith(snap_mod.QUARANTINE_SUFFIX)]
        if stats3["restoreFallbacks"] != 1 or stats3["generationsQuarantined"] != 1 \
                or len(quarantined) != 2 or launches_fallback != replay_batches:
            raise AssertionError(f"phase g1: fallback boot {stats3}, quarantined {quarantined}, "
                                 f"{launches_fallback} launches")
        assert_leaves_equal(third.agg.state_arrays(), want_leaves, "phase g1 fallback vs victim")
        if third.agg.wal_seq != want_seq or third.agg.host_counters != want["counters"]:
            raise AssertionError("phase g1: the fallback boot's wal_seq or counters differ")
        third.close()
        launches = {"update": hll_kernel.update.launches, "update_step": hll_kernel.update_step.launches}
    finally:
        snap_mod.leaf_digests = digests
        shutil.rmtree(root, ignore_errors=True)
    want_launches = len(batches) + 2 * replay_batches
    if launches["update"] or launches["update_step"] != want_launches:
        raise AssertionError(f"phase g1: hll launches {launches}, want update_step {want_launches}")
    fig.update(launches=launches["update_step"], update_launches=launches["update"],
               fallback_restore_ms=stats3["restoreMs"], fallback_replay_ms=stats3["walReplayMs"])
    log(f"phase g1 ({card}): resume adapter, {crash_at} payloads through Collector(fast_ingest) with "
        f"the WAL on: {fig['ingest_spans_per_s']:.0f} spans/s (f1 without a WAL "
        f"{fig['f1_spans_per_s']:.0f}); WAL append {fig['append_us_per_batch']:.1f} us per batch; "
        f"the same {fig['append_records']} records appended again: {fig['append_us_nosync']:.1f} us "
        f"each without fsync, {fig['append_us_fsync']:.1f} us with TPU_WAL_FSYNC; "
        f"snapshot after payload {snap_at}: save {fig['save_ms']:.1f} ms, {fig['state_bytes']} bytes "
        f"on disk; crash after payload {crash_at}")
    log(f"phase g1 ({card}): boot: restore {fig['restore_ms']:.1f} ms (crc32 {fig['crc_ms']:.1f} ms, "
        f"{100 * fig['crc_share']:.1f}%), WAL replay {fig['replay_records']} records "
        f"({replay_batches} device batches) in {fig['replay_ms']:.1f} ms = "
        f"{fig['replay_batches_per_s']:.1f} batches/s, {fig['replay_spans_per_s']:.0f} spans/s; "
        f"update_step launches in replay {launches_replay}; leaves, wal_seq {want_seq} and reads equal "
        f"the victim's; a rotted newest generation: restoreFallbacks 1, quarantined, restore "
        f"{fig['fallback_restore_ms']:.1f} ms + replay {fig['fallback_replay_ms']:.1f} ms to the same "
        f"leaves; update_step launches in phase g1 {launches['update_step']}")
    return fig


def phase_resume_entry(card: str, wire, spans, cold_boot_s: float, timeout_s: float = 180.0,
                       argv=None, env_extra=None, n_before: int = 8, n_after: int = 8) -> dict:
    """(g2) ``python -m zipkin_tpu_torch.server --resume-dir D`` as a
    subprocess (``STORAGE_TYPE`` left to its default, the card; with
    TPU_FAST_INGEST=1 the disk archive is ``D/archive``): POST ``n_before``
    payloads, ``POST /api/v2/tpu/snapshot``, POST ``n_after`` more, read the
    device-served routes, SIGKILL. Restarted on D: /metrics shows
    walReplayBatches > 0, the routes answer as before the kill, and every
    trace of the payloads (``spans``, 8 a trace) answers complete through
    ``traceMany``, from the archive's recovered segments. SIGTERM exits 0
    and leaves a new snapshot generation. ``argv`` replaces the module's
    command line (a rehearsal off the card)."""
    import os
    import signal
    import socket
    import tempfile
    import urllib.error
    import urllib.request

    root = tempfile.mkdtemp(prefix="zt-resume-")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = {k: v for k, v in os.environ.items()
           if k not in ("STORAGE_TYPE", "TPU_RESUME_DIR", "TPU_ARCHIVE_DIR")}
    env.update(TPU_FAST_INGEST="1", TPU_DEPS_MAX_STALE_MS="0", QUERY_HOST="127.0.0.1",
               **(env_extra or {}))
    cmd = (argv or [sys.executable, "-m", "zipkin_tpu_torch.server"]) + [
        "--port", str(port), "--resume-dir", root]
    base = f"http://127.0.0.1:{port}"
    http = HttpStore(base)
    cwd = os.path.dirname(os.path.abspath(__file__))

    def post(path, body=b""):
        req = urllib.request.Request(base + path, data=body, method="POST",
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as resp:
            return resp.status, resp.read()

    def start(out):
        t0 = time.perf_counter()
        proc = subprocess.Popen(cmd, cwd=cwd, env=env, stdout=out, stderr=subprocess.STDOUT)
        while True:
            if proc.poll() is not None:
                raise AssertionError(f"phase g2: the server exited {proc.returncode} before /health")
            try:
                if http.get("/health")["status"] == "UP":
                    return proc, time.perf_counter() - t0
            except (OSError, AssertionError):
                pass
            if time.perf_counter() - t0 > timeout_s:
                raise AssertionError(f"phase g2: /health not UP within {timeout_s} s")
            time.sleep(0.25)

    def reads(window):
        return dict(
            dependencies=http.get("/api/v2/dependencies", {**window, **FRESH}),
            hist=http.get("/api/v2/tpu/percentiles", {"q": "0.5,0.9,0.99", "sketch": "hist", **FRESH}),
            digest=http.get("/api/v2/tpu/percentiles", {"q": "0.5,0.9,0.99", **FRESH}),
            cardinalities=http.get("/api/v2/tpu/cardinalities", FRESH),
            spans=http.get("/api/v2/tpu/counters")["spans"],
        )

    def generations():
        return sorted(n for n in os.listdir(os.path.join(root, "snap")) if n.endswith(".npz"))

    fig = dict(card=card, cold_boot_s_f3=cold_boot_s)
    procs = []
    with tempfile.TemporaryFile() as out:
        try:
            proc, fig["boot_empty_s"] = start(out)
            procs.append(proc)
            from zipkin_tpu_torch.workload import BASE_MINUTE

            window = {"endTs": (BASE_MINUTE + 60) * 60_000, "lookback": 2 * 60 * 60_000}
            for p in wire[:n_before]:
                if post("/api/v2/spans", p)[0] != 202:
                    raise AssertionError("phase g2: POST refused")
            status, body = post("/api/v2/tpu/snapshot")
            if status != 200 or json.loads(body) != {"snapshot": os.path.join(root, "snap")}:
                raise AssertionError(f"phase g2: snapshot route {status} {body!r}")
            for p in wire[n_before:n_before + n_after]:
                if post("/api/v2/spans", p)[0] != 202:
                    raise AssertionError("phase g2: POST refused")
            before = reads(window)
            if not before["dependencies"] or not before["digest"]:
                raise AssertionError("phase g2: nothing to compare")
            proc.send_signal(signal.SIGKILL)
            proc.wait(timeout=30)
            gens = generations()
            proc, fig["boot_resume_s"] = start(out)
            procs.append(proc)
            metrics = http.get("/metrics")
            fig.update(replay_records=metrics["gauge.zipkin_tpu.walReplayBatches"],
                       restore_ms=metrics["gauge.zipkin_tpu.restoreMs"],
                       replay_ms=metrics["gauge.zipkin_tpu.walReplayMs"])
            if fig["replay_records"] <= 0 or fig["restore_ms"] <= 0:
                raise AssertionError(f"phase g2: /metrics after the restart {metrics}")
            after = reads(window)
            for name in ("dependencies", "hist", "cardinalities", "spans"):
                if after[name] != before[name]:
                    raise AssertionError(f"phase g2: {name} after the restart differs")
            assert_reads_equal({**after, "counters": None}, {**before, "counters": None},
                               "phase g2 restarted")
            # every trace acked before the kill, complete, from D/archive
            from zipkin_tpu_torch.model import json_v2

            acked = spans[:(n_before + n_after) * (len(spans) // len(wire))]
            t1 = time.perf_counter()
            for lo in range(0, len(acked), 8 * 256):
                part = acked[lo:lo + 8 * 256]
                ids = [part[i].trace_id for i in range(0, len(part), 8)]
                got = http.get("/api/v2/traceMany", {"traceIds": ",".join(ids)})
                want = [sorted(json.dumps(json_v2.span_to_dict(s), sort_keys=True)
                               for s in part[i:i + 8]) for i in range(0, len(part), 8)]
                if [sorted(json.dumps(d, sort_keys=True) for d in t) for t in got] != want:
                    raise AssertionError(f"phase g2: traces {ids[0]}.. after the restart differ")
            fig.update(traces_read=len(acked) // 8, trace_reads_s=time.perf_counter() - t1)
            http.get(f"/api/v2/trace/{'1' * 16}", want=404)
            t1 = time.perf_counter()
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=120)
            fig["stop_s"] = time.perf_counter() - t1
            if rc != 0 or generations() == gens or len(generations()) < 1:
                raise AssertionError(f"phase g2: SIGTERM exit {rc}, generations {gens} -> {generations()}")
        except BaseException:
            out.seek(0)
            log("phase g2: server output:\n" + out.read().decode(errors="replace")[-4000:])
            raise
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait(timeout=30)
            import shutil

            shutil.rmtree(root, ignore_errors=True)
    log(f"phase g2 ({card}): python -m zipkin_tpu_torch.server --resume-dir D: /health UP in "
        f"{fig['boot_empty_s']:.1f} s on an empty D (f3's cold boot {cold_boot_s:.1f} s); "
        f"{n_before} payloads, POST /api/v2/tpu/snapshot 200, {n_after} more, SIGKILL; restarted "
        f"with resume in {fig['boot_resume_s']:.1f} s (restoreMs {fig['restore_ms']:.1f}, "
        f"walReplayBatches {fig['replay_records']}, walReplayMs {fig['replay_ms']:.1f}); dependencies, "
        f"percentiles, cardinalities and counters answer as before the kill; all {fig['traces_read']} "
        f"traces acked before it read back complete from D/archive through traceMany in "
        f"{fig['trace_reads_s']:.2f} s; SIGTERM -> exit 0 in {fig['stop_s']:.2f} s with a new "
        f"snapshot generation")
    return fig


def phase_archive(seed: int, torch, card: str, stored: dict, fast: dict, cfg=None, device=None,
                  segment_bytes: int = 32 << 20, retention_payloads: int = 16,
                  timed_ids: int = 256) -> dict:
    """(h) the disk span archive and the at-rest scrubber, on phase e's
    payloads at the default AggConfig:

    (h1) ``Collector(fast_ingest=True)`` into ``TorchStorage(archive_dir=D)``
         on the card, in segments of ``segment_bytes`` (half the default:
         the 2**18 spans take ~50 MB, which would not fill one 64 MB
         segment, and h2 and h3 need a sealed segment and a live tail): the leaves equal phase e's, update_step launches once
         per device batch, every trace reads back complete through
         ``get_traces`` (not the 1/64 sample: the host archive stays empty),
         the getTraces queries equal those of phase e's host archive, which
         holds every span (the oracle), and the name reads too. Times the
         archive append, the ingest against f1's, get_trace (median over
         ``timed_ids`` ids) and each query; counts bytes on disk and seals.
    (h2) a new store on D after a crash (nothing closed or sealed, no
         snapshot): times the recovery of the unsealed tail; names, vocab,
         traces and queries equal h1's.
    (h3) a byte of the first sealed segment's last frame flipped: one
         ``Scrubber.scan_once()`` with pacing off detects it and quarantines
         the segment, the counters show it, and every later read returns the
         traces that remain, never an error (a read holding earlier views
         still reads). Times the scan in MB/s.
    (h4) a store whose byte budget is half of ``retention_payloads``
         payloads, in segments of a quarter of it, takes those payloads: its oldest segments are deleted
         whole, and its reads stay sound (the newest payload's traces
         complete, the oldest's gone, a query's traces complete and matching).
    """
    import gc
    import os
    import shutil
    import tempfile

    from zipkin_tpu_torch.collector import Collector
    from zipkin_tpu_torch.ops import hll_kernel
    from zipkin_tpu_torch.runtime.scrub import Scrubber
    from zipkin_tpu_torch.storage.spi import QueryRequest
    from zipkin_tpu_torch.tpu import archive as archive_mod
    from zipkin_tpu_torch.tpu.state import AggConfig
    from zipkin_tpu_torch.tpu.store import TorchStorage

    cfg = cfg or AggConfig()
    wire, traffic, spans, oracle = stored["wire"], stored["traffic"], stored["spans"], stored["archive"]
    n_spans, n_traces = len(spans), len(spans) // 8
    truth = store_truth(traffic, cfg)
    trace_ids = [spans[8 * t].trace_id for t in range(n_traces)]
    root = tempfile.mkdtemp(prefix="zt-archive-")
    fig = dict(card=card, spans=n_spans, traces=n_traces)
    batches = []

    def counting(agg):
        ingest = agg.ingest

        def count_batch(c):
            batches.append(int(c.valid.sum()))
            out = ingest(c)
            agg.block_until_ready()  # as f1's stage timing syncs each step
            return out
        agg.ingest = count_batch

    def timed_into(key, fn):
        def run(*a, **k):
            t = time.perf_counter()
            out = fn(*a, **k)
            fig[key] = fig.get(key, 0.0) + time.perf_counter() - t
            return out
        return run

    def ingest(store, payloads):
        collector = Collector(store, fast_ingest=True)
        t0 = time.perf_counter()
        for p in payloads:
            collector.accept_spans_bytes(p)
        store.agg.block_until_ready()
        return time.perf_counter() - t0

    def check_traces(got, idx, what):
        """``got`` (get_traces of trace indices ``idx``) holds each trace
        complete, its spans equal the generated ones."""
        if len(got) != len(idx):
            raise AssertionError(f"{what}: {len(got)} traces read back, want {len(idx)}")
        for trace, t in zip(got, idx):
            want = spans[8 * t:8 * t + 8]
            if trace[0].trace_id != want[0].trace_id or \
                    sorted(trace, key=lambda s: s.id) != sorted(want, key=lambda s: s.id):
                raise AssertionError(f"{what}: trace {want[0].trace_id} read back differs")

    keys = sorted(truth.key_durs)
    svc, name = keys[len(keys) // 3]
    edge = sorted(truth.edges)[len(truth.edges) // 2]
    dur99 = int(np.quantile(truth.cols.dur[truth.cols.svc == truth.cols.svc[0]], 0.999))
    # a limit past every query's matches: the disk archive's candidate scan
    # is bounded (the reference's trade), so two stores agree on a query
    # only when both return all of its traces
    window = dict(end_ts=truth.t_end, lookback=truth.lookback, limit=1 << 20)
    last_minutes = (int(truth.cols.ts_min.max()) + 1) * 60_000
    queries = {
        "service+spanName": dict(service_name=svc, span_name=name),
        "service+remoteService": dict(service_name=edge[0], remote_service_name=edge[1]),
        "service+minDuration": dict(service_name=truth.svc_of(int(truth.cols.svc[0])),
                                    min_duration=dur99),
        "service+error": dict(service_name=svc, annotation_query={"error": ""}),
        # no indexed clause: every trace of the last 5 minutes is decoded
        "error, last 5 min": dict(annotation_query={"error": ""}, end_ts=last_minutes,
                                  lookback=5 * 60_000),
    }

    def query_answers(store, timings=None):
        out = {}
        for qname, q in queries.items():
            t = time.perf_counter()
            traces = store.get_traces_query(QueryRequest(**{**window, **q})).execute()
            if timings is not None:
                timings[qname] = (time.perf_counter() - t) * 1e3
            out[qname] = {t[0].trace_id: sorted(t, key=lambda s: s.id) for t in traces}
            ts = [max(s.timestamp for s in t) for t in traces]
            if ts != sorted(ts, reverse=True):
                raise AssertionError(f"phase h: {qname}: traces not newest first")
        return out

    def names(store):
        services = store.get_service_names().execute()
        return dict(services=services,
                    spans={s: store.get_span_names(s).execute() for s in services},
                    remote={s: store.get_remote_service_names(s).execute() for s in services})

    try:
        hll_kernel.update.launches = hll_kernel.update_step.launches = 0
        # (h1) ingest with the archive on
        d1 = os.path.join(root, "h1")
        store = TorchStorage(config=cfg, device=device, archive_dir=d1, deps_max_stale_ms=0.0,
                             archive_segment_bytes=segment_bytes)
        counting(store.agg)
        store.disk_append_record = timed_into("append_s", store.disk_append_record)
        # its two parts: the frame's write and the vocab sidecar's rewrite
        store._disk.append_batch = timed_into("frame_s", store._disk.append_batch)
        store._persist_archive_vocab = timed_into("sidecar_s", store._persist_archive_vocab)
        n0 = len(batches)
        wall = ingest(store, wire)
        h1_batches = len(batches) - n0
        if sum(batches) != n_spans or hll_kernel.update_step.launches != h1_batches:
            raise AssertionError(f"phase h1: {sum(batches)} spans in {h1_batches} device batches, "
                                 f"update_step launches {hll_kernel.update_step.launches}")
        assert_leaves_equal(store.agg.state_arrays(), stored["state"], "phase h1 vs phase e")
        counters = store.ingest_counters()
        if counters["archiveSpansWritten"] != n_spans or store._archive.span_count:
            raise AssertionError(f"phase h1: archive counters {counters}")
        files = dir_bytes(d1)
        disk = sum(v for k, v in files.items() if k.startswith("arc-") or k == "vocab.json")
        seals = sum(1 for k in files if k.endswith(".ids.npy"))
        if seals < 1 or not store._disk._live_rows:
            raise AssertionError(f"phase h1: {seals} seals, live rows {len(store._disk._live_rows)}")
        fig.update(ingest_spans_per_s=n_spans / wall, f1_spans_per_s=fast["spans_per_s"],
                   append_us_per_batch=fig.pop("append_s") / h1_batches * 1e6,
                   frame_us_per_batch=fig.pop("frame_s") / h1_batches * 1e6,
                   sidecar_us_per_batch=fig.pop("sidecar_s") / h1_batches * 1e6,
                   device_batches=h1_batches, disk_bytes=disk, bytes_per_span=disk / n_spans,
                   raw_bytes=sum(len(p) for p in wire), seals=seals)
        t0 = time.perf_counter()
        got = store.get_traces(trace_ids).execute()
        fig["read_all_s"] = time.perf_counter() - t0
        check_traces(got, range(n_traces), "phase h1")
        del got
        rng = np.random.default_rng(seed + 3)
        pick = rng.choice(n_traces, timed_ids, replace=False)
        walls = []
        for t in pick:
            t0 = time.perf_counter()
            store.get_trace(trace_ids[t]).execute()
            walls.append((time.perf_counter() - t0) * 1e3)
        fig["get_trace_ms"] = statistics.median(walls)
        fig["query_ms"], fig["oracle_ms"] = {}, {}
        answers = query_answers(store, fig["query_ms"])
        if answers != query_answers(oracle, fig["oracle_ms"]):
            bad = [q for q in queries if answers[q] != query_answers(oracle)[q]]
            raise AssertionError(f"phase h1: queries {bad} differ from phase e's host archive")
        fig["query_traces"] = {q: len(a) for q, a in answers.items()}
        if min(fig["query_traces"].values()) < 1:
            raise AssertionError(f"phase h1: a query matched nothing {fig['query_traces']}")
        h1_names = names(store)
        if h1_names != names(oracle):
            raise AssertionError("phase h1: name reads differ from phase e's host archive")
        vocab = list(store.vocab._key_list)
        log(f"phase h1 ({card}): {n_spans} spans through Collector(fast_ingest) -> TorchStorage("
            f"archive_dir): {fig['ingest_spans_per_s']:.0f} spans/s (f1 without the archive "
            f"{fig['f1_spans_per_s']:.0f}); archive append {fig['append_us_per_batch']:.1f} us per batch "
            f"(frame write {fig['frame_us_per_batch']:.1f}, vocab sidecar {fig['sidecar_us_per_batch']:.1f}) "
            f"over {h1_batches} device batches, update_step launches {h1_batches}; leaves equal phase "
            f"e's; {disk} bytes on disk ({fig['bytes_per_span']:.1f} B a span; raw payloads "
            f"{fig['raw_bytes']} B), {seals} seal(s)")
        log(f"phase h1 ({card}): all {n_traces} traces read back complete through get_traces in "
            f"{fig['read_all_s']:.2f} s; get_trace {fig['get_trace_ms']:.3f} ms (median of "
            f"{timed_ids}); queries equal phase e's host archive, traces {json.dumps(fig['query_traces'])}, "
            f"disk ms {json.dumps({k: round(v, 1) for k, v in fig['query_ms'].items()})}, host archive ms "
            f"{json.dumps({k: round(v, 1) for k, v in fig['oracle_ms'].items()})}; "
            f"{len(h1_names['services'])} services' names equal")

        # (h2) a crash, then a new store on the same dir with no snapshot
        tail = sum(int(r.shape[0]) for r in store._disk._live_rows)
        before = dir_bytes(d1)
        del store
        gc.collect()
        torch.cuda.empty_cache()
        if dir_bytes(d1) != before:
            raise AssertionError("phase h2: the abandoned store changed its archive")
        recover = archive_mod.SpanArchive._recover
        archive_mod.SpanArchive._recover = timed_into("recover_s", recover)
        try:
            t0 = time.perf_counter()
            store = TorchStorage(config=cfg, device=device, archive_dir=d1,
                                 archive_segment_bytes=segment_bytes)
            fig["reopen_ms"] = (time.perf_counter() - t0) * 1e3
        finally:
            archive_mod.SpanArchive._recover = recover
        fig["recover_ms"] = fig.pop("recover_s") * 1e3
        recovered = store._disk.spans_written
        if recovered != tail or list(store.vocab._key_list) != vocab or names(store) != h1_names:
            raise AssertionError(f"phase h2: recovered {recovered} tail spans, want {tail}; "
                                 "or the vocab or names differ")
        sample = np.sort(rng.choice(n_traces, 2048, replace=False))
        check_traces(store.get_traces([trace_ids[t] for t in sample]).execute(), sample, "phase h2")
        if query_answers(store) != answers:
            raise AssertionError("phase h2: queries differ from h1's")
        fig.update(tail_spans=tail, tail_bytes=sum(v for k, v in before.items() if k.endswith(".dat")
                                                   and k + ".ids.npy" not in before))
        log(f"phase h2 ({card}): reopened on the same dir after a crash in {fig['reopen_ms']:.1f} ms, "
            f"of which the archive's recovery {fig['recover_ms']:.1f} ms ({tail} spans, "
            f"{fig['tail_bytes']} bytes of unsealed tail); vocab, names, 2048 traces and the queries "
            f"equal h1's")

        # (h3) a rotted sealed segment: detected, quarantined, reads partial
        sealed = store._disk.sealed_segment_paths()
        seg = store._disk._sealed[0]
        lost_ids = {f"{int(x):016x}" for x in np.unique(np.asarray(seg.ids))}
        lost = seg.n
        held = store._disk.views()
        with open(sealed[0], "r+b") as fh:
            fh.seek(os.path.getsize(sealed[0]) - 3)  # inside the last frame's payload
            b = fh.read(1)
            fh.seek(-1, os.SEEK_CUR)
            fh.write(bytes([b[0] ^ 0xFF]))
        store.scrubber = Scrubber(store, bytes_per_sec=0)
        t0 = time.perf_counter()
        out = store.scrubber.scan_once()
        scan_s = time.perf_counter() - t0
        c = store.ingest_counters()
        if (out["corrupt"], out["quarantined"], out["spans_quarantined"]) != (1, 1, lost) or \
                (c["archiveSegmentsQuarantined"], c["archiveSpansQuarantined"], c["scrubPasses"],
                 c["spansQuarantined"]) != (1, lost, 1, lost) or \
                not os.path.exists(sealed[0] + ".quarantine"):
            raise AssertionError(f"phase h3: scrub pass {out}, counters {c}")
        t0 = time.perf_counter()
        got = store.get_traces(trace_ids).execute()
        fig["read_after_s"] = time.perf_counter() - t0
        kept = [t for t in range(n_traces) if trace_ids[t] not in lost_ids]
        check_traces(got, kept, "phase h3")
        if sum(len(t) for t in got) != n_spans - lost:
            raise AssertionError("phase h3: spans read back after the quarantine")
        gone = sorted(lost_ids)[:64]
        held_read = [len(store._disk_trace_spans(t, views=held)) for t in gone]
        if sum(held_read) < 8 * len(gone) - 1:  # the flipped byte may spoil one span
            raise AssertionError(f"phase h3: a read holding earlier views got {sum(held_read)} spans")
        fig.update(scrub_ms=scan_s * 1e3, scrub_bytes=out["bytes"], scrub_files=out["files"],
                   scrub_mb_per_s=out["bytes"] / 1e6 / scan_s, spans_quarantined=lost,
                   traces_left=len(kept))
        log(f"phase h3 ({card}): one byte flipped in {os.path.basename(sealed[0])}: Scrubber.scan_once "
            f"(pacing off) verified {out['files']} file(s), {out['bytes']} bytes in {fig['scrub_ms']:.1f} ms "
            f"({fig['scrub_mb_per_s']:.0f} MB/s), quarantined it ({lost} spans; counters "
            f"archiveSpansQuarantined {c['archiveSpansQuarantined']}, scrubCorruptDetected "
            f"{c['scrubCorruptDetected']}); get_traces of all ids then returned the {len(kept)} traces "
            f"left, complete, in {fig['read_after_s']:.2f} s, no error; a read holding earlier views "
            f"read {sum(held_read)} spans of {len(gone)} pulled traces")
        store.close()
        del store, got, held
        gc.collect()
        torch.cuda.empty_cache()

        # (h4) retention: a small byte budget drops the oldest segments whole
        d4 = os.path.join(root, "h4")
        # half the payloads' bytes, in segments of a quarter of that (8 MB
        # and 2 MB at the default size)
        budget = sum(len(p) for p in wire[:retention_payloads]) // 2
        seg_bytes = budget // 4
        store = TorchStorage(config=cfg, device=device, archive_dir=d4, archive_max_bytes=budget,
                             archive_segment_bytes=seg_bytes)
        counting(store.agg)
        n0 = len(batches)
        ingest(store, wire[:retention_payloads])
        h4_batches = len(batches) - n0
        c = store.ingest_counters()
        per = n_spans // len(wire)
        first, last = range(0, per // 8), range((retention_payloads - 1) * per // 8, retention_payloads * per // 8)
        got_first = store.get_traces([trace_ids[t] for t in first]).execute()
        check_traces(store.get_traces([trace_ids[t] for t in last]).execute(), last, "phase h4 newest")
        q = QueryRequest(**window, service_name=svc)
        traces = store.get_traces_query(q).execute()
        index = {trace_ids[t]: t for t in range(retention_payloads * per // 8)}
        check_traces(traces, [index[t[0].trace_id] for t in traces], "phase h4 query")
        if c["archiveSpansDroppedRetention"] <= 0 or got_first or not traces \
                or c["archiveBytes"] > budget + seg_bytes + max(len(p) for p in wire) + (1 << 20) \
                or not all(q.test(t) for t in traces):
            raise AssertionError(f"phase h4: counters {c}, oldest payload's traces {len(got_first)}, "
                                 f"query {len(traces)}")
        fig.update(retention_dropped=c["archiveSpansDroppedRetention"], retention_bytes=c["archiveBytes"],
                   retention_segments=c["archiveSegments"], retention_batches=h4_batches,
                   retention_query_traces=len(traces))
        log(f"phase h4 ({card}): {retention_payloads} payloads into {seg_bytes} B segments under a "
            f"{budget} B budget: "
            f"{c['archiveSpansDroppedRetention']} spans dropped with their whole segments, "
            f"{c['archiveBytes']} bytes in {c['archiveSegments']} segments kept; the oldest payload's "
            f"traces gone, the newest's complete, a service query's {len(traces)} traces complete")
        store.close()
        del store
        launches = {"update": hll_kernel.update.launches, "update_step": hll_kernel.update_step.launches}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if launches["update"] or launches["update_step"] != len(batches):
        raise AssertionError(f"phase h: hll launches {launches} over {len(batches)} device batches")
    fig.update(launches=launches["update_step"], update_launches=launches["update"])
    return fig


def planes_by_name(store) -> dict:
    """The integer planes of a store keyed by name, not by vocab id (several
    parse workers assign global ids in arrival order): histograms and
    all-time HLL registers by (service, span name) and service, dependency
    links over the whole window by service pair, and the host counters but
    ``batches``."""
    hist, hll_regs, _ = store.agg.merged_sketches()
    svc, names = store.vocab.services.lookup, store.vocab.span_names.lookup
    keys = {(svc(s), names(n)): kid for kid, (s, n) in enumerate(store.vocab._key_list) if kid}
    calls, errs = store.agg.dependency_matrices(0, 1 << 31)
    counters = dict(store.agg.host_counters)
    counters.pop("batches")
    return dict(
        hist={k: hist[kid].tobytes() for k, kid in keys.items() if hist[kid].any()},
        hll={svc(i): hll_regs[i].tobytes() for i in range(1, len(store.vocab.services))},
        hll_global=hll_regs[store.config.global_hll_row].tobytes(),
        links={(svc(int(p)), svc(int(c))): (int(calls[p, c]), int(errs[p, c]))
               for p, c in zip(*np.nonzero(calls))},
        counters=counters,
    )


def entry_with_tier(card: str, wire, per: int, argv=None, env_extra=None,
                    timeout_s: float = 180.0) -> dict:
    """``TPU_FAST_INGEST=1 TPU_MP_WORKERS=2 TPU_MP_QUEUE_DEPTH=1 python -m
    zipkin_tpu_torch.server --storage tpu`` as a subprocess (archive off):
    /health UP, the first quarter of ``wire`` POSTed by a client that backs
    off on 429 all 202, the rest flooded from 4 threads without backoff (at
    least one 429), /metrics accounting for every 202'd span once the tier
    drains, then SIGTERM -> exit code 0. ``argv`` and ``env_extra`` replace
    the command and add to its environment (a rehearsal off the card)."""
    import concurrent.futures
    import os
    import signal
    import socket
    import tempfile
    import urllib.error
    import urllib.request

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, TPU_FAST_INGEST="1", TPU_MP_WORKERS="2", TPU_MP_QUEUE_DEPTH="1",
               TPU_ARCHIVE_DIR="off", QUERY_HOST="127.0.0.1", **(env_extra or {}))
    root = os.path.dirname(os.path.abspath(__file__))
    base = f"http://127.0.0.1:{port}"
    cmd = (argv or [sys.executable, "-m", "zipkin_tpu_torch.server"]) + [
        "--port", str(port), "--storage", "tpu"]

    def post(body):
        req = urllib.request.Request(base + "/api/v2/spans", data=body, method="POST",
                                     headers={"Content-Type": "application/x-protobuf"
                                              if body[:1] == b"\n" else "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=120) as resp:
                return resp.status
        except urllib.error.HTTPError as e:
            return e.code

    def metrics():
        return json.loads(urllib.request.urlopen(base + "/metrics", timeout=60).read())

    fig = dict(card=card)
    with tempfile.TemporaryFile() as out:
        t0 = time.perf_counter()
        proc = subprocess.Popen(cmd, cwd=root, env=env, stdout=out, stderr=subprocess.STDOUT)
        try:
            while True:
                if proc.poll() is not None:
                    raise AssertionError(f"phase i6: the server exited {proc.returncode} early")
                try:
                    if json.loads(urllib.request.urlopen(base + "/health", timeout=5).read())[
                            "status"] == "UP":
                        break
                except OSError:
                    pass
                if time.perf_counter() - t0 > timeout_s:
                    raise AssertionError(f"phase i6: /health not UP within {timeout_s} s")
                time.sleep(0.25)
            fig["boot_s"] = time.perf_counter() - t0
            quarter = len(wire) // 4
            accepted = backoffs = 0
            for p in wire[:quarter]:
                while (status := post(p)) == 429:
                    backoffs += 1
                    time.sleep(0.005)
                if status != 202:
                    raise AssertionError(f"phase i6: POST answered {status}")
                accepted += 1
            with concurrent.futures.ThreadPoolExecutor(4) as pool:
                flood = list(pool.map(post, wire[quarter:]))
            if set(flood) - {202, 429} or 429 not in flood:
                raise AssertionError(f"phase i6: the flood got {sorted(set(flood))}")
            accepted += flood.count(202)
            deadline = time.monotonic() + 60
            while True:
                m = metrics()
                if m.get("gauge.zipkin_tpu.mpInflight") == 0 and \
                        m.get("gauge.zipkin_tpu.mpAccepted") == per * accepted:
                    break
                if time.monotonic() > deadline:
                    raise AssertionError(f"phase i6: /metrics {m} after the tier drained, want "
                                         f"{per * accepted} spans")
                time.sleep(0.1)
            t1 = time.perf_counter()
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=60)
            fig["stop_s"] = time.perf_counter() - t1
            if rc != 0:
                raise AssertionError(f"phase i6: exit code {rc} after SIGTERM")
        except BaseException:
            out.seek(0)
            log("phase i6: server output:\n" + out.read().decode(errors="replace")[-4000:])
            raise
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
    fig.update(accepted=accepted, backoffs=backoffs, flood=len(flood), flood_429=flood.count(429),
               workers_alive=m["gauge.zipkin_tpu.mpWorkersAlive"])
    log(f"phase i6 ({card}): TPU_MP_WORKERS=2 TPU_MP_QUEUE_DEPTH=1 python -m zipkin_tpu_torch.server "
        f"--storage tpu: /health UP in {fig['boot_s']:.1f} s; {quarter} POSTs 202 ({backoffs} "
        f"backoffs on 429), a flood of {len(flood)} got {flood.count(429)} x 429; /metrics "
        f"mpAccepted {per * accepted} = every 202'd span; SIGTERM -> exit 0 in {fig['stop_s']:.2f} s")
    return fig


def wait_ready(ing, what: str = "phase i") -> None:
    """A tier's start is set-up: a worker is ready once it has loaded the
    native parser's library, which it does before its first get."""
    deadline = time.monotonic() + 120
    for p in ing._procs:
        while True:
            with open(f"/proc/{p.pid}/maps") as f:
                if "span_json" in f.read():
                    break
            if time.monotonic() > deadline or not p.is_alive():
                raise AssertionError(f"{what}: a parse worker did not start")
            time.sleep(0.01)


def phase_fanout(seed: int, torch, card: str, stored: dict, fast: dict, cfg=None, device=None,
                 workers=None, entry_argv=None, entry_env=None) -> dict:
    """(i) the parse fan-out, on phase e's 64 payloads at the default
    AggConfig, each sub-phase with its update_step launches counted from 0:

    (i1) ``Collector(fast_ingest=True, mp_ingester=MultiProcessIngester(
         TorchStorage(), workers=1, coalesce_max=1))``, then ``drain()``:
         every state leaf equals phase e's (and so f1's), one update_step
         launch a payload (64);
    (i2) ``workers`` parse workers (``max(1, min(4, cpu_count - 2))``),
         ``coalesce_max=8``: fewer device steps than payloads, update_step
         launches equal to the dispatcher's groups; the integer planes, by
         name, and the reads (dependencies, histogram rows, cardinalities)
         equal i1's; the digest p99s inside their rank band and the rest of
         the store's answers as the generator says; times spans/s, the
         dispatcher's device-feed share and the workers' stage seconds
         against f1's; then once more through the tier's blocking
         ``submit`` (no refusals), timed only;
    (i3) the resume adapter with a WAL dir under the tier (at least two
         workers), one worker SIGKILLed after a quarter of the payloads: no
         acked span lost (2**18 spans counted), and a new adapter on the WAL
         dir replays to the live leaves (the replay's launches printed);
    (i4) an in-process ZipkinServer with ``TPU_MP_WORKERS=2`` and
         ``TPU_MP_QUEUE_DEPTH=1``: 16 payloads POSTed by a client that backs
         off on 429 all get 202; a flood from 4 threads without backoff gets
         at least one 429; ``stop()`` drains and closes the tier before its
         final snapshot, and every 202'd span is in the counters then;
    (i5) ``AsyncIngestFeeder`` over the 64 payloads: every span lands, the
         histogram rows, links and cardinalities equal i1's, and the 1/64
         archive sample reads back; timed against f1;
    (i6) ``python -m zipkin_tpu_torch.server --storage tpu`` with
         ``TPU_MP_WORKERS=2`` as a subprocess (:func:`entry_with_tier`).
    ``entry_argv`` / ``entry_env`` go to i6 (a rehearsal off the card).
    """
    import concurrent.futures
    import dataclasses
    import gc
    import os
    import shutil
    import signal
    import tempfile
    import urllib.error
    import urllib.request

    from zipkin_tpu_torch.collector import Collector
    from zipkin_tpu_torch.ops import hll_kernel
    from zipkin_tpu_torch.server.app import ZipkinServer
    from zipkin_tpu_torch.server.config import ServerConfig
    from zipkin_tpu_torch.storage.tpu import TorchStorage as Adapter
    from zipkin_tpu_torch.tpu.feeder import AsyncIngestFeeder
    from zipkin_tpu_torch.tpu.mp_ingest import IngestBackpressure, MultiProcessIngester
    from zipkin_tpu_torch.tpu.state import AggConfig
    from zipkin_tpu_torch.tpu.store import TorchStorage

    cfg = cfg or AggConfig()
    wire, traffic, spans = stored["wire"], stored["traffic"], stored["spans"]
    n_spans, n_payloads = len(spans), len(wire)
    per = n_spans // n_payloads
    truth = store_truth(traffic, cfg)
    picked = sampled_traces(traffic)
    archived = [s for t in picked for s in spans[8 * t:8 * t + 8]]
    cpus = os.cpu_count() or 1
    workers = workers or max(1, min(4, cpus - 2))
    fig = dict(card=card, spans=n_spans, payloads=n_payloads, cpu_count=cpus, workers=workers,
               f1_spans_per_s=fast["spans_per_s"])
    log(f"phase i ({card}): host cpu_count {cpus}; i2 runs {workers} parse workers")

    def reset():
        hll_kernel.update.launches = hll_kernel.update_step.launches = 0

    def read_launches(what):
        if hll_kernel.update.launches:
            raise AssertionError(f"phase {what}: {hll_kernel.update.launches} single-target launches")
        return hll_kernel.update_step.launches

    def through_collector(collector):
        """Every payload through the collector, backing off 5 ms on the
        tier's backpressure as i4's HTTP client backs off on 429 (a tighter
        in-process retry loop holds the GIL the dispatcher needs); returns
        the refusals."""
        refused = 0
        for p in wire:
            while True:
                try:
                    if collector.accept_spans_bytes(p) != 0:
                        raise AssertionError("the collector did not hand the payload to the tier")
                    break
                except IngestBackpressure:
                    refused += 1
                    time.sleep(0.005)
        return refused

    def tier_run(store, what, blocking=False, **kw):
        """The payloads through the collector into a new tier, or with
        ``blocking`` through the tier's own blocking ``submit`` (the
        library caller's mode, no refusals)."""
        warm = time.perf_counter()
        ing = MultiProcessIngester(store, **kw)
        try:
            collector = Collector(store, fast_ingest=True, mp_ingester=ing)
            wait_ready(ing)
            reset()
            t0 = time.perf_counter()
            if blocking:
                refused = 0
                for p in wire:
                    ing.submit(p)
            else:
                refused = through_collector(collector)
            ing.drain()
            wall = time.perf_counter() - t0
            launches = read_launches(what)
            stats = ing.stats()
        finally:
            ing.close()
        if stats["mpFallbacks"] or stats["mpAccepted"] != n_spans \
                or store.agg.host_counters["spans"] != n_spans:
            raise AssertionError(f"phase {what}: {stats['mpAccepted']} spans accepted, "
                                 f"{stats['mpFallbacks']} fallbacks, want {n_spans} and 0")
        out = dict(wall_ms=wall * 1e3, spans_per_s=n_spans / wall, launches=launches,
                   groups=stats["mpGroups"], coalesced_chunks=stats["mpCoalescedChunks"],
                   refused=refused, spawn_s=t0 - warm,
                   device_feed_share=stats["mpDeviceFeedUs"] / 1e6 / wall,
                   flush_share=stats["mpFlushUs"] / 1e6 / wall,
                   stage_s={k: stats[f"mp{k}Us"] / 1e6
                            for k in ("Parse", "Pack", "Route", "VocabReplay", "DeviceFeed", "Flush")},
                   ring_high_water=stats["mpRingHighWater"])
        if launches != out["groups"]:
            raise AssertionError(f"phase {what}: update_step launches {launches} != "
                                 f"{out['groups']} dispatcher groups")
        return out

    # (i1) one worker, no coalescing: the synchronous path's batches exactly
    s1 = TorchStorage(config=cfg, device=device)
    s1._deps_max_stale_ms = 0.0
    i1 = tier_run(s1, "i1", workers=1, coalesce_max=1)
    if i1["launches"] != n_payloads:
        raise AssertionError(f"phase i1: update_step launches {i1['launches']}, want {n_payloads}")
    assert_leaves_equal(s1.agg.state_arrays(), stored["state"], "phase i1 vs phase e (= f1)")
    if s1._archive.span_count != 8 * len(picked):
        raise AssertionError(f"phase i1: archive holds {s1._archive.span_count} spans, want "
                             f"the 1/64 sample's {8 * len(picked)}")
    planes1 = planes_by_name(s1)
    reads1 = store_reads(s1, truth)
    fig["i1"] = i1
    log(f"phase i1: {n_spans} spans in {n_payloads} payloads through Collector(mp_ingester="
        f"MultiProcessIngester(workers=1, coalesce_max=1)): {i1['spans_per_s']:.0f} spans/s "
        f"({i1['wall_ms']:.0f} ms; f1 {fast['spans_per_s']:.0f}); update_step launches "
        f"{i1['launches']} = groups {i1['groups']}; every state leaf equals phase e's; "
        f"{i1['refused']} backpressure refusals; worker stage s "
        f"{json.dumps({k: round(v, 3) for k, v in i1['stage_s'].items()})}")

    # (i2) coalesced, several workers
    s2 = TorchStorage(config=cfg, device=device)
    s2._deps_max_stale_ms = 0.0
    i2 = tier_run(s2, "i2", workers=workers, coalesce_max=8)
    if not i2["launches"] < n_payloads:
        raise AssertionError(f"phase i2: {i2['launches']} device steps for {n_payloads} payloads: "
                             "nothing coalesced")
    # the store's answers against the generator first: its first
    # dependency read must be a fresh one (one transfer)
    rng = np.random.default_rng(seed)
    checked = check_store_answers(s2, s2.agg, truth, spans,
                                  rng.choice(picked, min(64, len(picked)), replace=False),
                                  "phase i2", archived=archived)
    planes2 = planes_by_name(s2)
    for name in planes1:
        if planes2[name] != planes1[name]:
            raise AssertionError(f"phase i2: the {name} plane differs from i1's (by name)")
    reads2 = store_reads(s2, truth)
    by_row = lambda rows: {(r["serviceName"], r["spanName"]): r for r in rows}  # noqa: E731
    for name in ("dependencies", "cardinalities"):
        if reads2[name] != reads1[name]:
            raise AssertionError(f"phase i2: the {name} read differs from i1's")
    if by_row(reads2["hist"]) != by_row(reads1["hist"]):
        raise AssertionError("phase i2: histogram rows differ from i1's")
    if {k: r["count"] for k, r in by_row(reads2["digest"]).items()} != \
            {k: r["count"] for k, r in by_row(reads1["digest"]).items()}:
        raise AssertionError("phase i2: digest row counts differ from i1's")
    i2["digest_checked"] = checked["digest_checked"]
    fig["i2"] = i2
    log(f"phase i2: {workers} workers, coalesce_max=8: {i2['spans_per_s']:.0f} spans/s "
        f"({i2['wall_ms']:.0f} ms; {i2['spans_per_s'] / fast['spans_per_s']:.2f}x f1, "
        f"{i2['spans_per_s'] / i1['spans_per_s']:.2f}x i1); {i2['groups']} device steps "
        f"({i2['coalesced_chunks']} chunks in coalesced groups) = update_step launches "
        f"{i2['launches']}; device feed {100 * i2['device_feed_share']:.1f}% of the wall, group "
        f"flush {100 * i2['flush_share']:.1f}%; worker stage s "
        f"{json.dumps({k: round(v, 3) for k, v in i2['stage_s'].items()})}; ring high water "
        f"{i2['ring_high_water']}; {i2['refused']} refusals; integer planes by name and the "
        f"reads equal i1's; {checked['digest_checked']} digest p99s in their rank band")
    del s1, s2, planes1, planes2
    gc.collect()
    torch.cuda.empty_cache()
    # the same tier fed through its blocking submit: no refusals to retry
    s2b = TorchStorage(config=cfg, device=device)
    i2b = tier_run(s2b, "i2 blocking", blocking=True, workers=workers, coalesce_max=8)
    if s2b.agg.host_counters["spans"] != n_spans:
        raise AssertionError(f"phase i2 blocking: {s2b.agg.host_counters['spans']} spans")
    fig["i2_blocking"] = i2b
    del s2b
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase i2, the tier's blocking submit: {i2b['spans_per_s']:.0f} spans/s "
        f"({i2b['wall_ms']:.0f} ms; {i2b['spans_per_s'] / fast['spans_per_s']:.2f}x f1); "
        f"{i2b['groups']} device steps = update_step launches {i2b['launches']}; device feed "
        f"{100 * i2b['device_feed_share']:.1f}% of the wall, group flush "
        f"{100 * i2b['flush_share']:.1f}%")

    # (i3) a WAL under the tier and a worker SIGKILLed mid-run
    root = tempfile.mkdtemp(prefix="zt-fanout-")
    try:
        adapter = Adapter(config=cfg, device=device, wal_dir=os.path.join(root, "wal"))
        w3 = max(2, workers)
        blocks = []
        batched = adapter.wal.batched

        def counted_batched():
            blocks.append(1)
            return batched()

        adapter.wal.batched = counted_batched  # a pass with several groups logs them in one block
        ing = MultiProcessIngester(adapter, workers=w3, coalesce_max=8)
        wait_ready(ing)
        reset()
        t0 = time.perf_counter()
        try:
            for k, p in enumerate(wire):
                if k == n_payloads // 4:
                    os.kill(ing._procs[0].pid, signal.SIGKILL)
                ing.submit(p)
            ing.drain()
            wall = time.perf_counter() - t0
            launches = read_launches("i3")
            stats = ing.stats()
        finally:
            ing.close()
        if adapter.agg.host_counters["spans"] != n_spans or stats["mpWorkersAlive"] != w3 - 1:
            raise AssertionError(f"phase i3: {adapter.agg.host_counters['spans']} spans counted "
                                 f"after the kill, want {n_spans}; {stats['mpWorkersAlive']} alive")
        adapter.agg.flush_now()  # a logged marker, so the replay ends flushed too
        leaves = adapter.agg.state_arrays()
        adapter.close()
        del adapter
        reset()
        t1 = time.perf_counter()
        revived = Adapter(config=cfg, device=device, wal_dir=os.path.join(root, "wal"))
        boot_s = time.perf_counter() - t1
        replay_launches = read_launches("i3 replay")
        assert_leaves_equal(revived.agg.state_arrays(), leaves, "phase i3 replay vs live")
        if revived.agg.host_counters["spans"] != n_spans:
            raise AssertionError(f"phase i3: the replay counts {revived.agg.host_counters['spans']}")
        records = revived.restore_stats["walReplayBatches"]
        revived.close()
        del revived, leaves
    finally:
        shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    fig["i3"] = dict(wall_ms=wall * 1e3, workers=w3, launches=launches, groups=stats["mpGroups"],
                     fallbacks=stats["mpFallbacks"], ring_discarded=stats["mpRingDiscarded"],
                     ring_torn=stats["mpRingTorn"], wal_batched_blocks=len(blocks),
                     replay_records=records,
                     replay_launches=replay_launches, boot_s=boot_s)
    log(f"phase i3: {w3} workers over a WAL, worker 0 SIGKILLed after {n_payloads // 4} payloads: "
        f"{n_spans} spans counted, none lost ({stats['mpFallbacks']} payloads re-ingested on the "
        f"object path, {stats['mpRingDiscarded']} ring slots discarded, {stats['mpRingTorn']} torn); "
        f"{stats['mpGroups']} groups ({len(blocks)} passes logged several groups in one "
        f"wal.batched() block), update_step launches {launches}; a new adapter replays "
        f"{records} records in {boot_s:.2f} s with {replay_launches} update_step launches to "
        f"the live leaves")

    # (i4) the server, its backpressure and its stop
    root = tempfile.mkdtemp(prefix="zt-fanout-srv-")
    config = ServerConfig(host="127.0.0.1", port=0, storage_type="tpu", tpu_fast_ingest=True,
                          tpu_mp_workers=2, tpu_mp_queue_depth=1, tpu_archive_dir=None,
                          tpu_checkpoint_dir=os.path.join(root, "snap"),
                          tpu_snapshot_interval_s=3600.0, tpu_scrub_interval_s=0.0,
                          obs_shadow_enabled=False, tpu_agg=dataclasses.asdict(cfg))
    storage = None
    if device is not None:  # a rehearsal off the card
        storage = Adapter(config=cfg, device=device, checkpoint_dir=os.path.join(root, "snap"))
    try:
        reset()
        server = ZipkinServer(config, storage=storage, seal_interval_s=0).start()
        store, base = server.storage, f"http://127.0.0.1:{server.port}"
        ing = server._mp_ingester
        if ing is None or store.mp_ingester is not ing:
            raise AssertionError("phase i4: the server did not build the tier")
        calls = []

        def spy(name, fn):
            def run(*a, **k):
                calls.append((name, store.agg.host_counters["spans"]))
                return fn(*a, **k)
            return run

        ing.drain, ing.close = spy("drain", ing.drain), spy("close", ing.close)
        store.snapshot = spy("snapshot", store.snapshot)
        wait_ready(ing)

        def post(body):
            req = urllib.request.Request(base + "/api/v2/spans", data=body, method="POST",
                                         headers={"Content-Type": "application/x-protobuf"
                                                  if body[:1] == b"\n" else "application/json"})
            try:
                with urllib.request.urlopen(req, timeout=120) as resp:
                    return resp.status
            except urllib.error.HTTPError as e:
                return e.code

        accepted = backoffs = 0
        t0 = time.perf_counter()
        for p in wire[:16]:
            while (status := post(p)) == 429:
                backoffs += 1
                time.sleep(0.005)
            if status != 202:
                raise AssertionError(f"phase i4: POST answered {status}")
            accepted += 1
        post_s = time.perf_counter() - t0
        with concurrent.futures.ThreadPoolExecutor(4) as pool:
            flood = list(pool.map(post, wire[16:48]))
        if set(flood) - {202, 429} or 429 not in flood:
            raise AssertionError(f"phase i4: the flood got {sorted(set(flood))}, want 202s and 429s")
        accepted += flood.count(202)
        m = json.loads(urllib.request.urlopen(base + "/metrics", timeout=60).read())
        t1 = time.perf_counter()
        server.stop()
        stop_s = time.perf_counter() - t1
        order = [n for n, _ in calls]
        if order != ["drain", "close", "snapshot"] or dict(calls)["snapshot"] != per * accepted:
            raise AssertionError(f"phase i4: stop() ran {calls}, want drain, close, snapshot "
                                 f"with {per * accepted} spans")
        launches = read_launches("i4")
        if launches != ing.counters["groups"]:
            raise AssertionError(f"phase i4: update_step launches {launches} != "
                                 f"{ing.counters['groups']} dispatcher groups")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    fig["i4"] = dict(posted=16, backoffs=backoffs, post_s=post_s, flood=len(flood),
                     flood_429=flood.count(429), accepted=accepted, stop_s=stop_s, launches=launches,
                     mp_rejected=m.get("gauge.zipkin_tpu.mpRejected"))
    del server, store, storage, ing
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase i4: server with TPU_MP_WORKERS=2, TPU_MP_QUEUE_DEPTH=1: 16 POSTs all 202 "
        f"({backoffs} backoffs on 429, {post_s:.2f} s); a flood of {len(flood)} from 4 threads got "
        f"{flood.count(429)} x 429 and {flood.count(202)} x 202 (mpRejected "
        f"{fig['i4']['mp_rejected']}); stop() in {stop_s:.2f} s ran drain, close, then the final "
        f"snapshot with all {per * accepted} accepted spans; update_step launches {launches}")

    # (i6) the entry point with the tier, as a subprocess
    fig["i6"] = entry_with_tier(card, wire[:32], per, argv=entry_argv, env_extra=entry_env)

    # (i5) the threaded feeder
    s5 = TorchStorage(config=cfg, device=device)
    s5._deps_max_stale_ms = 0.0
    reset()
    t0 = time.perf_counter()
    with AsyncIngestFeeder(s5, depth=4) as feeder:
        for p in wire:
            feeder.submit(p)
    wall = time.perf_counter() - t0
    launches = read_launches("i5")
    if feeder._accepted != n_spans or s5.agg.host_counters["spans"] != n_spans or feeder._fallback:
        raise AssertionError(f"phase i5: the feeder accepted {feeder._accepted}, "
                             f"fell back {feeder._fallback}")
    if launches != n_payloads:
        raise AssertionError(f"phase i5: update_step launches {launches}, want {n_payloads}")
    reads5 = store_reads(s5, truth)
    if reads5["dependencies"] != reads1["dependencies"] or \
            reads5["cardinalities"] != reads1["cardinalities"] or \
            by_row(reads5["hist"]) != by_row(reads1["hist"]):
        raise AssertionError("phase i5: the feeder's reads differ from i1's")
    t = int(picked[0])
    want = sorted(s.id for s in spans[8 * t:8 * t + 8])
    if sorted(s.id for s in s5.get_trace(spans[8 * t].trace_id).execute()) != want:
        raise AssertionError("phase i5: a sampled trace did not read back")
    fig["i5"] = dict(wall_ms=wall * 1e3, spans_per_s=n_spans / wall, launches=launches)
    del s5
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase i5: AsyncIngestFeeder(depth=4): {fig['i5']['spans_per_s']:.0f} spans/s "
        f"({wall * 1e3:.0f} ms; {fig['i5']['spans_per_s'] / fast['spans_per_s']:.2f}x f1); "
        f"update_step launches {launches}; the reads equal i1's; a sampled trace reads back")
    fig["launches"] = (i1["launches"] + i2["launches"] + i2b["launches"] + fig["i3"]["launches"]
                       + fig["i3"]["replay_launches"] + fig["i4"]["launches"] + fig["i5"]["launches"])
    return fig


def obs_switch(on: bool, store=None) -> None:
    """The observability plane on or off as ``TPU_OBS`` sets it at boot:
    the flight recorder, the device observatory and, for ``store``, its
    query plane (traces and the lock ledger)."""
    from zipkin_tpu_torch import obs
    from zipkin_tpu_torch.obs.device import OBSERVATORY

    obs.RECORDER.set_enabled(on)
    OBSERVATORY.set_enabled(on)
    if store is not None:
        store.set_query_observatory(on)


def paired_runs(run, pairs: int = 5) -> list:
    """One warm-up ``run(True)``, marked and left out of the timing, then
    ``pairs`` pairs of ``run(on)``, the side that goes first alternating
    (on, off), (off, on), ..."""
    runs = [dict(run(True), warmup=True)]
    for k in range(pairs):
        for on in ((True, False) if k % 2 == 0 else (False, True)):
            runs.append(dict(run(on), warmup=False))
    return runs


def on_off_verdict(runs) -> dict:
    """The plane's cost from :func:`paired_runs`: each pair's on/off
    spans/s, their median and range. The cost is resolved only where the
    range lies on one side of 1; where it spans 1, the run-to-run spread is
    wider than the effect."""
    timed = [r for r in runs if not r["warmup"]]
    ratios = []
    for a, b in zip(timed[::2], timed[1::2]):
        on, off = (a, b) if a["on"] else (b, a)
        ratios.append(on["spans_per_s"] / off["spans_per_s"])
    lo, hi = min(ratios), max(ratios)
    return dict(pair_ratios=ratios, median_ratio=statistics.median(ratios), ratio_lo=lo,
                ratio_hi=hi, resolved=hi < 1.0 or lo > 1.0)


def verdict_text(v: dict) -> str:
    return (f"on/off by pair {', '.join(f'{r:.3f}' for r in v['pair_ratios'])}: median "
            f"{v['median_ratio']:.3f}, range {v['ratio_lo']:.3f}-{v['ratio_hi']:.3f} "
            + ("(unresolved: the range spans 1)" if not v["resolved"] else
               "(resolved: on slower in every pair)" if v["ratio_hi"] < 1.0 else
               "(resolved: on faster in every pair, which the plane cannot cause)"))


def wrap_cost_ns(torch, device, n: int = 2000) -> float:
    """The device observatory's own host ns a wrapped call: a no-op on a
    tensor of ``device`` through a private observatory's wrapper (two CUDA
    events recorded on the card, none off it, and the query-trace stamp),
    less the bare call."""
    from zipkin_tpu_torch.obs.device import DeviceObservatory

    x = torch.zeros(1, device=device)
    noop = lambda t: t  # noqa: E731
    wrapped = DeviceObservatory().wrap("probe", noop)

    def loop(fn):
        t0 = time.perf_counter_ns()
        for _ in range(n):
            fn(x)
        return time.perf_counter_ns() - t0

    loop(wrapped)
    loop(noop)
    return (loop(wrapped) - loop(noop)) / n


def phase_obs_cost(torch, card: str, stored: dict, a2_ms: float, cfg=None, device=None) -> dict:
    """(j1) the recorder's cost on the line-rate path: phase e's payloads
    through ``Collector(fast_ingest=True)`` into a fresh TorchStorage a run,
    with the plane on (the recorder, the device observatory, the query
    plane and a shadow tap on the store) and with all of it off: one
    warm-up run, then five pairs, the side that goes first alternating
    (:func:`paired_runs`). Prints spans/s of each run, each pair's on/off
    ratio with their median and range (:func:`on_off_verdict`), and the
    plane's own host cost: the recorder's ns a record and the observatory
    wrapper's ns a call (:func:`wrap_cost_ns`), times the records and
    wrapped calls a payload made, against a payload's wall, and the
    wrapped programs' host wall a call. Then, over the on runs, holds the
    device observatory's ``hll_update_step`` calls to the launches
    ``update_step.launches`` counted, every CUDA event pair resolved and
    positive, and prints the mean event ms a call beside phase a2's
    profiler ms."""
    from zipkin_tpu_torch import obs
    from zipkin_tpu_torch.collector import Collector
    from zipkin_tpu_torch.obs.device import OBSERVATORY
    from zipkin_tpu_torch.obs.shadow import HostShadow
    from zipkin_tpu_torch.ops import hll_kernel
    from zipkin_tpu_torch.tpu.state import AggConfig
    from zipkin_tpu_torch.tpu.store import TorchStorage

    cfg = cfg or AggConfig()
    wire, n_spans = stored["wire"], len(stored["spans"])
    OBSERVATORY.reset_counters()
    on_totals = dict(launches=0, records=0, calls=0, payloads=0, wall_s=0.0)

    def run(on):
        store = TorchStorage(config=cfg, device=device)
        obs_switch(on, store)
        if on:
            store.shadow = HostShadow(max_services=cfg.max_services,
                                      svc_resolver=store.vocab.services.get,
                                      pending_max=len(wire))
        collector = Collector(store, fast_ingest=True)
        mem_gb = torch.cuda.memory_allocated() / 1e9  # what earlier runs left on the card
        records0 = obs.RECORDER.snapshot().total_count
        calls0 = OBSERVATORY.totals()["calls"]
        hll_kernel.update.launches = hll_kernel.update_step.launches = 0
        t0 = time.perf_counter()
        for p in wire:
            collector.accept_spans_bytes(p)
        store.agg.block_until_ready()
        wall = time.perf_counter() - t0
        launches = hll_kernel.update_step.launches
        if store.agg.host_counters["spans"] != n_spans:
            raise AssertionError(f"phase j1: {store.agg.host_counters['spans']} spans landed")
        if on:
            if store.shadow.counters()["shadowOfferedBatches"] != launches:
                raise AssertionError("phase j1: the shadow tap missed a device batch")
            on_totals["launches"] += launches
            on_totals["records"] += obs.RECORDER.snapshot().total_count - records0
            on_totals["calls"] += OBSERVATORY.totals()["calls"] - calls0
            on_totals["payloads"] += len(wire)
            on_totals["wall_s"] += wall
        out = dict(on=on, spans_per_s=n_spans / wall, wall_ms=wall * 1e3, launches=launches,
                   update_launches=hll_kernel.update.launches, mem_gb=mem_gb)
        del store, collector
        torch.cuda.empty_cache()
        return out

    try:
        runs = paired_runs(run)
    finally:
        obs_switch(True)
    torch.cuda.synchronize()
    progs = OBSERVATORY.programs()
    prog = progs["hll_update_step"]
    launches_on = on_totals["launches"]
    if prog["calls"] != launches_on or prog["deviceCalls"] != launches_on or prog["eventsDropped"]:
        raise AssertionError(f"phase j1: the observatory saw {prog}, update_step launched "
                             f"{launches_on} times in the on runs")
    if prog["minDeviceMs"] <= 0.0:
        raise AssertionError(f"phase j1: a CUDA event pair resolved to {prog['minDeviceMs']} ms")
    verdict = on_off_verdict(runs)
    rec_ns = obs.RECORDER.measure_overhead()
    wrap_ns = wrap_cost_ns(torch, device or "cuda")
    payloads = on_totals["payloads"]
    records_pp = on_totals["records"] / payloads
    calls_pp = on_totals["calls"] / payloads
    plane_us_pp = (rec_ns * records_pp + wrap_ns * calls_pp) / 1e3
    wall_us_pp = on_totals["wall_s"] * 1e6 / payloads
    call_wall_ms = {k: v["callWallMs"] / v["calls"] for k, v in progs.items()
                    if v["calls"] and (k.startswith("spmd_step") or k == "hll_update_step")}
    fig = dict(card=card, runs=runs, **verdict, overhead_ns_per_record=rec_ns,
               wrap_ns_per_call=wrap_ns, records_per_payload=records_pp,
               wrapped_calls_per_payload=calls_pp, plane_host_us_per_payload=plane_us_pp,
               wall_us_per_payload=wall_us_pp, call_wall_ms=call_wall_ms,
               kernel_calls=prog["calls"], kernel_event_ms=prog["meanDeviceMs"],
               kernel_event_min_ms=prog["minDeviceMs"], kernel_event_max_ms=prog["maxDeviceMs"],
               a2_profiler_ms=a2_ms, launches=sum(r["launches"] for r in runs),
               update_launches=sum(r["update_launches"] for r in runs))
    log(f"phase j1 ({card}): f1's path, a warm-up and five pairs, plane on/off: spans/s "
        + ", ".join(f"{'warm-up ' if r['warmup'] else ''}{'on' if r['on'] else 'off'} "
                    f"{r['spans_per_s']:.0f}" for r in runs)
        + "; GB allocated at each run's start "
        + ", ".join(f"{r['mem_gb']:.2f}" for r in runs)
        + f"; {verdict_text(verdict)}; the plane's own host cost: recorder {rec_ns:.0f} ns a "
        f"record x {records_pp:.1f} records a payload + observatory wrapper {wrap_ns:.0f} ns a "
        f"call x {calls_pp:.1f} wrapped calls a payload = {plane_us_pp:.1f} us of a payload's "
        f"{wall_us_pp:.0f} us ({100 * plane_us_pp / wall_us_pp:.2f}%); host wall a call, ms: "
        f"{json.dumps({k: round(v, 4) for k, v in call_wall_ms.items()})}; hll_update_step "
        f"observed {prog['calls']} calls = {launches_on} launches, every event pair resolved: "
        f"{prog['meanDeviceMs']:.5f} ms a call on CUDA events (min {prog['minDeviceMs']:.5f}, "
        f"max {prog['maxDeviceMs']:.5f}) beside phase a2's profiler {a2_ms:.5f} ms")
    return fig


def obs_server_config(cfg, **extra):
    """The in-process server of phase j: the line-rate path, no disk
    archive, windows every 0.5 s, the accuracy rollup every second with an
    exact distinct shadow, slow-stage self-spans and self-tracing at a
    budget scale that puts stages over budget."""
    import dataclasses

    from zipkin_tpu_torch.server.config import ServerConfig

    return ServerConfig(host="127.0.0.1", port=0, storage_type="tpu", tpu_fast_ingest=True,
                        tpu_archive_dir=None, tpu_deps_max_stale_ms=0.0,
                        obs_windows_tick_s=0.5, obs_shadow_rollup_s=1.0,
                        obs_shadow_distinct_k=1 << 16, obs_selfspans_enabled=True,
                        self_tracing_enabled=True, obs_budget_scale=1e-4,
                        tpu_agg=dataclasses.asdict(cfg), **extra)


def post_full(base: str, body: bytes, headers=None, timeout: float = 300.0):
    """(status, headers, body bytes) of one POST of spans."""
    import urllib.error
    import urllib.request

    ctype = "application/x-protobuf" if body[:1] == b"\n" else "application/json"
    req = urllib.request.Request(base + "/api/v2/spans", data=body, method="POST",
                                 headers={"Content-Type": ctype, **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def post_body(base: str, body: bytes, headers=None) -> int:
    return post_full(base, body, headers)[0]


def phase_obs_server(seed: int, torch, card: str, stored: dict, cfg=None, device=None) -> dict:
    """(j2) the planes through an in-process server (:func:`obs_server_config`):
    phase e's payloads POSTed with B3 headers, fresh and cached reads of
    dependencies, percentiles, cardinalities and the overview, then, after
    at least 3 ticks and a rollup, statusz and /prometheus: the stage table,
    the device section (the kernel's calls = its launches, live device
    memory), the windows, every default SLO with a verdict, the accuracy
    plane (the HLL error within 3 standard errors plus the bias of the exact
    distinct count), a query trace of each read kind, the self-spans under
    the posted trace, and the exposition's families."""
    import tempfile
    import urllib.request

    from zipkin_tpu_torch.obs.device import OBSERVATORY
    from zipkin_tpu_torch.obs.slo import default_specs
    from zipkin_tpu_torch.ops import hll, hll_kernel
    from zipkin_tpu_torch.server.app import ZipkinServer
    from zipkin_tpu_torch.tpu.state import AggConfig

    cfg = cfg or AggConfig()
    wire, traffic = stored["wire"], stored["traffic"]
    truth = store_truth(traffic, cfg)
    incidents = tempfile.mkdtemp(prefix="zt-incidents-")
    storage = None
    if device is not None:  # a rehearsal off the card
        from zipkin_tpu_torch.tpu.store import TorchStorage

        storage = TorchStorage(config=cfg, device=device, deps_max_stale_ms=0.0)
    OBSERVATORY.reset_counters()
    hll_kernel.update.launches = hll_kernel.update_step.launches = 0
    server = ZipkinServer(obs_server_config(cfg, obs_incident_dir=incidents), storage=storage,
                          seal_interval_s=0.5).start()
    base = f"http://127.0.0.1:{server.port}"
    http = HttpStore(base)
    trace_id = "00000000feedface"
    b3 = {"X-B3-TraceId": trace_id, "X-B3-SpanId": "00000000000000b3"}
    try:
        t0 = time.perf_counter()
        statuses = [post_body(base, p, b3) for p in wire]
        post_s = time.perf_counter() - t0
        if statuses != [202] * len(wire):
            raise AssertionError(f"phase j2: POST statuses {sorted(set(statuses))}")
        window = {"endTs": truth.t_end, "lookback": truth.lookback}
        # the lock path's waterfalls (FRESH): phase k3 reads the mirror's
        reads = {"dependencies": ("/api/v2/dependencies", {**window, **FRESH}),
                 "quantiles": ("/api/v2/tpu/percentiles", {"q": "0.5,0.99", **FRESH}),
                 "cardinalities": ("/api/v2/tpu/cardinalities", FRESH),
                 "overview": ("/api/v2/tpu/overview", {"q": "0.5", **FRESH})}
        # each kind's fresh and cached read, then statusz: its stitch folds
        # what the ticker has not, so the slowest query folded since the
        # last read of the page is of this kind (a sealed-only window reads
        # no device and takes no lock: its waterfall has no device segment)
        waterfalls = {}
        queries = http.get("/api/v2/tpu/statusz")["queries"]["queries"]
        for kind, (path, params) in reads.items():
            http.get(path, params)  # fresh
            http.get(path, params)  # cached
            wf = http.get("/api/v2/tpu/statusz")["queries"]
            waterfalls[kind] = (wf["queries"] - queries, wf["slowest"])
            queries = wf["queries"]
        ticks0 = http.get("/api/v2/tpu/statusz")["windows"]["ticks"]
        deadline = time.monotonic() + 60
        while True:
            # the self-span emitter's thread may launch the kernel at any
            # time: statusz's count lies between the launches around it
            seen_before = hll_kernel.update_step.launches
            st = http.get("/api/v2/tpu/statusz")
            seen_after = hll_kernel.update_step.launches
            acc = st["accuracy"]
            if (st["windows"]["ticks"] >= ticks0 + 3 and acc["gauges"]["accuracyRollups"] >= 1
                    and acc["shadow"]["shadowPending"] == 0 and acc["shadow"]["shadowSpans"] > 0):
                break
            if time.monotonic() > deadline:
                raise AssertionError(f"phase j2: no 3 ticks and a rollup within 60 s: "
                                     f"{st['windows']['ticks']} ticks, {acc['gauges']}")
            time.sleep(0.1)
        prom = urllib.request.urlopen(base + "/prometheus", timeout=60).read().decode()
        trace = http.get(f"/api/v2/trace/{trace_id}")
    finally:
        server.stop()
    torch.cuda.synchronize()
    # stopped: the emitter flushed its last spans, so the counts are final
    launches, update_launches = hll_kernel.update_step.launches, hll_kernel.update.launches
    final = OBSERVATORY.programs()["hll_update_step"]

    stages = st["stages"]
    want = ("http_boundary", "parse", "pack", "device_dispatch", "archive_write", "query_fresh",
            "query_cached", "readpack_transfer")
    if [s for s in want if not stages[s]["count"]]:
        raise AssertionError(f"phase j2: stages without a count: {[s for s in want if not stages[s]['count']]}")
    progs = st["device"]["programs"]
    if not any(k.startswith("spmd_step") and v["calls"] for k, v in progs.items()):
        raise AssertionError("phase j2: no spmd_step program in the device section")
    kern = progs.get("hll_update_step", {})
    if not seen_before <= kern.get("calls", -1) <= seen_after or final["calls"] != launches \
            or final["deviceCalls"] != launches or not launches or final["minDeviceMs"] <= 0.0:
        raise AssertionError(f"phase j2: statusz shows {kern.get('calls')} hll_update_step calls "
                             f"(launches {seen_before}..{seen_after} around it), {final['calls']} at "
                             f"the end against {launches} launches")
    if st["device"]["hbm"].get("bytesInUse", 0) <= 0:
        raise AssertionError(f"phase j2: device memory {st['device']['hbm']}")
    rates = st["windows"]["lookbacks"]["60s"]["rates"]
    if rates.get("spansPerSec", 0.0) <= 0.0:
        raise AssertionError(f"phase j2: windowed rates {rates}")
    names = [v["name"] for v in st["slo"]["specs"]]
    if names != [s.name for s in default_specs()] or any(
            not isinstance(v["alert"], bool) for v in st["slo"]["specs"]):
        raise AssertionError(f"phase j2: SLO verdicts {names}")
    g = acc["gauges"]
    band = 3.0 * hll.standard_error(cfg.hll_precision) + hll.bias_fraction(truth.n_traces)
    if acc["suppressed"] or acc["shadow"]["shadowDistinctTheta"] != 1.0 or not (
            0.0 <= g["accuracyHllRelErr"] <= band):
        raise AssertionError(f"phase j2: accuracy {g}, band {band}, shadow {acc['shadow']}")
    bad = {k: v for k, v in waterfalls.items()
           if v[0] != 2 or v[1]["name"] != k or "cache_probe" not in v[1]["segments"]}
    if bad:
        raise AssertionError(f"phase j2: the waterfalls of {sorted(bad)}: {bad}")
    services = {s["localEndpoint"]["serviceName"] for s in trace}
    if not {"zipkin-server", "zipkin-tpu-pipeline"} <= services:
        raise AssertionError(f"phase j2: trace {trace_id} holds {services}")
    families = {line.split()[2] for line in prom.splitlines() if line.startswith("# TYPE")}
    for fam in ("zipkin_tpu_stage_latency_seconds", "zipkin_tpu_host_transfer_bytes",
                "zipkin_tpu_slo_alert", "zipkin_tpu_slo_burn_rate"):
        if fam not in families:
            raise AssertionError(f"phase j2: /prometheus lacks {fam}")
    if not [f for f in families if f.startswith("zipkin_tpu_device_")]:
        raise AssertionError("phase j2: /prometheus lacks zipkin_tpu_device_*")
    fig = dict(card=card, post_s=post_s, post_spans_per_s=len(stored["spans"]) / post_s,
               launches=launches, update_launches=update_launches, kernel_event_ms=final["meanDeviceMs"],
               hll_rel_err=g["accuracyHllRelErr"], hll_band=band,
               digest_p99_rel_err=g["accuracyDigestP99RelErr"], link_recall=g["accuracyLinkRecall"],
               rollup_ms=g["accuracyRollupMs"], ticks=st["windows"]["ticks"],
               spans_per_s_60s=rates["spansPerSec"], hbm_bytes=st["device"]["hbm"]["bytesInUse"],
               slo_alerts=[v["name"] for v in st["slo"]["specs"] if v["alert"]],
               incidents=st["incidents"]["incidentsCaptured"],
               stage_p50_us={s: stages[s]["p50Us"] for s in want},
               self_spans=st["recorder"]["selfSpansEmitted"], families=len(families),
               waterfalls={k: v[1] for k, v in waterfalls.items()})
    log(f"phase j2 ({card}): {len(wire)} POSTs with B3 ({fig['post_spans_per_s']:.0f} spans/s), "
        f"fresh and cached reads, {fig['ticks']} ticks: stages p50 us "
        f"{json.dumps(fig['stage_p50_us'])}; hll_update_step {launches} calls = launches, "
        f"{final['meanDeviceMs']:.5f} ms a call on events; device memory {fig['hbm_bytes']} B; "
        f"spans/s over 60 s {rates['spansPerSec']:.0f}; {len(names)} SLOs (alerting "
        f"{fig['slo_alerts']}, {fig['incidents']} incident bundles); accuracy: HLL rel err "
        f"{g['accuracyHllRelErr']:.5f} within {band:.5f}, digest p99 rel err "
        f"{g['accuracyDigestP99RelErr']:.4f}, link recall {g['accuracyLinkRecall']:.3f}, rollup "
        f"{g['accuracyRollupMs']:.1f} ms; slowest query of each kind, us: "
        f"{json.dumps({k: v[1]['wallUs'] for k, v in waterfalls.items()})}; "
        f"{fig['self_spans']} self-spans, the pipeline's and the request's under {trace_id}; "
        f"/prometheus {len(families)} families")
    return fig


def phase_obs_tier(torch, card: str, stored: dict, cfg=None, device=None, workers: int = 2) -> dict:
    """(j3) the server of j2 with ``TPU_MP_WORKERS=2``: 16 of phase e's
    payloads (a client that backs off on 429): the workers' ``parse``,
    ``pack`` and ``route`` relayed into the recorder, the dispatcher's
    ``mp_*`` stages counted, the shadow offered the dispatcher's images,
    and statusz's ``workers`` rows holding every span."""
    from zipkin_tpu_torch import obs
    from zipkin_tpu_torch.ops import hll_kernel
    from zipkin_tpu_torch.server.app import ZipkinServer
    from zipkin_tpu_torch.tpu.state import AggConfig

    cfg = cfg or AggConfig()
    wire = stored["wire"][:16]
    per = len(stored["spans"]) // len(stored["wire"])
    storage = None
    if device is not None:  # a rehearsal off the card
        from zipkin_tpu_torch.tpu.store import TorchStorage

        storage = TorchStorage(config=cfg, device=device, deps_max_stale_ms=0.0)
    before = obs.RECORDER.snapshot()
    hll_kernel.update.launches = hll_kernel.update_step.launches = 0
    server = ZipkinServer(obs_server_config(cfg, tpu_mp_workers=workers), storage=storage,
                          seal_interval_s=0.5).start()
    base = f"http://127.0.0.1:{server.port}"
    try:
        ing = server._mp_ingester
        if ing is None:
            raise AssertionError("phase j3: the server did not build the tier")
        wait_ready(ing, "phase j3")
        backoffs = 0
        for p in wire:
            while (status := post_body(base, p)) == 429:
                backoffs += 1
                time.sleep(0.005)
            if status != 202:
                raise AssertionError(f"phase j3: POST answered {status}")
        ing.drain()
        st = HttpStore(base).get("/api/v2/tpu/statusz")
        shadow = server._obs_shadow.counters()
        groups = ing.counters["groups"]
    finally:
        server.stop()
    launches, update_launches = hll_kernel.update_step.launches, hll_kernel.update.launches
    after = obs.RECORDER.snapshot()
    ran = {s: after.stage(s).count - before.stage(s).count
           for s in ("parse", "pack", "route", "mp_vocab_replay", "mp_device_feed", "mp_record",
                     "mp_lut_remap", "coalesce", "mp_shm_copy")}
    if not all(ran[s] for s in ("parse", "pack", "route", "mp_vocab_replay", "mp_device_feed")) \
            or ran["mp_record"] != len(wire) or ran["mp_lut_remap"] + ran["coalesce"] != groups:
        raise AssertionError(f"phase j3: stage counts {ran}, {groups} groups")
    if shadow["shadowOfferedBatches"] < groups:
        raise AssertionError(f"phase j3: the shadow was offered {shadow['shadowOfferedBatches']} images")
    rows = st.get("workers", [])
    if [w["widx"] for w in rows] != list(range(workers)) or sum(w["spans"] for w in rows) != per * len(wire):
        raise AssertionError(f"phase j3: workers {rows}")
    fig = dict(card=card, stages=ran, groups=groups, launches=launches,
               update_launches=update_launches, backoffs=backoffs,
               shadow_offered=shadow["shadowOfferedBatches"],
               worker_spans=[w["spans"] for w in rows])
    log(f"phase j3 ({card}): TPU_MP_WORKERS={workers}, {len(wire)} POSTs ({backoffs} backoffs): "
        f"stage counts {json.dumps(ran)}; {groups} groups, update_step launches {launches}; the "
        f"shadow offered {shadow['shadowOfferedBatches']} dispatcher images; workers' spans "
        f"{fig['worker_spans']}")
    return fig


def phase_obs_tier_cost(torch, card: str, stored: dict, cfg=None, device=None,
                        workers=None) -> dict:
    """(j5) the plane's cost on the fan-out tier: i2's path (``workers``
    parse workers, ``coalesce_max=8``, the tier's blocking ``submit``) into
    one store, phase e's payloads a pass, the plane on (the recorder, the
    device observatory, the query plane and a HostShadow on the store's and
    the dispatcher's taps, as the server wires it) and off: one warm-up
    pass, then five pairs, the side that goes first alternating
    (:func:`paired_runs`). The shadow folds what it was offered between
    passes, off the clock; the server's accuracy rollup, which does that
    on the ticker every ``TPU_OBS_SHADOW_ROLLUP_S`` and reads the device,
    is not in the timed passes. Each pass's update_step launches equal its
    dispatcher groups; every pass's spans land."""
    import os

    from zipkin_tpu_torch.obs.shadow import HostShadow
    from zipkin_tpu_torch.ops import hll_kernel
    from zipkin_tpu_torch.tpu.mp_ingest import MultiProcessIngester
    from zipkin_tpu_torch.tpu.state import AggConfig
    from zipkin_tpu_torch.tpu.store import TorchStorage

    cfg = cfg or AggConfig()
    wire, n_spans = stored["wire"], len(stored["spans"])
    workers = workers or max(1, min(4, (os.cpu_count() or 1) - 2))
    store = TorchStorage(config=cfg, device=device)
    shadow = HostShadow(max_services=cfg.max_services, svc_resolver=store.vocab.services.get,
                        pending_max=2 * len(wire))
    ing = MultiProcessIngester(store, workers=workers, coalesce_max=8)

    def run(on):
        obs_switch(on, store)
        store.shadow = ing.shadow = shadow if on else None
        offered0 = shadow.counters()["shadowOfferedBatches"]
        groups0 = ing.stats()["mpGroups"]
        hll_kernel.update.launches = hll_kernel.update_step.launches = 0
        t0 = time.perf_counter()
        for p in wire:
            ing.submit(p)
        ing.drain()
        store.agg.block_until_ready()
        wall = time.perf_counter() - t0
        groups = ing.stats()["mpGroups"] - groups0
        offered = shadow.counters()["shadowOfferedBatches"] - offered0
        if hll_kernel.update_step.launches != groups:
            raise AssertionError(f"phase j5: update_step launches {hll_kernel.update_step.launches}"
                                 f" != {groups} dispatcher groups")
        if (offered < groups) if on else offered:
            raise AssertionError(f"phase j5: the shadow was offered {offered} images for {groups} "
                                 f"groups with the plane {'on' if on else 'off'}")
        shadow.drain()
        return dict(on=on, spans_per_s=n_spans / wall, wall_ms=wall * 1e3, groups=groups,
                    launches=hll_kernel.update_step.launches,
                    update_launches=hll_kernel.update.launches)

    try:
        wait_ready(ing, "phase j5")
        runs = paired_runs(run)
        stats = ing.stats()
    finally:
        obs_switch(True)
        ing.close()
    if stats["mpFallbacks"] or store.agg.host_counters["spans"] != len(runs) * n_spans:
        raise AssertionError(f"phase j5: {store.agg.host_counters['spans']} spans landed in "
                             f"{len(runs)} passes, {stats['mpFallbacks']} fallbacks")
    verdict = on_off_verdict(runs)
    fig = dict(card=card, workers=workers, runs=runs, **verdict,
               launches=sum(r["launches"] for r in runs),
               update_launches=sum(r["update_launches"] for r in runs))
    log(f"phase j5 ({card}): the fan-out tier ({workers} workers, coalesce_max=8, blocking "
        f"submit), a warm-up and five pairs, plane on/off: spans/s "
        + ", ".join(f"{'warm-up ' if r['warmup'] else ''}{'on' if r['on'] else 'off'} "
                    f"{r['spans_per_s']:.0f} ({r['groups']} steps)" for r in runs)
        + f"; {verdict_text(verdict)}")
    return fig


def phase_obs_entry(card: str, timeout_s: float = 120.0, storage: str = "tpu",
                    argv=None, env_extra=None) -> dict:
    """(j4) ``python -m zipkin_tpu_torch.server`` as a subprocess: one
    trace POSTed, /prometheus scraped (the stage histogram, the device
    totals and the SLO families), SIGTERM -> exit 0."""
    import os
    import signal
    import socket
    import tempfile
    import urllib.request

    from zipkin_tpu_torch.model import json_v2

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, TPU_FAST_INGEST="1", TPU_ARCHIVE_DIR="off", QUERY_HOST="127.0.0.1",
               QUERY_PORT=str(port), STORAGE_TYPE=storage, **(env_extra or {}))
    root = os.path.dirname(os.path.abspath(__file__))
    http = HttpStore(f"http://127.0.0.1:{port}")
    cmd = argv or [sys.executable, "-m", "zipkin_tpu_torch.server"]
    with tempfile.TemporaryFile() as out:
        t0 = time.perf_counter()
        proc = subprocess.Popen(cmd, cwd=root, env=env, stdout=out, stderr=subprocess.STDOUT)
        try:
            while True:
                if proc.poll() is not None:
                    raise AssertionError(f"phase j4: the server exited {proc.returncode} before /health")
                try:
                    if http.get("/health")["status"] == "UP":
                        break
                except (OSError, AssertionError):
                    pass
                if time.perf_counter() - t0 > timeout_s:
                    raise AssertionError(f"phase j4: /health not UP within {timeout_s} s")
                time.sleep(0.25)
            boot_s = time.perf_counter() - t0
            now_ms = int(time.time() * 1000)
            trace = small_trace(0x0B5E7E1D0B5E7E1D, "obs-entry", (now_ms - 60_000) * 1000)
            if post_body(http.base, json_v2.encode_span_list(trace)) != 202:
                raise AssertionError("phase j4: POST was not answered 202")
            prom = urllib.request.urlopen(http.base + "/prometheus", timeout=60).read().decode()
            families = {line.split()[2] for line in prom.splitlines() if line.startswith("# TYPE")}
            want = {"zipkin_tpu_stage_latency_seconds", "zipkin_collector_spans_total",
                    "zipkin_tpu_slo_alert"}
            if storage == "tpu":
                want |= {"zipkin_tpu_device_program_calls", "zipkin_tpu_host_transfer_bytes"}
            if not want <= families or "zipkin_collector_spans_total{transport=\"http\"} 2" not in prom:
                raise AssertionError(f"phase j4: /prometheus lacks {sorted(want - families)}")
            t1 = time.perf_counter()
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=30)
            stop_s = time.perf_counter() - t1
            if rc != 0:
                raise AssertionError(f"phase j4: exit code {rc} after SIGTERM")
        except BaseException:
            out.seek(0)
            log("phase j4: server output:\n" + out.read().decode(errors="replace")[-4000:])
            raise
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
    log(f"phase j4 ({card}): python -m zipkin_tpu_torch.server: /health UP in {boot_s:.1f} s, a "
        f"trace POSTed, /prometheus has {len(families)} families, SIGTERM -> exit 0 in {stop_s:.2f} s")
    return dict(card=card, boot_s=boot_s, stop_s=stop_s, families=len(families))


def phase_obs(seed: int, torch, card: str, stored: dict, a2_ms: float, cfg=None, device=None,
              entry_argv=None, entry_env=None, entry_storage: str = "tpu") -> dict:
    """(j) the observability plane on the card: j1 (:func:`phase_obs_cost`),
    j2 (:func:`phase_obs_server`), j3 (:func:`phase_obs_tier`), j4
    (:func:`phase_obs_entry`) and j5 (:func:`phase_obs_tier_cost`). Returns
    each part's figures and the phase's ``update_step`` and ``update``
    launches, each part's counted from 0 just before it; no part may launch
    the single-target kernel."""
    parts = {
        "j1": lambda: phase_obs_cost(torch, card, stored, a2_ms, cfg=cfg, device=device),
        "j2": lambda: phase_obs_server(seed, torch, card, stored, cfg=cfg, device=device),
        "j3": lambda: phase_obs_tier(torch, card, stored, cfg=cfg, device=device),
        "j4": lambda: phase_obs_entry(card, storage=entry_storage, argv=entry_argv,
                                      env_extra=entry_env),
        "j5": lambda: phase_obs_tier_cost(torch, card, stored, cfg=cfg, device=device),
    }
    fig = {}
    for name, part in parts.items():
        t0 = time.perf_counter()
        fig[name] = part()
        torch.cuda.empty_cache()
        fig[name]["seconds"] = time.perf_counter() - t0
    log("phase j parts, s: " + ", ".join(f"{k} {fig[k]['seconds']:.1f}" for k in parts))
    parts = ("j1", "j2", "j3", "j5")
    fig["launches"] = sum(fig[k]["launches"] for k in parts)
    fig["update_launches"] = sum(fig[k]["update_launches"] for k in parts)
    if fig["update_launches"]:
        raise AssertionError(f"phase j: {fig['update_launches']} single-target launches")
    return fig


def free_port_base(n: int) -> int:
    """A base port with ``n + 1`` free ports from ``base - 1`` on (the
    serving front end's aggregate surface sits at ``base - 1``)."""
    import socket

    for _ in range(50):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            base = s.getsockname()[1] + 1
        if base + n >= 65000:
            continue
        socks = []
        try:
            for p in range(base - 1, base + n):
                sk = socket.socket()
                socks.append(sk)
                sk.bind(("127.0.0.1", p))
            return base
        except OSError:
            continue
        finally:
            for sk in socks:
                sk.close()
    raise AssertionError("no free port range")


def http_get(url: str, timeout: float = 60.0):
    """(status, headers, body bytes) of one GET."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def tracer_host_ns(n: int = 4000) -> dict:
    """The critical-path tracer's own host ns a payload, priced on a private
    ledger: the dispatcher side's claim, enqueue stamp, four segment stamps
    and ack (main process), the worker side's calibration and four stamps
    (each parse worker, off the dispatcher's thread), and the stitcher's
    fold of one timeline (the windows ticker)."""
    from zipkin_tpu_torch.obs import critpath as cp

    led = cp.CritPathLedger(1, 64)
    view = cp.CritPathWorkerView(led.params(), 0)
    try:
        st = cp.CritPathStitcher(led, queue_capacity=8)
        main_ns = worker_ns = fold_ns = 0
        for k in range(n // 64):
            t0 = time.perf_counter_ns()
            slots = []
            for i in range(64):
                pid = k * 64 + i
                s = led.alloc(pid, 0, 1 + i)
                led.stamp(s, cp.SEG_ENQUEUE, 2, 3, pid)
                for code in (cp.SEG_VOCAB_REPLAY, cp.SEG_DEVICE_FEED, cp.SEG_WAL_APPEND,
                             cp.SEG_SHM_COPY):
                    led.stamp(s, code, 10, 20, pid)
                slots.append((s, pid))
            t1 = time.perf_counter_ns()
            for s, _ in slots:
                view.calibrate()
                for code in (cp.SEG_PARSE, cp.SEG_PACK, cp.SEG_ROUTE, cp.SEG_RING_WAIT):
                    view.stamp(s, code, 4, 9)
            t2 = time.perf_counter_ns()
            for s, pid in slots:
                led.ack(s, pid, 100)
            t3 = time.perf_counter_ns()
            if st.stitch() != 64:
                raise AssertionError("tracer pricing: a fold lost a timeline")
            t4 = time.perf_counter_ns()
            main_ns += (t1 - t0) + (t3 - t2)
            worker_ns += t2 - t1
            fold_ns += t4 - t3
        m = (n // 64) * 64
        return dict(main_ns=main_ns / m, worker_ns=worker_ns / m, fold_ns=fold_ns / m)
    finally:
        view.close()
        led.close()


def phase_tracer(torch, card: str, stored: dict, cfg=None, device=None, workers=None) -> dict:
    """(k1) the critical-path tracer on i2's tier (``workers`` parse workers,
    ``coalesce_max=8``, 256 ledger slots), phase e's payloads a pass: one
    warm-up and five pairs with the tracer on (each payload carries a wire
    anchor, so the ledger traces it) and off (no anchor: no slot is
    claimed), the first side alternating; the stitcher folds each traced
    pass off the clock. Checks that every traced payload folds into a
    timeline whose segments sum to its wall within the stitcher's 10% at
    p50, and that update_step launches equal the dispatcher's groups. Then
    one worker is SIGKILLed mid-pass: the drain completes and, after the
    reclaim age, no ledger slot is left open. Prints wire-to-durable p50 and
    p99, the top three segments by share, the Little's-law gauges, the
    on/off verdict and the tracer's own host cost a payload
    (:func:`tracer_host_ns`)."""
    import os

    from zipkin_tpu_torch.obs import critpath as cp
    from zipkin_tpu_torch.ops import hll_kernel
    from zipkin_tpu_torch.tpu.mp_ingest import MultiProcessIngester
    from zipkin_tpu_torch.tpu.state import AggConfig
    from zipkin_tpu_torch.tpu.store import TorchStorage

    cfg = cfg or AggConfig()
    wire, n_spans = stored["wire"], len(stored["spans"])
    workers = workers or max(1, min(4, (os.cpu_count() or 1) - 2))
    store = TorchStorage(config=cfg, device=device)
    ing = MultiProcessIngester(store, workers=workers, coalesce_max=8, critpath_slots=256,
                               critpath_reclaim_s=1.0)
    stitcher, ledger = ing.critpath, ing._cp_ledger
    folded = []

    def run(on):
        groups0 = ing.stats()["mpGroups"]
        hll_kernel.update.launches = hll_kernel.update_step.launches = 0
        t0 = time.perf_counter()
        for p in wire:
            cp.WIRE_T0_NS.set(time.perf_counter_ns() if on else 0)
            ing.submit(p)
        ing.drain()
        store.agg.block_until_ready()
        wall = time.perf_counter() - t0
        cp.WIRE_T0_NS.set(0)
        groups = ing.stats()["mpGroups"] - groups0
        if hll_kernel.update_step.launches != groups:
            raise AssertionError(f"phase k1: update_step launches {hll_kernel.update_step.launches}"
                                 f" != {groups} dispatcher groups")
        n = stitcher.stitch()
        if n != (len(wire) if on else 0):
            raise AssertionError(f"phase k1: {n} timelines folded from a pass of {len(wire)} "
                                 f"payloads with the tracer {'on' if on else 'off'}")
        folded.append(n)
        return dict(on=on, spans_per_s=n_spans / wall, wall_ms=wall * 1e3, groups=groups,
                    launches=hll_kernel.update_step.launches,
                    update_launches=hll_kernel.update.launches)

    try:
        wait_ready(ing, "phase k1")
        runs = paired_runs(run)
        wf = stitcher.waterfall()
        counters = stitcher.counters()
        # a worker SIGKILLed mid-pass: its payloads re-ingest, its slots are
        # abandoned, and no timeline stays open past the reclaim age
        hll_kernel.update.launches = hll_kernel.update_step.launches = 0
        abandoned0 = ledger.abandoned
        for i, p in enumerate(wire):
            cp.WIRE_T0_NS.set(time.perf_counter_ns())
            ing.submit(p)
            if i == len(wire) // 4:
                ing._procs[0].kill()
        ing.drain()
        cp.WIRE_T0_NS.set(0)
        kill_launches = hll_kernel.update_step.launches
        kill_update = hll_kernel.update.launches
        time.sleep(1.2)  # past the reclaim age
        stitcher.stitch()
        open_slots = [s for s in range(ledger.slots) if ledger.state(s) != 0]
        stats = ing.stats()
    finally:
        cp.WIRE_T0_NS.set(0)
        ing.close()
    if open_slots:
        raise AssertionError(f"phase k1: {len(open_slots)} ledger slots stuck after the kill")
    if store.agg.host_counters["spans"] != (len(runs) + 1) * n_spans:
        raise AssertionError(f"phase k1: {store.agg.host_counters['spans']} spans landed, want "
                             f"{(len(runs) + 1) * n_spans}")
    if stats["mpWorkersAlive"] != workers - 1 or (
            stats["mpFallbacks"] and ledger.abandoned - abandoned0 < 1):
        raise AssertionError(f"phase k1: after the kill {stats['mpWorkersAlive']} workers alive, "
                             f"{ledger.abandoned - abandoned0} slots abandoned")
    traced = sum(folded)
    if wf["timelines"] != traced or wf["skipped"] or abs(wf["conservation"]["p50"] - 1.0) > 0.10:
        raise AssertionError(f"phase k1: {wf['timelines']} timelines of {traced} traced, "
                             f"{wf['skipped']} skipped, conservation {wf['conservation']}")
    total_us = sum(r["sumUs"] for r in wf["segments"]) or 1
    top = sorted(wf["segments"], key=lambda r: -r["sumUs"])[:3]
    price = tracer_host_ns()
    verdict = on_off_verdict(runs)
    payload_ms = statistics.median(r["wall_ms"] for r in runs if not r["warmup"]) / len(wire)
    fig = dict(card=card, workers=workers, runs=runs, **verdict, timelines=wf["timelines"],
               conservation=wf["conservation"], wire_to_durable=wf["wireToDurable"],
               top_segments=[(r["segment"], r["sumUs"] / total_us) for r in top],
               littles_law=wf["littlesLaw"], counters_lambda=counters["critpathLambdaCps"],
               queue_wait=wf["queueWaitVsService"], price_ns=price,
               price_share=(price["main_ns"] + price["fold_ns"]) / (payload_ms * 1e6),
               abandoned=ledger.abandoned - abandoned0, reclaimed=stitcher.reclaimed,
               fallbacks=stats["mpFallbacks"],
               launches=sum(r["launches"] for r in runs) + kill_launches,
               update_launches=sum(r["update_launches"] for r in runs) + kill_update)
    log(f"phase k1 ({card}): the tracer on i2's tier ({workers} workers, coalesce_max=8, 256 "
        f"slots), a warm-up and five pairs, tracer on/off: spans/s "
        + ", ".join(f"{'warm-up ' if r['warmup'] else ''}{'on' if r['on'] else 'off'} "
                    f"{r['spans_per_s']:.0f} ({r['groups']} steps)" for r in runs)
        + f"; {verdict_text(verdict)}")
    w2d = wf["wireToDurable"]
    log(f"phase k1: {wf['timelines']} timelines stitched, {wf['skipped']} skipped; conservation "
        f"p50 {wf['conservation']['p50']:.4f} (min {wf['conservation']['min']:.4f}, max "
        f"{wf['conservation']['max']:.4f}); wire_to_durable p50 {w2d['p50Us'] / 1e3:.3f} ms, p99 "
        f"{w2d['p99Us'] / 1e3:.3f} ms, max {w2d['maxUs'] / 1e3:.3f} ms; top segments by share "
        + ", ".join(f"{name} {share:.3f}" for name, share in fig["top_segments"])
        + f"; wait fraction {wf['queueWaitVsService']['waitFraction']:.4f}; Little's law "
        + json.dumps(wf["littlesLaw"]))
    log(f"phase k1: the tracer's own host ns a payload: {price['main_ns']:.0f} on the boundary and "
        f"dispatcher threads, {price['worker_ns']:.0f} in a worker, {price['fold_ns']:.0f} to fold "
        f"on the ticker ({fig['price_share'] * 100:.3f}% of a payload's {payload_ms:.3f} ms pass "
        f"wall, main side and fold); a SIGKILLed worker: {fig['fallbacks']} payloads re-ingested, "
        f"{fig['abandoned']} slots abandoned (a full queue's retries included), "
        f"{fig['reclaimed']} reclaimed, 0 left open after the reclaim age; update_step launches "
        f"{fig['launches']}")
    return fig


def phase_mirror(torch, card: str, stored: dict, cfg=None, device=None, readers: int = 8,
                 tick_s: float = 0.25, passes: int = 1, think_s: float = 0.002,
                 max_ingest_s: float = 60.0) -> dict:
    """(k2) the read mirror in process: a fresh TorchStorage a setting, fed
    phase e's payloads ``passes`` times at the line rate (f1's path,
    ``Collector(fast_ingest=True)``) from one thread while ``readers``
    threads loop over the four aggregate reads (dependencies over the
    generator's window, percentiles, cardinalities, the overview), each
    waiting ``think_s`` between its reads (polling clients: a closed loop
    with no wait starves the one ingest thread of the GIL; the ingest stops
    early past ``max_ingest_s``), once with
    the mirror off and once on, a publisher thread calling
    ``publish_mirror(paced=True)`` every ``tick_s`` (the server's ticker).
    Prints each read kind's wall p50 and p99, the aggregator-lock
    acquisitions made inside mirror serves (must be 0), the publish's ms
    (its one lock hold, the device sync of the packed reads included), the
    largest serve age against the bound and the ingest rate. After ingest
    stops and one publish, every mirror answer equals the fresh read
    (``staleness_ms=0``) byte for byte."""
    import threading

    from zipkin_tpu_torch.collector import Collector
    from zipkin_tpu_torch.model import json_v2
    from zipkin_tpu_torch.ops import hll_kernel
    from zipkin_tpu_torch.tpu.state import AggConfig
    from zipkin_tpu_torch.tpu.store import TorchStorage

    cfg = cfg or AggConfig()
    wire, n_spans = stored["wire"], len(stored["spans"])
    truth = store_truth(stored["traffic"], cfg)
    kinds = ("dependencies", "percentiles", "cardinalities", "overview")
    fig = dict(card=card, readers=readers, tick_s=tick_s, passes=passes, launches=0,
               update_launches=0)

    def reads(store, kind, **kw):
        if kind == "dependencies":
            return [json_v2.link_to_dict(x) for x in
                    store.get_dependencies(truth.t_end, truth.lookback, **kw).execute()]
        if kind == "percentiles":
            return store.latency_quantiles(QS, **kw)
        if kind == "cardinalities":
            return store.trace_cardinalities(**kw)
        out = store.sketch_overview(QS, **kw)
        return {"percentiles": out["percentiles"], "cardinalities": out["cardinalities"]}

    for setting in ("off", "on"):
        store = TorchStorage(config=cfg, device=device)
        store.mirror.enabled = setting == "on"
        collector = Collector(store, fast_ingest=True)
        lock = store.agg.lock
        tl = threading.local()
        acquire = lock.acquire

        def counting_acquire(*a, **k):
            tl.n = getattr(tl, "n", 0) + 1
            return acquire(*a, **k)

        lock.acquire = counting_acquire
        serve = store._mirror_serve
        serve_lock_acq = [0, 0]  # acquisitions inside mirror serves, hits

        def counted_serve(*a, **k):
            n0 = getattr(tl, "n", 0)
            hit = serve(*a, **k)
            if hit is not None:
                serve_lock_acq[0] += getattr(tl, "n", 0) - n0
                serve_lock_acq[1] += 1
            return hit

        store._mirror_serve = counted_serve
        walls = {k: [] for k in kinds}
        done = threading.Event()
        errors = []

        def reader(i):
            try:
                k = i
                while not done.is_set():
                    kind = kinds[k % len(kinds)]
                    t0 = time.perf_counter()
                    reads(store, kind)
                    walls[kind].append((time.perf_counter() - t0) * 1e3)
                    k += 1
                    done.wait(think_s)
            except BaseException as e:  # surfaced after the join
                errors.append(e)

        def publisher():
            try:
                while not done.wait(tick_s):
                    store.publish_mirror(paced=True)
            except BaseException as e:
                errors.append(e)

        hll_kernel.update.launches = hll_kernel.update_step.launches = 0
        threads = [threading.Thread(target=reader, args=(i,)) for i in range(readers)]
        if setting == "on":
            threads.append(threading.Thread(target=publisher))
        for t in threads:
            t.start()
        t0 = time.perf_counter()
        sent = 0
        try:
            for p in [p for _ in range(passes) for p in wire]:
                if time.perf_counter() - t0 > max_ingest_s:
                    break
                collector.accept_spans_bytes(p)
                sent += 1
            store.agg.block_until_ready()
        finally:
            ingest_s = time.perf_counter() - t0
            done.set()
            for t in threads:
                t.join(timeout=300)
        if errors:
            raise errors[0]
        fig["launches"] += hll_kernel.update_step.launches
        fig["update_launches"] += hll_kernel.update.launches
        per = n_spans // len(wire)
        if store.agg.host_counters["spans"] != sent * per:
            raise AssertionError(f"phase k2: {store.agg.host_counters['spans']} spans landed of "
                                 f"{sent} payloads")
        res = dict(spans_per_s=sent * per / ingest_s, ingest_s=ingest_s, payloads=sent,
                   reads={k: len(v) for k, v in walls.items()},
                   p50_ms={k: float(np.percentile(v, 50)) for k, v in walls.items() if v},
                   p99_ms={k: float(np.percentile(v, 99)) for k, v in walls.items() if v},
                   serve_lock_acquisitions=serve_lock_acq[0], mirror_hits=serve_lock_acq[1])
        c = store.ingest_counters()
        res.update({k: c[k] for k in ("mirrorPublishes", "mirrorPublishSkips",
                                      "mirrorPublishBackoffs", "mirrorServes", "mirrorStaleServes",
                                      "mirrorMisses", "mirrorServeAgeMaxMs", "mirrorMaxStaleMs",
                                      "queryLockContended", "queryLockWaitP99Us")})
        res["publish_ms_mean"] = c["mirrorPublishMsSum"] / max(1, c["mirrorPublishes"])
        res["shape_memo_hits"] = store._shape_memo_hits  # serves whose shaping was memoized
        if setting == "on":
            if serve_lock_acq[0] or not serve_lock_acq[1]:
                raise AssertionError(f"phase k2: {serve_lock_acq[0]} lock acquisitions in "
                                     f"{serve_lock_acq[1]} mirror serves")
            if res["mirrorServeAgeMaxMs"] > res["mirrorMaxStaleMs"]:
                raise AssertionError(f"phase k2: a serve {res['mirrorServeAgeMaxMs']} ms stale")
            # quiescent: one publish, then every mirror answer equals the fresh read
            store._deps_max_stale_ms = 0.0  # the fresh dependency read takes no cached answer
            t_pub = time.perf_counter()
            store.publish_mirror(force=True)
            res["quiet_publish_ms"] = (time.perf_counter() - t_pub) * 1e3
            res["quiet_publish_keys"] = len(store.mirror.snapshot().values)
            for kind in kinds:
                serves = store.mirror.serves
                mirrored = json.dumps(reads(store, kind), sort_keys=True)
                if store.mirror.serves != serves + 1:
                    raise AssertionError(f"phase k2: the quiescent {kind} read missed the mirror")
                if mirrored != json.dumps(reads(store, kind, staleness_ms=0), sort_keys=True):
                    raise AssertionError(f"phase k2: the mirror's {kind} differs from the fresh read")
        else:
            if res["mirrorServes"]:
                raise AssertionError("phase k2: the disabled mirror served")
        lock.acquire = acquire
        fig[setting] = res
        del store, collector
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    on, off = fig["on"], fig["off"]
    log(f"phase k2 ({card}): one ingest thread ({passes} x phase e's payloads, f1's path) and "
        f"{readers} reader threads ({think_s * 1e3:.0f} ms between reads); read wall ms p50/p99, "
        f"mirror off -> on: "
        + "; ".join(f"{k} {off['p50_ms'][k]:.3f}/{off['p99_ms'][k]:.3f} -> "
                    f"{on['p50_ms'][k]:.3f}/{on['p99_ms'][k]:.3f} ({off['reads'][k]} -> "
                    f"{on['reads'][k]} reads)" for k in kinds))
    log(f"phase k2: ingest {off['spans_per_s']:.0f} spans/s mirror off ({off['payloads']} payloads "
        f"in {off['ingest_s']:.1f} s), {on['spans_per_s']:.0f} on ({on['payloads']} in "
        f"{on['ingest_s']:.1f} s); {on['mirrorPublishes']} publishes every {tick_s} s (paced; {on['mirrorPublishBackoffs']}"
        f" backoffs, {on['mirrorPublishSkips']} skips) at {on['publish_ms_mean']:.3f} ms each, the "
        f"lock hold with the packed reads' device sync ({on['quiet_publish_ms']:.3f} ms for "
        f"{on['quiet_publish_keys']} keys once the readers stopped); {on['mirrorServes']} mirror serves "
        f"({on['mirrorStaleServes']} stale, {on['mirrorMisses']} misses) with "
        f"{on['serve_lock_acquisitions']} aggregator-lock acquisitions in {on['mirror_hits']} "
        f"hits; largest serve age {on['mirrorServeAgeMaxMs']:.1f} ms against "
        f"{on['mirrorMaxStaleMs']:.0f} ms; lock contended {off['queryLockContended']} -> "
        f"{on['queryLockContended']}; after a quiescent publish the four mirror answers equal the "
        f"fresh reads byte for byte")
    return fig


def phase_readers(torch, card: str, stored: dict, cfg=None, device=None, n_payloads: int = 16,
                  serving_argv=None) -> dict:
    """(k3) scale-out readers: an in-process server (the line-rate path, the
    resume adapter with a 64 MiB mirror segment, windows every 0.25 s) takes
    ``n_payloads`` of phase e's payloads, and ``python -m
    zipkin_tpu_torch.serving`` runs 2 reader processes over its segment.
    Each reader's four aggregate answers equal the ingest server's at one
    segment generation; ``staleness_ms=0`` answers 503 with Retry-After; a
    missed key answers 503 and then 200, equal to the server's, on the next
    epoch; a SIGKILLed reader is respawned; a reader process maps no torch
    library and the reader's imports load no torch. Prints the in-process
    ``reader_serve`` µs (a decoded epoch, memoized and not), the HTTP round
    trip to a reader against the ingest server's, and the segment's payload
    bytes and serialize ms. SIGTERM stops the front end with exit 0."""
    import dataclasses
    import os
    import signal
    import tempfile

    from zipkin_tpu_torch.ops import hll_kernel
    from zipkin_tpu_torch.server.app import ZipkinServer
    from zipkin_tpu_torch.server.config import ServerConfig
    from zipkin_tpu_torch.serving.segment import MirrorSegment
    from zipkin_tpu_torch.serving.shape import SegmentView
    from zipkin_tpu_torch.tpu.state import AggConfig

    cfg = cfg or AggConfig()
    truth = store_truth(stored["traffic"], cfg)
    hll_kernel.update.launches = hll_kernel.update_step.launches = 0
    config = ServerConfig(host="127.0.0.1", port=0, storage_type="tpu", tpu_fast_ingest=True,
                          tpu_archive_dir=None, obs_windows_tick_s=0.25, obs_shadow_enabled=False,
                          tpu_mirror_segment_bytes=64 << 20, tpu_readers=2,
                          tpu_agg=dataclasses.asdict(cfg))
    server = ZipkinServer(config, device=device, seal_interval_s=0.25).start()
    base = f"http://127.0.0.1:{server.port}"
    core = server.storage
    seg = core.mirror_segment
    pb = free_port_base(2)
    rbase = [f"http://127.0.0.1:{pb + i}" for i in range(2)]
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, TPU_MIRROR_SEGMENT=seg.name, TPU_READERS="2",
               TPU_READER_PORT_BASE=str(pb))
    cmd = serving_argv or [sys.executable, "-m", "zipkin_tpu_torch.serving"]
    routes = [("/api/v2/dependencies", {"endTs": truth.t_end, "lookback": truth.lookback}),
              ("/api/v2/tpu/percentiles", {}),
              ("/api/v2/tpu/cardinalities", {}),
              ("/api/v2/tpu/overview", {})]

    def url(b, path, params):
        import urllib.parse

        return b + path + ("?" + urllib.parse.urlencode(params) if params else "")

    def answer(b, path, params):
        status, headers, body = http_get(url(b, path, params))
        if status != 200:
            return status, headers, body
        got = json.loads(body)
        if path.endswith("overview"):
            got.pop("counters")  # the reader's are the publish instant's
        return status, headers, json.dumps(got, sort_keys=True)

    fig = dict(card=card)
    with tempfile.TemporaryFile() as out:
        proc = None
        try:
            for p in stored["wire"][:n_payloads]:
                if post_body(base, p) != 202:
                    raise AssertionError("phase k3: a POST was not answered 202")
            t0 = time.perf_counter()
            proc = subprocess.Popen(cmd, cwd=root, env=env, stdout=out, stderr=subprocess.STDOUT)
            for b in rbase:
                while not _up(b):
                    if proc.poll() is not None:
                        raise AssertionError(f"phase k3: the front end exited {proc.returncode}")
                    if time.perf_counter() - t0 > 120:
                        raise AssertionError("phase k3: a reader did not come up in 120 s")
                    time.sleep(0.1)
            fig["readers_up_s"] = time.perf_counter() - t0
            # first touches miss and register; the ticker's next epoch carries
            # them (it also seals the time tier first), and with no write
            # and no new demand after it the ticker republishes nothing
            deadline = time.monotonic() + 60
            while not all(answer(b, path, params)[0] == 200 for b in rbase for path, params in routes):
                if time.monotonic() > deadline:
                    raise AssertionError("phase k3: the readers' keys were never published")
                time.sleep(0.1)
            ticks = server._obs_windows.ticks
            while server._obs_windows.ticks < ticks + 2:
                time.sleep(0.05)
            gen = seg.generation()
            for i, b in enumerate(rbase):
                for path, params in routes:
                    want = answer(base, path, params)
                    got = answer(b, path, params)
                    if got[0] != 200 or got[2] != want[2]:
                        raise AssertionError(f"phase k3: reader r{i} {path}: {got[0]} differs "
                                             f"from the ingest server's")
                    if float(got[1]["X-Staleness-Ms"]) < 0.0:
                        raise AssertionError("phase k3: a negative staleness")
            if seg.generation() != gen:
                raise AssertionError("phase k3: the segment moved during the comparison")
            # a fresh read is not a reader's to serve
            status, headers, _ = http_get(rbase[0] + "/api/v2/tpu/cardinalities?staleness_ms=0")
            if status != 503 or headers.get("Retry-After") != "1":
                raise AssertionError(f"phase k3: staleness_ms=0 answered {status} {headers}")
            # a missed key: 503 now, served on the next epoch
            miss = ("/api/v2/tpu/percentiles", {"q": "0.25,0.75"})
            status, headers, _ = http_get(url(rbase[1], *miss))
            if status != 503 or "Retry-After" not in headers:
                raise AssertionError(f"phase k3: a missed key answered {status}")
            deadline = time.monotonic() + 30
            while (got := answer(rbase[1], *miss))[0] != 200:
                if time.monotonic() > deadline:
                    raise AssertionError("phase k3: the missed key was never served")
                time.sleep(0.05)
            if got[2] != answer(base, *miss)[2]:
                raise AssertionError("phase k3: the missed key's answer differs from the server's")
            fig["miss_served_s"] = 30 - (deadline - time.monotonic())
            # the reader process: no torch mapped
            pid = json.loads(http_get(rbase[0] + "/metrics")[2])["reader"]["readerPid"]
            with open(f"/proc/{pid}/maps") as f:
                maps = f.read()
            libs = [lib for lib in ("libtorch", "libc10", "libcuda", "libcudart") if lib in maps]
            if libs:
                raise AssertionError(f"phase k3: reader r0 maps {libs}")
            check = subprocess.run(
                [sys.executable, "-c", "import sys\nfrom zipkin_tpu_torch.serving import reader, "
                 "supervisor, segment, shape\nimport zipkin_tpu_torch.serving.__main__\nprint(sorted("
                 "m for m in sys.modules if m.split('.')[0] in ('torch', 'jax', 'zipkin_tpu')))"],
                cwd=root, capture_output=True, text=True, timeout=120)
            if check.returncode != 0 or check.stdout.strip() != "[]":
                raise AssertionError(f"phase k3: the reader's imports load {check.stdout.strip()} "
                                     f"{check.stderr[-500:]}")
            fig["reader_modules"] = check.stdout.strip()
            # one HTTP round trip to a reader against the ingest server's; a
            # quiet server publishes no epoch, and a reader answers 503 once
            # its epoch is older than the 5 s bound, so both take a wide one
            fig["http_ms"] = {}
            for name, b in (("reader", rbase[0]), ("server", base)):
                fig["http_ms"][name] = {}
                for path, params in routes:
                    wide = {**params, "staleness_ms": 600_000}
                    if http_get(url(b, path, wide))[0] != 200:
                        raise AssertionError(f"phase k3: {name} {path} did not answer 200")
                    fig["http_ms"][name][path.rsplit("/", 1)[1]] = median_ms(
                        lambda: http_get(url(b, path, wide)), reps=21)
            # SIGKILL a reader: the supervisor respawns it
            os.kill(pid, signal.SIGKILL)
            deadline = time.monotonic() + 60
            while True:
                st = http_get(f"http://127.0.0.1:{pb - 1}/statusz")
                if st[0] == 200 and json.loads(st[2])["respawns"] >= 1 and _up(rbase[0]):
                    new_pid = json.loads(http_get(rbase[0] + "/metrics")[2])["reader"]["readerPid"]
                    if new_pid != pid:
                        break
                if time.monotonic() > deadline:
                    raise AssertionError("phase k3: the killed reader was not respawned")
                time.sleep(0.1)
            fig["respawn_s"] = 60 - (deadline - time.monotonic())
            prom = http_get(f"http://127.0.0.1:{pb - 1}/prometheus")[2].decode()
            if 'zipkin_tpu_reader_up{reader="r0"} 1' not in prom or \
                    "zipkin_tpu_reader_supervisor_respawns 1" not in prom:
                raise AssertionError("phase k3: the aggregate /prometheus lacks the readers")
            # reader_serve in process: a decoded epoch's serve, memoized and not
            att = MirrorSegment(name=seg.name)
            view = SegmentView(att, 1)
            try:
                view.serve_cardinalities(staleness_ms=600_000)
                fig["reader_serve_us"] = {
                    "memoized": median_ms(lambda: view.serve_cardinalities(staleness_ms=600_000),
                                          reps=101) * 1e3,
                    "decode": median_ms(lambda: (setattr(view, "_ep", None),
                                                 view.serve_cardinalities(staleness_ms=600_000)),
                                        reps=11) * 1e3,
                }
            finally:
                del view
                att.close()
            pids = [json.loads(http_get(b + "/metrics")[2])["reader"]["readerPid"] for b in rbase]
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=60)
            if rc != 0:
                raise AssertionError(f"phase k3: the front end exited {rc} after SIGTERM")
            for reader_pid in pids:  # the front end stopped its readers
                if os.path.exists(f"/proc/{reader_pid}") and \
                        open(f"/proc/{reader_pid}/stat").read().split()[2] != "Z":
                    raise AssertionError(f"phase k3: reader {reader_pid} outlived its front end")
            # the front end and its readers exited: the segment is still there
            MirrorSegment(name=seg.name).close()
            c = core.ingest_counters()
            fig.update(payload_bytes=c["segmentPayloadBytes"], serialize_ms=c["segmentSerializeMs"],
                       segment_publishes=c["segmentPublishes"], generation=gen,
                       reader_serve_age_ms=c["readerServeAgeMs"])
        except BaseException:
            out.seek(0)
            log("phase k3: serving output:\n" + out.read().decode(errors="replace")[-4000:])
            raise
        finally:
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
                _kill_readers(pb)
            server.stop()
    fig.update(launches=hll_kernel.update_step.launches, update_launches=hll_kernel.update.launches)
    log(f"phase k3 ({card}): python -m zipkin_tpu_torch.serving, 2 readers up in "
        f"{fig['readers_up_s']:.1f} s over a {64 << 20}-byte segment; every reader's four answers "
        f"equal the server's at generation {gen}; staleness_ms=0 -> 503 Retry-After 1; a missed "
        f"key 503 then served {fig['miss_served_s']:.2f} s later; a SIGKILLed reader respawned in "
        f"{fig['respawn_s']:.1f} s; reader maps no torch, its imports load {fig['reader_modules']}")
    log(f"phase k3: reader_serve us (in process): memoized {fig['reader_serve_us']['memoized']:.1f},"
        f" with the epoch's decode {fig['reader_serve_us']['decode']:.1f}; HTTP ms median of 21, "
        f"reader / server: " + ", ".join(
            f"{k} {fig['http_ms']['reader'][k]:.3f} / {fig['http_ms']['server'][k]:.3f}"
            for k in fig["http_ms"]["reader"])
        + f"; segment payload {fig['payload_bytes']} bytes serialized in {fig['serialize_ms']:.3f} "
        f"ms ({fig['segment_publishes']} publishes); update_step launches {fig['launches']}")
    return fig


def _kill_readers(port_base: int) -> None:
    """After a failure, SIGKILL the reader processes listening from
    ``port_base`` on (a killed front end leaves its children)."""
    import os
    import signal

    for i in range(2):
        try:
            body = http_get(f"http://127.0.0.1:{port_base + i}/metrics", timeout=5)[2]
            os.kill(json.loads(body)["reader"]["readerPid"], signal.SIGKILL)
        except (OSError, ValueError, KeyError):
            pass


def _up(base: str) -> bool:
    try:
        return http_get(base + "/health", timeout=5)[0] == 200
    except OSError:
        return False


def phase_serve_entry(card: str, wire, timeout_s: float = 180.0, argv=None, env_extra=None) -> dict:
    """(k4) ``python -m zipkin_tpu_torch.server`` with the tier
    (``TPU_MP_WORKERS=2``), the tracer and the mirror on and a 64 MiB mirror
    segment, windows every 0.5 s: 8 payloads POSTed (a client that backs
    off on 429), then statusz's ``critpath``, ``mirror`` and ``serving``
    sections and the ``zipkin_tpu_critpath_segment_*``, ``mirror`` and
    ``segment`` families of /prometheus each carry a signal; SIGTERM ->
    exit 0."""
    import os
    import signal
    import tempfile

    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    base = f"http://127.0.0.1:{port}"
    env = dict(os.environ, TPU_FAST_INGEST="1", TPU_MP_WORKERS="2", TPU_ARCHIVE_DIR="off",
               TPU_OBS_TICK_S="0.5", TPU_MIRROR_SEGMENT_BYTES=str(64 << 20), TPU_READERS="2",
               QUERY_HOST="127.0.0.1", **(env_extra or {}))
    root = os.path.dirname(os.path.abspath(__file__))
    cmd = (argv or [sys.executable, "-m", "zipkin_tpu_torch.server"]) + [
        "--port", str(port), "--storage", "tpu"]
    fig = dict(card=card)
    with tempfile.TemporaryFile() as out:
        t0 = time.perf_counter()
        proc = subprocess.Popen(cmd, cwd=root, env=env, stdout=out, stderr=subprocess.STDOUT)
        try:
            while not _up(base):
                if proc.poll() is not None:
                    raise AssertionError(f"phase k4: the server exited {proc.returncode} early")
                if time.perf_counter() - t0 > timeout_s:
                    raise AssertionError(f"phase k4: /health not UP within {timeout_s} s")
                time.sleep(0.25)
            fig["boot_s"] = time.perf_counter() - t0
            for p in wire[:8]:
                while (status := post_body(base, p)) == 429:
                    time.sleep(0.005)
                if status != 202:
                    raise AssertionError(f"phase k4: POST answered {status}")
            for path in ("/api/v2/tpu/cardinalities", "/api/v2/tpu/percentiles"):
                http_get(base + path)
            deadline = time.monotonic() + 60
            while True:
                st = json.loads(http_get(base + "/api/v2/tpu/statusz")[2])
                cpw, mir, srv = st.get("critpath", {}), st.get("mirror", {}), st.get("serving", {})
                if (cpw.get("timelines", 0) >= 8 and mir.get("mirrorPublishes", 0) >= 2
                        and srv.get("publishes", 0) >= 2 and mir.get("snapshot")):
                    break
                if time.monotonic() > deadline:
                    raise AssertionError(f"phase k4: statusz critpath {cpw.get('timelines')} "
                                         f"mirror {mir.get('mirrorPublishes')} serving "
                                         f"{srv.get('publishes')}")
                time.sleep(0.25)
            prom = http_get(base + "/prometheus")[2].decode()
            families = {line.split()[2] for line in prom.splitlines() if line.startswith("# TYPE")}
            want = {"zipkin_tpu_critpath_segment_count_total", "zipkin_tpu_critpath_timelines",
                    "zipkin_tpu_mirror_publishes", "zipkin_tpu_mirror_serve_age_ms",
                    "zipkin_tpu_segment_publishes", "zipkin_tpu_segment_payload_bytes",
                    "zipkin_tpu_reader_serve_age_ms"}
            if not want <= families or "zipkin_tpu_critpath_timelines 0" in prom \
                    or "zipkin_tpu_segment_publishes 0" in prom:
                raise AssertionError(f"phase k4: /prometheus lacks {sorted(want - families)} or "
                                     f"carries no signal")
            metrics = json.loads(http_get(base + "/metrics")[2])
            if not metrics.get("gauge.zipkin_tpu.critpathTimelines") or \
                    not metrics.get("gauge.zipkin_tpu.mirrorPublishes"):
                raise AssertionError("phase k4: /metrics lacks the critpath or mirror gauges")
            fig.update(timelines=cpw["timelines"], conservation_p50=cpw["conservation"]["p50"],
                       mirror_publishes=mir["mirrorPublishes"], segment_publishes=srv["publishes"],
                       segment=srv["name"], families=len(families))
            t1 = time.perf_counter()
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=60)
            fig["stop_s"] = time.perf_counter() - t1
            if rc != 0:
                raise AssertionError(f"phase k4: exit code {rc} after SIGTERM")
        except BaseException:
            out.seek(0)
            log("phase k4: server output:\n" + out.read().decode(errors="replace")[-4000:])
            raise
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
    log(f"phase k4 ({card}): TPU_MP_WORKERS=2 TPU_MIRROR_SEGMENT_BYTES={64 << 20} python -m "
        f"zipkin_tpu_torch.server: /health UP in {fig['boot_s']:.1f} s; statusz critpath "
        f"{fig['timelines']} timelines (conservation p50 {fig['conservation_p50']:.4f}), mirror "
        f"{fig['mirror_publishes']} publishes, serving {fig['segment_publishes']} segment publishes "
        f"({fig['segment']}); /prometheus {len(families)} families with the critpath, mirror and "
        f"segment ones; SIGTERM -> exit 0 in {fig['stop_s']:.2f} s")
    return fig


def phase_serve(torch, card: str, stored: dict, cfg=None, device=None, workers=None,
                serving_argv=None, entry_argv=None, entry_env=None) -> dict:
    """(k) the critical-path tracer, the read mirror and scale-out readers:
    k1 (:func:`phase_tracer`), k2 (:func:`phase_mirror`), k3
    (:func:`phase_readers`) and k4 (:func:`phase_serve_entry`). Returns each
    part's figures and the phase's update_step and update launches, each
    part's counted from 0 just before it; no part may launch the
    single-target kernel."""
    parts = {
        "k1": lambda: phase_tracer(torch, card, stored, cfg=cfg, device=device, workers=workers),
        "k2": lambda: phase_mirror(torch, card, stored, cfg=cfg, device=device),
        "k3": lambda: phase_readers(torch, card, stored, cfg=cfg, device=device,
                                    serving_argv=serving_argv),
        "k4": lambda: phase_serve_entry(card, stored["wire"], argv=entry_argv, env_extra=entry_env),
    }
    fig = {}
    for name, part in parts.items():
        t0 = time.perf_counter()
        fig[name] = part()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        fig[name]["seconds"] = time.perf_counter() - t0
    log("phase k parts, s: " + ", ".join(f"{k} {fig[k]['seconds']:.1f}" for k in parts))
    parts = ("k1", "k2", "k3")
    fig["launches"] = sum(fig[k]["launches"] for k in parts)
    fig["update_launches"] = sum(fig[k]["update_launches"] for k in parts)
    if fig["update_launches"]:
        raise AssertionError(f"phase k: {fig['update_launches']} single-target launches")
    if not all(fig[k]["launches"] for k in parts):
        raise AssertionError(f"phase k: update_step did not launch in every part: "
                             f"{[fig[k]['launches'] for k in parts]}")
    return fig


def admission_payloads(stored: dict, per: int = 1024, every: int = 8):
    """Phase e's spans as ``per``-span payloads, JSON v2 and proto3 by turns,
    with every error tag taken out but on every ``every``-th payload, whose
    first span also carries one: a bulk payload holds no ``error`` byte (the
    ladder's value-class probe) and the others are error class. Returns
    ``[(body, cls, spans)]``."""
    import dataclasses

    from zipkin_tpu_torch.model import json_v2, proto3
    from zipkin_tpu_torch.runtime.overload import CLASS_BULK, CLASS_ERROR, OverloadController

    spans = stored["spans"]
    out = []
    for i in range(len(spans) // per):
        chunk = spans[i * per:(i + 1) * per]
        if i % every == every - 1:
            chunk = [dataclasses.replace(chunk[0], tags={**chunk[0].tags, "error": "true"})] + chunk[1:]
            cls = CLASS_ERROR
        else:
            chunk = [dataclasses.replace(s, tags={k: v for k, v in s.tags.items() if k != "error"})
                     if "error" in s.tags else s for s in chunk]
            cls = CLASS_BULK
        body = (proto3 if i % 2 else json_v2).encode_span_list(chunk)
        if OverloadController.classify(body) != cls:
            raise AssertionError(f"phase l: payload {i} is not of class {cls}")
        out.append((body, cls, chunk))
    return out


def phase_admission_repairs(torch, card: str, stored: dict, mirror_fig: dict, cfg=None,
                            device=None, serving_argv=None, max_stale_ms: int = 1500,
                            segment_bytes: int = 4 << 20) -> dict:
    """(l0) the mirror's repairs on the card. The in-process serves'
    memoized shaping is phase k2's on leg of this very run (its ingest rate
    against the off leg, and the memo's hits); then an in-process server
    (the line-rate path, no seal, ``TPU_MIRROR_MAX_STALE_MS`` of
    ``max_stale_ms``) with a 4 MiB segment (``segment_bytes``) takes 16 of
    phase e's payloads and
    registers the window's ``ttq:`` key, which outgrows the segment: the
    epoch leaves it out (counted ``segmentOversizedKeys``, no overflow) and a
    reader process serves the cardinality, quantile, overview and
    dependency routes; then, idle past ``max_stale_ms``, the reader still
    answers 200, its epoch re-stamped by the skipped publishes."""
    import dataclasses
    import os
    import pickle
    import signal
    import tempfile

    from zipkin_tpu_torch.ops import hll_kernel
    from zipkin_tpu_torch.server.app import ZipkinServer
    from zipkin_tpu_torch.server.config import ServerConfig
    from zipkin_tpu_torch.tpu.state import AggConfig

    cfg = cfg or AggConfig()
    truth = store_truth(stored["traffic"], cfg)
    on, off = mirror_fig["on"], mirror_fig["off"]
    fig = dict(card=card, k2_ratio=on["spans_per_s"] / off["spans_per_s"],
               k2_on=on["spans_per_s"], k2_off=off["spans_per_s"],
               k2_memo_hits=on["shape_memo_hits"], k2_serves=on["mirrorServes"])
    log(f"phase l0 ({card}): k2 of this run serves the mirror's shaped answers memoized per "
        f"generation ({on['shape_memo_hits']} memo hits in {on['mirrorServes']} serves): ingest "
        f"{on['spans_per_s']:.0f} spans/s mirror on against {off['spans_per_s']:.0f} off "
        f"({fig['k2_ratio']:.3f}x)")
    hll_kernel.update.launches = hll_kernel.update_step.launches = 0
    config = ServerConfig(host="127.0.0.1", port=0, storage_type="tpu", tpu_fast_ingest=True,
                          tpu_archive_dir=None, obs_windows_tick_s=0.25, obs_shadow_enabled=False,
                          tpu_mirror_segment_bytes=segment_bytes, tpu_readers=1,
                          tpu_mirror_max_stale_ms=max_stale_ms, tpu_agg=dataclasses.asdict(cfg))
    server = ZipkinServer(config, device=device, seal_interval_s=0).start()
    base = f"http://127.0.0.1:{server.port}"
    core = server.storage
    seg = core.mirror_segment
    pb = free_port_base(1)
    rbase = f"http://127.0.0.1:{pb}"
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, TPU_MIRROR_SEGMENT=seg.name, TPU_READERS="1",
               TPU_READER_PORT_BASE=str(pb))
    cmd = serving_argv or [sys.executable, "-m", "zipkin_tpu_torch.serving"]
    routes = ["/api/v2/tpu/cardinalities", "/api/v2/tpu/percentiles", "/api/v2/tpu/overview",
              f"/api/v2/dependencies?endTs={truth.t_end}&lookback={truth.lookback}"]
    with tempfile.TemporaryFile() as out:
        proc = None
        try:
            for p in stored["wire"][:16]:
                if post_full(base, p)[0] != 202:
                    raise AssertionError("phase l0: a POST was not answered 202")
            lo, hi = core._tt_epochs(truth.t_end, truth.lookback)
            if not core.mirror_register_key(f"ttq:{lo}:{hi}"):
                raise AssertionError("phase l0: the ttq: key was refused")
            ttq_bytes = len(pickle.dumps(core.timetier.window(core.agg, lo, hi)))
            if ttq_bytes <= seg.capacity:
                raise AssertionError(f"phase l0: the ttq: value ({ttq_bytes} bytes) fits the "
                                     f"{seg.capacity}-byte segment")
            t0 = time.perf_counter()
            proc = subprocess.Popen(cmd, cwd=root, env=env, stdout=out, stderr=subprocess.STDOUT)
            while not _up(rbase):
                if proc.poll() is not None:
                    raise AssertionError(f"phase l0: the front end exited {proc.returncode}")
                if time.perf_counter() - t0 > 120:
                    raise AssertionError("phase l0: the reader did not come up in 120 s")
                time.sleep(0.1)
            # first touches miss and register; the next epoch carries them
            deadline = time.monotonic() + 60
            while not all(http_get(rbase + r)[0] == 200 for r in routes):
                if time.monotonic() > deadline:
                    raise AssertionError("phase l0: the reader's routes were never served: "
                                         + str([http_get(rbase + r)[0] for r in routes]))
                time.sleep(0.1)
            c = core.ingest_counters()
            if c["segmentOversizedKeys"] < 1 or c["segmentOverflows"] or \
                    f"ttq:{lo}:{hi}" not in core.mirror.snapshot().values:
                raise AssertionError(f"phase l0: oversized {c['segmentOversizedKeys']}, "
                                     f"overflows {c['segmentOverflows']}")
            fig.update(oversized_keys=c["segmentOversizedKeys"], payload_bytes=c["segmentPayloadBytes"],
                       ttq_bytes=ttq_bytes, segment_bytes=seg.capacity)
            # idle past the bound: the skipped publishes re-stamp the epoch
            publishes, restamps = c["segmentPublishes"], c["segmentRestamps"]
            time.sleep(max_stale_ms / 1000.0 + 1.0)
            status, headers, _ = http_get(rbase + routes[0])
            c = core.ingest_counters()
            if status != 200 or float(headers["X-Staleness-Ms"]) > max_stale_ms:
                raise AssertionError(f"phase l0: an idle server's reader answered {status} "
                                     f"{headers.get('X-Staleness-Ms')}")
            fig.update(idle_status=status, idle_staleness_ms=float(headers["X-Staleness-Ms"]),
                       idle_publishes=c["segmentPublishes"] - publishes,
                       idle_restamps=c["segmentRestamps"] - restamps)
            proc.send_signal(signal.SIGTERM)
            if proc.wait(timeout=60) != 0:
                raise AssertionError(f"phase l0: the front end exited {proc.returncode}")
        except BaseException:
            out.seek(0)
            log("phase l0: serving output:\n" + out.read().decode(errors="replace")[-4000:])
            raise
        finally:
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
                _kill_readers(pb)
            server.stop()
    fig.update(launches=hll_kernel.update_step.launches, update_launches=hll_kernel.update.launches)
    log(f"phase l0: a {seg.capacity}-byte segment with the window's ttq: key registered "
        f"({ttq_bytes} bytes pickled): the epochs left it out ({fig['oversized_keys']} times, "
        f"segmentOversizedKeys) and published {fig['payload_bytes']} bytes, no overflow; the reader served "
        f"cardinalities, percentiles, overview and dependencies 200; idle "
        f"{max_stale_ms / 1000.0 + 1.0:.1f} s past a {max_stale_ms} ms bound it answered "
        f"{fig['idle_status']} at {fig['idle_staleness_ms']:.1f} ms staleness "
        f"({fig['idle_restamps']} re-stamps, {fig['idle_publishes']} publishes meanwhile); "
        f"update_step launches {fig['launches']}")
    return fig


LOADGEN = r'''
import json, pickle, sys, threading, time, urllib.error, urllib.request

spec = json.load(open(sys.argv[1]))
with open(spec["payloads"], "rb") as f:
    loads = pickle.load(f)  # [(body, cls)]
base = spec["base"]
posts, reads, marks = [], [], {}
lock = threading.Lock()
stop_reads = threading.Event()


def post(body):
    ctype = "application/x-protobuf" if body[:1] == b"\n" else "application/json"
    req = urllib.request.Request(base + "/api/v2/spans", data=body, method="POST",
                                 headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=300) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def send(leg, i):
    body, cls = loads[i % len(loads)]
    retries = 0
    while True:
        t0 = time.monotonic()
        status, headers, text = post(body)
        kind = ""
        if status == 429:
            kind = ("admission" if text.decode(errors="replace").startswith(("overload", "tenant"))
                    else "tier")
        with lock:
            posts.append((leg, cls, status, kind, "Retry-After" in headers, retries, t0,
                          i % len(loads)))
        if status == 429 and cls == "error" and kind == "tier":
            retries += 1  # a full tier: an error-class client retries
            time.sleep(min(0.05, int(headers.get("X-Retry-After-Ms", "5")) / 1000.0))
            continue
        return status


def reader():
    k = 0
    routes = spec["read_routes"]
    while not stop_reads.is_set():
        t0 = time.monotonic()
        try:
            with urllib.request.urlopen(base + routes[k % len(routes)], timeout=300) as resp:
                resp.read()
                ok = resp.status == 200
        except urllib.error.HTTPError:
            ok = False
        if ok:
            reads.append((t0, routes[k % len(routes)].split("?")[0].rsplit("/", 1)[1],
                          (time.monotonic() - t0) * 1e3))
        k += 1
        stop_reads.wait(spec["read_every_s"])


counter = iter(range(1 << 30))
counter_lock = threading.Lock()


def paced(leg, rate, seconds=None, stop_file=None, error_only=False):
    t0 = time.monotonic()
    n = 0
    while True:
        if seconds is not None and time.monotonic() - t0 >= seconds:
            break
        if stop_file is not None:
            try:
                open(stop_file).close()
                break
            except OSError:
                pass
            if time.monotonic() - t0 > spec["trickle_max_s"]:
                break
        with counter_lock:
            j = next(counter)
        if error_only:
            j = spec["error_idx"][j % len(spec["error_idx"])]
        send(leg, j)
        n += 1
        time.sleep(max(0.0, t0 + n / rate - time.monotonic()))
    return n, time.monotonic() - t0


def flood(seconds, clients):
    t0 = time.monotonic()

    def client():
        while time.monotonic() - t0 < seconds:
            with counter_lock:
                j = next(counter)
            send("flood", j)

    threads = [threading.Thread(target=client) for _ in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()


marks["paced"] = time.monotonic()
n, s = paced("paced", spec["paced_rate"], seconds=spec["paced_s"])
marks["paced_rate"] = n / s
marks["flood"] = time.monotonic()
rt = threading.Thread(target=reader)
rt.start()
flood(spec["flood_s"], spec["clients"])
marks["flood_end"] = time.monotonic()
stop_reads.set()
open(spec["flood_done"], "w").close()
n, s = paced("trickle", spec["trickle_rate"], stop_file=spec["stop"], error_only=True)
marks["trickle_end"] = time.monotonic()
rt.join()
with open(spec["out"], "w") as f:
    json.dump(dict(posts=posts, reads=reads, marks=marks), f)
'''


def phase_ladder(torch, card: str, stored: dict, i2_spans_per_s: float, cfg=None, device=None,
                 paced_s: float = 8.0, flood_s: float = 12.0, clients: int = 8,
                 workers: int = 2, trickle_rate: float = 10.0, readback: int = 512) -> tuple:
    """(l1) the ladder under a flood: an in-process server with the
    reference's overload defaults, the resume adapter with a disk archive,
    ``TPU_MP_WORKERS=2`` and windows every 0.25 s, fed phase e's spans as
    1,024-span payloads, one in eight error class (:func:`admission_payloads`)
    by a load generator in a process of its own (its clients hold no GIL of
    the server's): first one client paced at a quarter of i2's spans/s for
    ``paced_s`` (ingest alone: the tier's queue saturation against its
    limit), then ``clients`` clients back to back for ``flood_s`` (a bulk
    payload is not retried; an error payload is retried after a full tier
    until 202, and the ladder must never shed one) while one reader client
    polls the four aggregate routes every 0.1 s, then a trickle of
    error-class payloads (``trickle_rate`` a second, which the ladder admits
    at any level, so the critical-path gauges keep folding) until the
    ladder is back at B0. Prints each tick's level and top signal, sheds by
    class and cause, the error class's admitted share (1.0), that every 429
    carried ``Retry-After``, read p99 at B0 against B1 or higher and the
    seconds back to B0 once the flood stops. After a drain every acked span
    is on the card, the disk archive's index holds every acked trace with
    exactly the rows its acked payloads gave it, and ``readback`` acked
    traces read back in full with their span ids. Returns the figures and
    the still-running server for phases l2 and l3."""
    import collections
    import dataclasses
    import os
    import pickle
    import shutil
    import tempfile

    from zipkin_tpu_torch.ops import hll_kernel
    from zipkin_tpu_torch.runtime.overload import CLASS_ERROR, LEVEL_NAMES
    from zipkin_tpu_torch.server.app import ZipkinServer
    from zipkin_tpu_torch.server.config import ServerConfig
    from zipkin_tpu_torch.tpu.state import AggConfig

    cfg = cfg or AggConfig()
    truth = store_truth(stored["traffic"], cfg)
    loads = admission_payloads(stored)
    per = len(loads[0][2])
    root = tempfile.mkdtemp(prefix="zt-l1-")
    hll_kernel.update.launches = hll_kernel.update_step.launches = 0
    config = ServerConfig(host="127.0.0.1", port=0, storage_type="tpu", tpu_fast_ingest=True,
                          tpu_mp_workers=workers, obs_windows_tick_s=0.25,
                          tpu_archive_dir=os.path.join(root, "archive"),
                          tpu_agg=dataclasses.asdict(cfg))
    server = ZipkinServer(config, device=device, seal_interval_s=0.25).start()
    base = f"http://127.0.0.1:{server.port}"
    ctl = server._overload
    core = server.storage
    ticks = []  # (monotonic s, level, top signal, load index, signals)

    def on_tick(_w):
        st = ctl.status()
        ticks.append((time.monotonic(), st["level"], st["topSignal"], st["loadIndex"],
                      st["signals"]))

    def tick_text(rows, t0):
        return " ".join(f"{t - t0:.2f}:{LEVEL_NAMES[lv]}/{sig}/{load:.2f}"
                        for t, lv, sig, load, _ in rows)

    server._obs_windows.on_tick(on_tick)
    fig = dict(card=card, per=per, clients=clients, paced_s=paced_s, flood_s=flood_s,
               trickle_rate=trickle_rate)
    interval = per / (0.25 * i2_spans_per_s)
    spec = dict(base=base, payloads=os.path.join(root, "payloads.pkl"), paced_rate=1 / interval,
                paced_s=paced_s, flood_s=flood_s, clients=clients, trickle_rate=trickle_rate,
                trickle_max_s=90.0, error_idx=[i for i, x in enumerate(loads) if x[1] == CLASS_ERROR],
                read_every_s=0.1, flood_done=os.path.join(root, "flood_done"),
                stop=os.path.join(root, "stop"), out=os.path.join(root, "out.json"),
                read_routes=[f"/api/v2/dependencies?endTs={truth.t_end}&lookback={truth.lookback}",
                             "/api/v2/tpu/percentiles", "/api/v2/tpu/cardinalities",
                             "/api/v2/tpu/overview"])
    with open(spec["payloads"], "wb") as f:
        pickle.dump([(b, c) for b, c, _ in loads], f)
    with open(os.path.join(root, "spec.json"), "w") as f:
        json.dump(spec, f)
    proc = None
    try:
        wait_ready(server._mp_ingester, "phase l1")
        t_start = time.monotonic()
        proc = subprocess.Popen([sys.executable, "-c", LOADGEN, os.path.join(root, "spec.json")],
                                stderr=subprocess.PIPE)
        while not os.path.exists(spec["flood_done"]):
            if proc.poll() is not None:
                raise AssertionError(f"phase l1: the load generator exited {proc.returncode}: "
                                     f"{proc.stderr.read().decode(errors='replace')[-2000:]}")
            time.sleep(0.05)
        t_end = time.monotonic()
        # back to B0 under the trickle
        while ctl.level != 0:
            if time.monotonic() - t_end > 90 or proc.poll() is not None:
                log(f"phase l1: ticks {tick_text(ticks, t_start)}; the last ticks' signals "
                    + json.dumps([sig for *_, sig in ticks[-8:]]))
                raise AssertionError(f"phase l1: the ladder still at {ctl.level_name} "
                                     f"{time.monotonic() - t_end:.0f} s after the flood")
            time.sleep(0.02)
        fig["back_to_b0_s"] = time.monotonic() - t_end
        open(spec["stop"], "w").close()
        if proc.wait(timeout=120) != 0:
            raise AssertionError(f"phase l1: the load generator exited {proc.returncode}: "
                                 f"{proc.stderr.read().decode(errors='replace')[-2000:]}")
        with open(spec["out"]) as f:
            res = json.load(f)
        server._mp_ingester.drain()
        acked = [p[7] for p in res["posts"] if p[2] == 202]
        acked_spans = per * len(acked)
        if core.agg.host_counters["spans"] != acked_spans:
            raise AssertionError(f"phase l1: {core.agg.host_counters['spans']} spans on the card, "
                                 f"{acked_spans} acked")
        # the disk archive's index: each acked trace's rows, one a span of
        # each acked payload (payloads repeat, so a trace has one row a copy)
        t0 = time.perf_counter()
        want_rows = collections.Counter()
        for j, n in collections.Counter(acked).items():
            for s in loads[j][2]:
                want_rows[int(s.trace_id[-16:], 16)] += n
        have_rows = collections.Counter()
        for ids, *_ in core._disk.views():
            u, c = np.unique(np.asarray(ids), return_counts=True)
            have_rows.update(dict(zip(u.tolist(), c.tolist())))
        short = [t for t, n in want_rows.items() if have_rows.get(t, 0) != n]
        if short or sum(have_rows.values()) != acked_spans:
            raise AssertionError(f"phase l1: {len(short)} acked traces with other row counts in "
                                 f"the archive, {sum(have_rows.values())} rows for {acked_spans} "
                                 f"acked spans")
        fig["index_s"] = time.perf_counter() - t0
        fig["index_traces"] = len(want_rows)
        # and a sample of them read back in full
        want = {}
        for j in set(acked):
            for s in loads[j][2]:
                want.setdefault(s.trace_id, set()).add(s.id)
        sample = sorted(want)[::max(1, len(want) // readback)][:readback]
        t0 = time.perf_counter()
        got = core.traces().get_traces(sample).execute()
        fig["readback_s"] = time.perf_counter() - t0
        have = {}
        for trace in got:
            for s in trace:
                have.setdefault(s.trace_id, set()).add(s.id)
        if any(want[t] != have.get(t) for t in sample):
            raise AssertionError("phase l1: an acked trace read back without its spans")
        fig["readback_traces"] = len(sample)
    except BaseException:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        server.stop()
        shutil.rmtree(root, ignore_errors=True)
        raise
    posts, marks = res["posts"], res["marks"]
    fig["paced_rate"] = marks["paced_rate"]
    legs = {}
    for leg, cls, status, kind, retry_after, *_ in posts:
        row = legs.setdefault(leg, {"posts": 0, "202": 0, "admission_shed_bulk": 0,
                                    "admission_shed_error": 0, "tier_429_bulk": 0,
                                    "tier_429_error": 0, "other": 0, "429_without_retry_after": 0})
        row["posts"] += 1
        if status == 202:
            row["202"] += 1
        elif status == 429:
            row[f"{kind}_{'shed' if kind == 'admission' else '429'}_{cls}"] += 1
            row["429_without_retry_after"] += not retry_after
        else:
            row["other"] += 1
    fig["legs"] = legs
    # an error payload's first attempt is a payload sent; its retries follow
    # a full tier only, until a 202
    errors_sent = sum(1 for p in posts if p[1] == CLASS_ERROR and p[5] == 0)
    errors_admitted = sum(1 for p in posts if p[1] == CLASS_ERROR and p[2] == 202)
    fig["error_share"] = errors_admitted / max(1, errors_sent)
    if any(p[2] not in (202, 429) for p in posts):
        raise AssertionError(f"phase l1: statuses {sorted({p[2] for p in posts})}")
    if any(row["admission_shed_error"] for row in legs.values()):
        raise AssertionError("phase l1: the ladder shed an error-class payload")
    if fig["error_share"] != 1.0:
        raise AssertionError(f"phase l1: error-class admitted share {fig['error_share']}")
    if any(row["429_without_retry_after"] for row in legs.values()):
        raise AssertionError("phase l1: a 429 without Retry-After")

    def level_at(t):
        lv = 0
        for tt, lvl, *_ in ticks:
            if tt > t:
                break
            lv = lvl
        return lv

    reads = [(level_at(t), route, ms) for t, route, ms in res["reads"]]
    by = {"B0": [r for r in reads if r[0] == 0], "B1+": [r for r in reads if r[0] >= 1]}
    fig["read_p99_ms"] = {
        lv: {route: float(np.percentile([ms for _, k, ms in rows if k == route], 99))
             for route in ("dependencies", "percentiles", "cardinalities", "overview")
             if any(k == route for _, k, _ in rows)}
        for lv, rows in by.items()}
    fig["reads"] = {lv: len(rows) for lv, rows in by.items()}

    def max_level(lo, hi):
        return max([lv for t, lv, *_ in ticks if lo <= t < hi] or [0])

    fig["max_level"] = {"paced": max_level(marks["paced"], marks["flood"]),
                        "flood": max_level(marks["flood"], marks["flood_end"])}
    fig["ticks"] = [(t - t_start, lv, sig, load) for t, lv, sig, load, _ in ticks]
    fig["counters"] = {k: v for k, v in ctl.counters().items()
                       if k.startswith(("overload", "deadline"))}
    fig["update_launches"] = hll_kernel.update.launches
    fig["launches"] = hll_kernel.update_step.launches
    fig["root"] = root
    log(f"phase l1 ({card}): ticks (s:level/top signal/load index): {tick_text(ticks, t_start)}")
    log(f"phase l1: a load generator in its own process; one client paced at a quarter of i2's "
        f"{i2_spans_per_s:.0f} spans/s for {paced_s:.0f} s ({fig['paced_rate']:.1f} of "
        f"{1 / interval:.1f} payloads/s of {per} spans; highest level "
        f"{LEVEL_NAMES[fig['max_level']['paced']]}), then {clients} clients for {flood_s:.0f} s "
        f"(highest {LEVEL_NAMES[fig['max_level']['flood']]}), then error-class payloads at "
        f"{trickle_rate:.0f}/s; by leg {json.dumps(legs)}; error-class admitted share "
        f"{fig['error_share']:.3f} ({errors_admitted} payloads); every 429 carried Retry-After; "
        f"read p99 ms at B0 {json.dumps(fig['read_p99_ms']['B0'])} ({fig['reads']['B0']} reads) "
        f"against B1+ {json.dumps(fig['read_p99_ms']['B1+'])} ({fig['reads']['B1+']} reads); back "
        f"to B0 {fig['back_to_b0_s']:.2f} s after the flood; {acked_spans} acked spans on the card;"
        f" the archive's index holds all {fig['index_traces']} acked traces with their acked rows "
        f"({fig['index_s']:.2f} s), {fig['readback_traces']} of them read back in full in "
        f"{fig['readback_s']:.2f} s; controller {json.dumps(fig['counters'])}; update_step "
        f"launches {fig['launches']}")
    return fig, server


def phase_tenants(card: str, stored: dict, server, budget_payloads_s: float = 1.0,
                  l2_s: float = 6.0) -> dict:
    """(l2) tenants on phase l1's server, back at B0: its tenant table's
    budget set (as ``TPU_TENANT_INGEST_BYTES_PER_S`` sets it) to
    ``budget_payloads_s`` bulk payloads a second; tenant A sends at 4x that
    and tenant B at 0.5x for ``l2_s``. B gets no 429, every A shed carries
    ``X-Shed-Scope: tenant`` and ``X-Shed-Tenant: A``, and the global ladder
    stays B0; prints each tenant's offered, shed and retained counts."""
    import threading

    from zipkin_tpu_torch.ops import hll_kernel
    from zipkin_tpu_torch.runtime.overload import CLASS_BULK

    loads = [x for x in admission_payloads(stored) if x[1] == CLASS_BULK]
    size = sum(len(b) for b, _, _ in loads) / len(loads)
    ctl = server._overload
    ta = ctl.tenant_admission
    ta.bytes_per_s = budget_payloads_s * size
    base = f"http://127.0.0.1:{server.port}"
    hll_kernel.update.launches = hll_kernel.update_step.launches = 0
    out = {"A": [], "B": []}
    levels = []

    def client(tenant, rate, offset):
        t0 = time.perf_counter()
        i = 0
        while time.perf_counter() - t0 < l2_s:
            status, headers, _ = post_full(base, loads[(offset + i) % len(loads)][0],
                                           {"X-Tenant-Id": tenant})
            out[tenant].append((status, headers.get("X-Shed-Scope"), headers.get("X-Shed-Tenant"),
                                "Retry-After" in headers))
            levels.append(ctl.level)
            i += 1
            time.sleep(max(0.0, t0 + i / rate - time.perf_counter()))

    threads = [threading.Thread(target=client, args=("A", 4 * budget_payloads_s, 0)),
               threading.Thread(target=client, args=("B", 0.5 * budget_payloads_s, 97))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    server._mp_ingester.drain()
    st = ta.status()["tenants"]
    fig = dict(card=card, budget_bytes_per_s=ta.bytes_per_s,
               rows={t: {"offered": st[t]["offered"], "shed": st[t]["shed"],
                         "retained_spans": st[t]["retainedSpans"], "level": st[t]["level"]}
                     for t in ("A", "B")},
               a_statuses=[s for s, *_ in out["A"]], max_global_level=max(levels or [0]))
    ta.bytes_per_s = 0.0  # accounting only again
    if any(s != 202 for s, *_ in out["B"]):
        raise AssertionError(f"phase l2: tenant B got {[s for s, *_ in out['B']]}")
    a_sheds = [r for r in out["A"] if r[0] == 429]
    if not a_sheds or any(r[1:] != ("tenant", "A", True) for r in a_sheds):
        raise AssertionError(f"phase l2: tenant A's sheds {a_sheds}")
    if fig["max_global_level"]:
        raise AssertionError(f"phase l2: the global ladder left B0 ({fig['max_global_level']})")
    fig.update(launches=hll_kernel.update_step.launches, update_launches=hll_kernel.update.launches)
    log(f"phase l2 ({card}): tenant budget {ta.bytes_per_s or fig['budget_bytes_per_s']:.0f} "
        f"bytes/s ({budget_payloads_s} payloads/s); A at 4x, B at 0.5x for {l2_s:.0f} s: "
        f"{json.dumps(fig['rows'])}; B got no 429, all {len(a_sheds)} of A's sheds carried "
        f"X-Shed-Scope tenant and X-Shed-Tenant A with Retry-After; the global ladder stayed B0; "
        f"update_step launches {fig['launches']}")
    return fig


SUPERVISED_CHILD = r"""
import json, os, pickle, sys, time
from zipkin_tpu_torch.runtime.supervisor import EX_RESTART, ResumeSupervisor
from zipkin_tpu_torch.storage.tpu import TorchStorage
from zipkin_tpu_torch.tpu.state import AggConfig

root, mode, device = sys.argv[1], sys.argv[2], sys.argv[3]
cfg = AggConfig(**json.loads(sys.argv[4]))
with open(os.path.join(root, "payloads.pkl"), "rb") as f:
    wire, per = pickle.load(f)
store = TorchStorage(config=cfg, device=None if device == "cuda" else device,
                     checkpoint_dir=os.path.join(root, "snap"), wal_dir=os.path.join(root, "wal"),
                     archive_dir=os.path.join(root, "archive"), scrub_interval_s=0.0)
if mode == "victim":
    sup = ResumeSupervisor(store, window_s=0.1, deadline_s=float(sys.argv[5]))
    sent = 0
    for p in wire:
        store.ingest_json_fast(p, None)
        sent += 1
        time.sleep(0.02)
        reason = sup.observe(store.agg.host_counters["spans"])
        if reason is not None:
            break
    t0 = time.perf_counter()
    path = sup.finalize()
    with open(os.path.join(root, "victim.json"), "w") as f:
        json.dump(dict(reason=reason, sent=sent, spans=store.agg.host_counters["spans"],
                       snapshot=path, finalize_s=time.perf_counter() - t0), f)
    sys.stdout.flush()
    os._exit(EX_RESTART)
ids = sorted({s for s in json.loads(sys.argv[5])})
got = {t[0].trace_id: len(t) for t in store.get_traces(ids).execute() if t}
print(json.dumps(dict(spans=store.agg.host_counters["spans"], resume_offset=store.resume_offset,
                      wal_replay_batches=store.restore_stats["walReplayBatches"], traces=got)))
store.close()
"""


def phase_deadlines_and_supervisor(torch, card: str, stored: dict, server, cfg=None,
                                   device=None, deadline_s: float = 0.3) -> dict:
    """(l3) on phase l1's server a POST whose ``X-Request-Timeout-Ms`` is
    spent answers 504 with ``X-Deadline-Expired``, counted in
    ``deadlineExpired``; then a subprocess ingests phase e's payloads through
    the line-rate path of the resume adapter under
    ``ResumeSupervisor(deadline_s=...)``, trips, calls ``finalize()`` and
    exits 75 (``EX_RESTART``); a second process restores from the same dirs
    with every acked span, replays no WAL batch, and reads every acked
    trace back from the disk archive with the span count the payloads
    gave it."""
    import collections
    import dataclasses
    import os
    import pickle
    import shutil
    import tempfile

    from zipkin_tpu_torch.model import codec
    from zipkin_tpu_torch.runtime.supervisor import EX_RESTART
    from zipkin_tpu_torch.tpu.state import AggConfig

    cfg = cfg or AggConfig()
    base = f"http://127.0.0.1:{server.port}"
    before = json.loads(http_get(base + "/metrics")[2])["gauge.zipkin_tpu.deadlineExpired"]
    status, headers, _ = post_full(base, stored["wire"][0], {"X-Request-Timeout-Ms": "0"})
    after = json.loads(http_get(base + "/metrics")[2])["gauge.zipkin_tpu.deadlineExpired"]
    if status != 504 or headers.get("X-Deadline-Expired") != "1" or after != before + 1:
        raise AssertionError(f"phase l3: a spent deadline answered {status} {headers}, "
                             f"deadlineExpired {before} -> {after}")
    fig = dict(card=card, deadline_status=status, deadline_expired=after)
    root = tempfile.mkdtemp(prefix="zt-l3-")
    wire = stored["wire"]
    per = len(stored["spans"]) // len(wire)
    here = os.path.dirname(os.path.abspath(__file__))
    dev = "cuda" if device is None else str(device)
    agg = json.dumps(dataclasses.asdict(cfg))
    try:
        with open(os.path.join(root, "payloads.pkl"), "wb") as f:
            pickle.dump((wire, per), f)
        t0 = time.perf_counter()
        victim = subprocess.run([sys.executable, "-c", SUPERVISED_CHILD, root, "victim", dev, agg,
                                 str(deadline_s)], cwd=here, capture_output=True, text=True,
                                timeout=300)
        fig["victim_s"] = time.perf_counter() - t0
        if victim.returncode != EX_RESTART:
            raise AssertionError(f"phase l3: the supervised process exited {victim.returncode}: "
                                 f"{victim.stderr[-2000:]}")
        with open(os.path.join(root, "victim.json")) as f:
            v = json.load(f)
        if v["reason"] != "deadline" or not v["snapshot"] or not 0 < v["sent"] < len(wire):
            raise AssertionError(f"phase l3: the victim {v}")
        want = collections.Counter()
        for p in wire[:v["sent"]]:
            for s in codec.decode_spans(p):
                want[s.trace_id] += 1
        t0 = time.perf_counter()
        resumed = subprocess.run([sys.executable, "-c", SUPERVISED_CHILD, root, "resume", dev, agg,
                                  json.dumps(sorted(want))], cwd=here, capture_output=True,
                                 text=True, timeout=300)
        fig["resume_s"] = time.perf_counter() - t0
        if resumed.returncode != 0:
            raise AssertionError(f"phase l3: the resumed process exited {resumed.returncode}: "
                                 f"{resumed.stderr[-2000:]}")
        r = json.loads(resumed.stdout.strip().splitlines()[-1])
        if r["spans"] != v["spans"] or r["spans"] != per * v["sent"] or \
                r["resume_offset"] != v["spans"] or r["wal_replay_batches"]:
            raise AssertionError(f"phase l3: resumed {dict(r, traces=len(r['traces']))} after {v}")
        if r["traces"] != dict(want):
            bad = [t for t in want if r["traces"].get(t) != want[t]]
            raise AssertionError(f"phase l3: {len(bad)} acked traces read back unequal")
        fig.update(victim=v, resumed_spans=r["spans"], traces=len(want))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"phase l3 ({card}): X-Request-Timeout-Ms 0 -> 504 X-Deadline-Expired 1, deadlineExpired "
        f"{before} -> {after}; ResumeSupervisor(deadline_s={deadline_s}) tripped "
        f"({v['reason']}) after {v['sent']} of {len(wire)} payloads, finalize() {v['finalize_s']:.2f}"
        f" s, exit {EX_RESTART} ({fig['victim_s']:.1f} s with the boot); the relaunch restored "
        f"{r['spans']} spans = every acked one, replayed {r['wal_replay_batches']} WAL batches and "
        f"read all {len(want)} acked traces back with their span counts ({fig['resume_s']:.1f} s)")
    return fig


def phase_admission_cost(torch, card: str, stored: dict, cfg=None, device=None,
                         n_payloads: int = 32) -> dict:
    """(l4) admission's cost on the line-rate path: ``n_payloads`` of phase
    e's payloads through ``Collector(fast_ingest=True)`` into a fresh
    TorchStorage a run, with the server's controller (the reference's
    defaults, an accounting-only tenant table) on the collector and the
    store (``TPU_OVERLOAD`` on) and without (off): one warm-up and five
    pairs, the first side alternating (:func:`paired_runs`). Prints each
    pair's ratio, their median and range, and ``admit()``'s own ns a payload
    at B0 beside a payload's wall."""
    from zipkin_tpu_torch.collector import Collector
    from zipkin_tpu_torch.ops import hll_kernel
    from zipkin_tpu_torch.runtime.overload import OverloadController
    from zipkin_tpu_torch.runtime.tenant import TenantAdmission
    from zipkin_tpu_torch.tpu.state import AggConfig
    from zipkin_tpu_torch.tpu.store import TorchStorage

    cfg = cfg or AggConfig()
    wire = stored["wire"][:n_payloads]
    per = len(stored["spans"]) // len(stored["wire"])
    n_spans = per * len(wire)
    totals = dict(launches=0, update_launches=0, wall_s=0.0, payloads=0)

    def controller():
        ctl = OverloadController()
        ctl.tenant_admission = TenantAdmission()
        return ctl

    def run(on):
        store = TorchStorage(config=cfg, device=device)
        collector = Collector(store, fast_ingest=True)
        if on:
            collector.overload = store.overload = controller()
        hll_kernel.update.launches = hll_kernel.update_step.launches = 0
        t0 = time.perf_counter()
        for p in wire:
            collector.accept_spans_bytes(p)
        store.agg.block_until_ready()
        wall = time.perf_counter() - t0
        if store.agg.host_counters["spans"] != n_spans:
            raise AssertionError(f"phase l4: {store.agg.host_counters['spans']} spans landed")
        totals["launches"] += hll_kernel.update_step.launches
        totals["update_launches"] += hll_kernel.update.launches
        totals["wall_s"] += wall
        totals["payloads"] += len(wire)
        out = dict(on=on, spans_per_s=n_spans / wall, wall_ms=wall * 1e3)
        del store, collector
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        return out

    runs = paired_runs(run)
    verdict = on_off_verdict(runs)
    ctl = controller()
    reps = 20_000
    t0 = time.perf_counter_ns()
    for k in range(reps):
        ctl.admit(wire[k % len(wire)])
    t1 = time.perf_counter_ns()
    for k in range(reps):
        wire[k % len(wire)]
    admit_ns = (t1 - t0 - (time.perf_counter_ns() - t1)) / reps
    wall_us = totals["wall_s"] * 1e6 / totals["payloads"]
    fig = dict(card=card, runs=runs, **verdict, admit_ns=admit_ns, wall_us_per_payload=wall_us,
               launches=totals["launches"], update_launches=totals["update_launches"])
    log(f"phase l4 ({card}): f1's path over {len(wire)} payloads, a warm-up and five pairs, "
        f"admission on/off: spans/s "
        + ", ".join(f"{'warm-up ' if r['warmup'] else ''}{'on' if r['on'] else 'off'} "
                    f"{r['spans_per_s']:.0f}" for r in runs)
        + f"; {verdict_text(verdict)}; admit() {admit_ns:.0f} ns a payload at B0 against a "
        f"payload's {wall_us:.0f} us ({100 * admit_ns / 1e3 / wall_us:.4f}%); update_step "
        f"launches {fig['launches']}")
    return fig


def phase_admission(torch, card: str, stored: dict, i2_spans_per_s: float, mirror_fig: dict,
                    cfg=None, device=None, serving_argv=None, repairs_kw=None,
                    **ladder_kw) -> dict:
    """(l) admission on the card: l0 (:func:`phase_admission_repairs`), l1
    (:func:`phase_ladder`), l2 (:func:`phase_tenants`), l3
    (:func:`phase_deadlines_and_supervisor`) and l4
    (:func:`phase_admission_cost`). Each part's launches are counted from 0
    just before it; no part may launch the single-target kernel, and each
    part that feeds the card must launch ``update_step``."""
    import shutil

    fig = {}
    t0 = time.perf_counter()
    fig["l0"] = phase_admission_repairs(torch, card, stored, mirror_fig, cfg=cfg, device=device,
                                        serving_argv=serving_argv, **(repairs_kw or {}))
    fig["l0"]["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    fig["l1"], server = phase_ladder(torch, card, stored, i2_spans_per_s, cfg=cfg, device=device,
                                     **ladder_kw)
    fig["l1"]["seconds"] = time.perf_counter() - t0
    try:
        t0 = time.perf_counter()
        fig["l2"] = phase_tenants(card, stored, server)
        fig["l2"]["seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        fig["l3"] = phase_deadlines_and_supervisor(torch, card, stored, server, cfg=cfg,
                                                   device=device)
        fig["l3"]["seconds"] = time.perf_counter() - t0
    finally:
        server.stop()
        shutil.rmtree(fig["l1"].pop("root"), ignore_errors=True)
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    fig["l4"] = phase_admission_cost(torch, card, stored, cfg=cfg, device=device)
    fig["l4"]["seconds"] = time.perf_counter() - t0
    log("phase l parts, s: " + ", ".join(f"{k} {fig[k]['seconds']:.1f}"
                                         for k in ("l0", "l1", "l2", "l3", "l4")))
    parts = ("l0", "l1", "l2", "l4")
    fig["launches"] = sum(fig[k]["launches"] for k in parts)
    fig["update_launches"] = sum(fig[k]["update_launches"] for k in parts)
    if fig["update_launches"]:
        raise AssertionError(f"phase l: {fig['update_launches']} single-target launches")
    if not all(fig[k]["launches"] for k in parts):
        raise AssertionError(f"phase l: update_step did not launch in every part: "
                             f"{[fig[k]['launches'] for k in parts]}")
    return fig


def mesh_of(torch, n_shards: int, device=None) -> list:
    """``n_shards`` shards on one device (the card unless ``device`` names
    another): the reference's 8-shard deployment laid onto one card."""
    from zipkin_tpu_torch.parallel.mesh import make_mesh

    dev = torch.device(device) if device is not None else torch.device("cuda", 0)
    return make_mesh(n_shards, devices=[dev] * n_shards)


def phase_shards_agg(seed: int, n_spans: int, torch, card: str, cfg=None, device=None,
                     n_shards: int = 8, chunk: int = 8192) -> dict:
    """(m1) phase c's traffic (2**20 spans, seed 0, 8 x 8,192-span chunks a
    step, each chunk routed trace-affine as a parse worker routes it) into
    an ``n_shards``-shard TorchAggregator on one card and a one-shard one.
    Exact between the two: the merged histograms, HLL registers and span
    counters, the dependency matrices, the compacted edges over the whole
    window and over its hour (where a rolled lane and a live one count
    alike), the windowed histograms, the cardinalities and tt_read's
    epochs, registers, calls and errors; CTR_BATCHES is n_shards x the
    steps; the merged digest's p99s inside the digest's rank band, the
    overview equal to the reads it coalesces, every read one transfer.
    update_step launches once per shard a step; each shard's lanes of the
    last step through check_step, then the kernel against
    update_step_plain on fresh register files."""
    from zipkin_tpu_torch import u32
    from zipkin_tpu_torch.ops import hll_kernel, tdigest
    from zipkin_tpu_torch.parallel.aggregator import TorchAggregator, unfuse_columns
    from zipkin_tpu_torch.tpu import ingest as ing
    from zipkin_tpu_torch.tpu.columnar import route_fused
    from zipkin_tpu_torch.tpu.state import CTR_BATCHES, AggConfig, state_bytes
    from zipkin_tpu_torch.workload import BASE_MINUTE, generate, slice_columns

    cfg = cfg or AggConfig()
    mesh = mesh_of(torch, n_shards, device)
    traffic = generate(n_spans, seed=seed)
    cols = traffic.cols
    fig = dict(card=card, spans=n_spans, shards=n_shards)
    aggs, walls, launches = {}, {}, {}
    for label, m in (("S", mesh), ("one", mesh[:1])):
        agg = TorchAggregator(cfg, mesh=m)
        agg.block_until_ready()
        hll_kernel.update.launches = hll_kernel.update_step.launches = 0
        walls[label] = drive(agg, traffic, 8 * chunk, chunk, cfg)
        launches[label] = (hll_kernel.update.launches, hll_kernel.update_step.launches)
        aggs[label] = agg
    big, one = aggs["S"], aggs["one"]
    steps = len(walls["S"])
    if launches["S"] != (0, n_shards * steps) or launches["one"] != (0, steps):
        raise AssertionError(f"phase m1: hll launches {launches} over {steps} steps, want "
                             f"update_step {n_shards} a step at {n_shards} shards and 1 at one")
    gib = sum(state_bytes(st) for st in big.states) / 2**30
    sps = {k: n_spans / (sum(w) / 1e3) for k, w in walls.items()}
    fig.update(steps=steps, launches=launches["S"][1], one_launches=launches["one"][1],
               state_gib=gib, spans_per_s=sps["S"], one_spans_per_s=sps["one"],
               step_ms=statistics.median(walls["S"]), one_step_ms=statistics.median(walls["one"]),
               first_step_ms=walls["S"][0], rollups=big.ctx_stats["ctx_advances"])
    log(f"phase m1 ({card}): {n_spans} spans in {steps} steps into {n_shards} shards on "
        f"{mesh[0]} ({gib:.3f} GiB of state): {sps['S']:.0f} spans/s against {sps['one']:.0f} "
        f"at one shard ({sps['S'] / sps['one']:.3f}x); median step {fig['step_ms']:.2f} ms against "
        f"{fig['one_step_ms']:.2f} ms (first {walls['S'][0]:.1f} ms); update_step launches "
        f"{launches['S'][1]} = {n_shards} x {steps} steps; {fig['rollups']} rollup rounds; "
        f"step walls ms {[round(w, 2) for w in walls['S']]}")

    # --- each shard's lanes of the last step: kernel against plain
    lo = (steps - 1) * 8 * chunk
    image = route_fused(slice_columns(cols, lo, min(lo + 8 * chunk, cols.size)), n_shards)
    kw = dict(max_services=cfg.max_services, hll_rows=cfg.hll_rows, global_row=cfg.global_hll_row)
    err, live = 0, []
    for i, st in enumerate(big.states):
        batch = unfuse_columns(u32.from_numpy(image[i], mesh[i]))
        lanes, _, _ = ing.hll_lanes(cfg, torch.full_like(st.tb_epoch, -1), batch)
        args = tuple(lanes[x] for x in ("hashes", "svc", "valid", "tb_keep", "slot"))
        files = (torch.zeros_like(st.hll), torch.zeros_like(st.tb_hll).view(-1, st.tb_hll.shape[-1]))
        hll_kernel.check_step(*files, *args, **kw)
        got = tuple(x.clone() for x in files)
        want = tuple(x.clone() for x in files)
        hll_kernel.update_step(*got, *args, **kw)
        hll_kernel.update_step_plain(*want, *args, **kw)
        err = max(err, max(int((a.int() - b.int()).abs().max()) for a, b in zip(got, want)))
        live.append(int(lanes["valid"].sum()))
    if err:
        raise AssertionError(f"phase m1: update_step != update_step_plain on a shard's lanes: {err}")
    fig["max_abs_err"] = err
    log(f"phase m1: the last step's lanes of each shard (live {live} of {image.shape[-1]}) through "
        f"check_step, update_step == update_step_plain on fresh files (max abs err {err})")

    # --- the merges against one shard, exactly
    def exact(g, w, what):
        if g.dtype != w.dtype or g.shape != w.shape or not np.array_equal(g, w):
            raise AssertionError(f"phase m1: {what} at {n_shards} shards != one shard")

    reads = {}
    read_fns = {}
    for label, agg in (("S", big), ("one", one)):
        (h, r, c), *tr = counted(agg, agg.merged_sketches)
        reads[label] = dict(hist=h, hll=r, counters=c, transfers=tuple(tr))
    exact(reads["S"]["hist"], reads["one"]["hist"], "merged histograms")
    exact(reads["S"]["hll"], reads["one"]["hll"], "merged HLL registers")
    exact(reads["S"]["counters"][:4], reads["one"]["counters"][:4], "span counters")
    if reads["S"]["counters"][CTR_BATCHES] != n_shards * steps \
            or reads["one"]["counters"][CTR_BATCHES] != steps:
        raise AssertionError(f"phase m1: CTR_BATCHES {reads['S']['counters'][CTR_BATCHES]} and "
                             f"{reads['one']['counters'][CTR_BATCHES]}, want {n_shards * steps} and {steps}")
    full = (0, (1 << 32) - 1)
    hour = (BASE_MINUTE // 60 * 60, BASE_MINUTE // 60 * 60 + 59)
    win = (BASE_MINUTE, BASE_MINUTE + 60)
    for g, w, what in zip(big.dependency_matrices(*full), one.dependency_matrices(*full),
                          ("calls", "errors")):
        exact(g, w, f"dependency {what}")
    for name, window in (("whole window", full), ("hour", hour)):
        for g, w in zip(big.dependency_edges(*window), one.dependency_edges(*window)):
            exact(g, w, f"edges over the {name}")
    exact(big.windowed_histograms(*win), one.windowed_histograms(*win), "windowed histograms")
    exact(big.cardinalities(), one.cardinalities(), "cardinalities")
    ep = big.tt_max_epoch
    if ep != one.tt_max_epoch:
        raise AssertionError(f"phase m1: tt_max_epoch {ep} != {one.tt_max_epoch}")
    tt_s, tt_1 = big.tt_read(ep - 3, ep), one.tt_read(ep - 3, ep)
    for i, what in ((0, "epochs"), (1, "registers"), (3, "calls"), (4, "errors")):
        exact(tt_s[i], tt_1[i], f"tt_read {what}")
    old = (BASE_MINUTE, BASE_MINUTE + 2)
    paths = {k: a.window_fully_rolled(*old) for k, a in (("S", big), ("one", one))}
    old_edges = {k: int((a.dependency_edges(*old)[1] > 0).sum()) for k, a in (("S", big), ("one", one))}
    # the merged digest: counts exact, p99 inside the rank band, the
    # overview equal to the reads it coalesces
    dq, dn = big.quantiles(QS, "digest")
    key_counts = np.bincount(cols.key[cols.valid], minlength=cfg.max_keys)
    exact(dn, one.quantiles(QS, "digest")[1], "digest counts")
    if not np.array_equal(dn, key_counts.astype(dn.dtype)):
        raise AssertionError("phase m1: digest counts != the generated key counts")
    md = big.merged_digest()
    if not np.array_equal(md[..., 1].sum(-1), key_counts.astype(np.float32)):
        raise AssertionError("phase m1: merged digest weights != the key counts")
    oq, on, oe = big.sketch_overview(QS)
    if not (np.array_equal(oq, dq) and np.array_equal(on, dn) and np.array_equal(oe, big.cardinalities())):
        raise AssertionError("phase m1: the overview disagrees with the reads it coalesces")
    w99 = tdigest.cluster_q_width(cfg.digest_centroids, 0.99)
    order = np.argsort(cols.key, kind="stable")
    starts = np.searchsorted(cols.key[order], np.arange(cfg.max_keys + 1))
    big_keys = np.nonzero(key_counts >= 1000)[0]
    one_q = one.quantiles(QS, "digest")[0]
    rel, rel_one = [], []
    for k in big_keys:
        v = np.sort(cols.dur[order[starts[k]:starts[k + 1]]].astype(np.float64))
        lo_v, ex, hi_v = np.quantile(v, [0.99 - w99, 0.99, min(0.99 + w99, 1.0)])
        got = dq[k, QS.index(0.99)]
        if not lo_v <= got <= hi_v:
            raise AssertionError(f"phase m1: key {k}: merged digest p99 {got} outside [{lo_v}, {hi_v}]")
        rel.append(abs(got - ex) / ex)
        rel_one.append(abs(one_q[k, QS.index(0.99)] - ex) / ex)
    # every read one transfer, timed at both shard counts
    for label, agg in (("S", big), ("one", one)):
        read_fns[label] = {
            "digest_quantiles": lambda a=agg: a.quantiles(QS, "digest"),
            "hist_quantiles": lambda a=agg: a.quantiles(QS, "hist"),
            "windowed_quantiles": lambda a=agg: a.quantiles(QS, ts_lo_min=win[0], ts_hi_min=win[1]),
            "cardinalities": agg.cardinalities,
            "sketch_overview": lambda a=agg: a.sketch_overview(QS),
            "merged_digest": agg.merged_digest,
            "merged_sketches": agg.merged_sketches,
            "dependency_matrices": lambda a=agg: a.dependency_matrices(*full),
            "edges_cached": lambda a=agg: a.dependency_edges(*full),
            "tt_read": lambda a=agg: a.tt_read(ep - 3, ep),
        }
    transfers = {name: counted(big, fn)[1:] for name, fn in read_fns["S"].items()}
    if any(t != (1, 1) for t in transfers.values()):
        raise AssertionError(f"phase m1: a read made other than one transfer: {transfers}")
    read_ms = {label: {name: median_ms(fn) for name, fn in fns.items()} for label, fns in read_fns.items()}
    fig.update(read_ms=read_ms["S"], one_read_ms=read_ms["one"], p99_rel_median=statistics.median(rel),
               p99_rel_max=max(rel), one_p99_rel_median=statistics.median(rel_one),
               old_window_fully_rolled=paths, old_window_edges=old_edges)
    log(f"phase m1: exact against one shard: merged histograms, registers, span counters, "
        f"dependency matrices, edges over the whole window and its hour, windowed histograms, "
        f"cardinalities, tt_read epochs/registers/calls/errors over epochs {ep - 3}-{ep}; "
        f"CTR_BATCHES {n_shards * steps} = {n_shards} x {steps}; merged digest p99 inside the rank "
        f"band +-{w99:.4f} on {len(big_keys)} keys (relative value error median "
        f"{statistics.median(rel):.4f}, max {max(rel):.4f}; one shard {statistics.median(rel_one):.4f}); "
        f"every read one transfer. The minutes {old} are rolled-only at one shard "
        f"({paths['one']}) and not at {n_shards} ({paths['S']}, whose rings have not wrapped): "
        f"{old_edges} edges, hour-grained and minute-grained answers, not compared")
    log("phase m1 read wall ms, " + f"{n_shards} shards: " + json.dumps(
        {k: round(v, 4) for k, v in read_ms["S"].items()}) + "; one shard: " + json.dumps(
        {k: round(v, 4) for k, v in read_ms["one"].items()}))
    if mesh[0].type == "cuda":
        fig["peak_gib"] = torch.cuda.max_memory_allocated(mesh[0]) / 2**30
        log(f"phase m1: peak device memory {fig['peak_gib']:.3f} GiB")
    return fig


def phase_shards_store(seed: int, torch, card: str, stored: dict, cfg=None, device=None,
                       n_shards: int = 8, workers: int = 2) -> dict:
    """(m2) phase e's 64 payloads into the resume adapter
    ``TorchStorage(mesh=[card] * n_shards)`` with a disk archive:
    through f1's line-rate path (m2a), then into a second such store
    through the fan-out tier with ``workers`` parse workers coalescing 8
    chunks a step (m2b). Each time: every acked trace's rows are in the disk
    archive's index and 1,024 of them read back complete; update_step
    launches n_shards times a device
    step; the store's answers as the generator says (phase e's checks); the
    dependencies, histogram rows, cardinalities and counters equal a
    one-shard store's fed the same payloads. m2a's store snapshots at
    n_shards shards; a new n_shards-shard adapter restores it to the same
    reads, and a one-shard store refuses it, naming the shards."""
    import gc
    import logging
    import shutil
    import tempfile

    from zipkin_tpu_torch.collector import Collector
    from zipkin_tpu_torch.ops import hll_kernel
    from zipkin_tpu_torch.storage.tpu import TorchStorage as Adapter
    from zipkin_tpu_torch.tpu import snapshot as snap
    from zipkin_tpu_torch.tpu.mp_ingest import MultiProcessIngester
    from zipkin_tpu_torch.tpu.state import AggConfig
    from zipkin_tpu_torch.tpu.store import TorchStorage

    cfg = cfg or AggConfig()
    mesh = mesh_of(torch, n_shards, device)
    wire, traffic, spans = stored["wire"], stored["traffic"], stored["spans"]
    n_spans, n_traces = len(spans), len(spans) // 8
    trace_ids = [spans[8 * t].trace_id for t in range(n_traces)]
    truth = store_truth(traffic, cfg)
    fig = dict(card=card, spans=n_spans, shards=n_shards, payloads=len(wire))
    root = tempfile.mkdtemp(prefix="zt-phase-m2-")

    def free():
        gc.collect()
        if mesh[0].type == "cuda":
            torch.cuda.empty_cache()

    def read_back(store, what, sample: int = 1024):
        """Every acked trace's 8 rows in the disk archive's index, then
        ``sample`` traces read back in full (phase h1 reads all 32,768 at
        one shard; the archive does not depend on the shards)."""
        import collections

        t0 = time.perf_counter()
        have = collections.Counter()
        for ids, *_ in store._disk.views():
            u, c = np.unique(np.asarray(ids), return_counts=True)
            have.update(dict(zip(u.tolist(), c.tolist())))
        short = [t for t in trace_ids if have.get(int(t[-16:], 16)) != 8]
        if short or sum(have.values()) != n_spans:
            raise AssertionError(f"phase {what}: {len(short)} acked traces without their 8 rows in "
                                 f"the archive's index, {sum(have.values())} rows for {n_spans} spans")
        pick = list(range(0, n_traces, max(1, n_traces // sample)))[:sample]
        got = store.get_traces([trace_ids[t] for t in pick]).execute()
        if len(got) != len(pick):
            raise AssertionError(f"phase {what}: {len(got)} of {len(pick)} traces read back")
        for t, trace in zip(pick, got):
            want = spans[8 * t:8 * t + 8]
            if trace[0].trace_id != want[0].trace_id or \
                    sorted(s.id for s in trace) != sorted(s.id for s in want):
                raise AssertionError(f"phase {what}: trace {want[0].trace_id} read back differs")
        return time.perf_counter() - t0, len(pick)

    def same_reads(got, want, what, batches=True):
        """Exact, rows by name (several parse workers assign ids in
        arrival order); the tier's coalesced steps make other batches."""
        by_row = lambda rows: {(r["serviceName"], r["spanName"]): r for r in rows}  # noqa: E731
        for name in ("dependencies", "hist", "cardinalities", "counters"):
            g, w = got[name], want[name]
            if name == "counters" and not batches:
                g, w = dict(g, batches=0), dict(w, batches=0)
            if name == "hist":
                g, w = by_row(g), by_row(w)
            if g != w:
                raise AssertionError(f"phase {what}: {name} at {n_shards} shards != one shard")

    def counting(agg):
        batches = []
        inner = agg.ingest

        def count_batch(c):
            batches.append(int(c.valid.sum()))
            return inner(c)

        agg.ingest = count_batch
        return batches

    try:
        # the one-shard twin, fed through f1's path
        one = TorchStorage(config=cfg, device=mesh[0])
        one._deps_max_stale_ms = 0.0
        collector = Collector(one, fast_ingest=True)
        t0 = time.perf_counter()
        for p in wire:
            collector.accept_spans_bytes(p)
        one.agg.block_until_ready()
        one_sps = n_spans / (time.perf_counter() - t0)
        want = store_reads(one, truth)
        del one, collector
        free()

        # (m2a) the line-rate path at n_shards
        a = Adapter(config=cfg, mesh=mesh, archive_dir=f"{root}/a",
                    checkpoint_dir=f"{root}/snap")
        a._deps_max_stale_ms = 0.0
        batches = counting(a.agg)
        collector = Collector(a, fast_ingest=True)
        hll_kernel.update.launches = hll_kernel.update_step.launches = 0
        t0 = time.perf_counter()
        for p in wire:
            collector.accept_spans_bytes(p)
        a.agg.block_until_ready()
        wall = time.perf_counter() - t0
        launches = hll_kernel.update_step.launches
        del a.agg.ingest
        if hll_kernel.update.launches or launches != n_shards * len(batches) or sum(batches) != n_spans:
            raise AssertionError(f"phase m2a: {sum(batches)} spans in {len(batches)} device batches, "
                                 f"update_step launches {launches}, want {n_shards} a batch")
        readback_s, sampled = read_back(a, "m2a")
        checked = check_store_answers(a, a.agg, truth, spans, range(0, n_traces, n_traces // 8), "phase m2a")
        got = store_reads(a, truth)
        same_reads(got, want, "m2a")
        fig["m2a"] = dict(spans_per_s=n_spans / wall, one_spans_per_s=one_sps, wall_ms=wall * 1e3,
                          device_batches=len(batches), launches=launches, readback_s=readback_s,
                          keys=checked["keys"])
        log(f"phase m2a ({card}): {n_spans} spans in {len(wire)} payloads through the line-rate path "
            f"into TorchStorage(mesh=[{mesh[0]}] * {n_shards}) with a disk archive: {n_spans / wall:.0f} spans/s "
            f"against {one_sps:.0f} into a one-shard store without one ({n_spans / wall / one_sps:.3f}x), "
            f"{len(batches)} device batches, update_step launches {launches} = {n_shards} x "
            f"{len(batches)}; all {n_traces} acked traces in the archive's index with their 8 rows and "
            f"{sampled} read back complete ({readback_s:.2f} s); edges, cardinalities, percentile rows "
            f"and names as the generator says; dependencies, histogram rows, cardinalities and counters "
            f"equal one shard's")

        # snapshot at n_shards, restore into a new n_shards store
        t0 = time.perf_counter()
        if not a.snapshot():
            raise AssertionError("phase m2a: the snapshot was not taken")
        save_s = time.perf_counter() - t0
        meta = json.load(open(f"{root}/snap/{snap.META_FILE}"))
        snap_bytes = sum(v for k, v in dir_bytes(f"{root}/snap").items() if k.endswith(".npz"))
        a.close()
        del a, collector
        free()
        t0 = time.perf_counter()
        b = Adapter(config=cfg, mesh=mesh, checkpoint_dir=f"{root}/snap")
        boot_s = time.perf_counter() - t0
        b._deps_max_stale_ms = 0.0
        if not b.restore_stats.get("restoreMs") or b.agg.host_counters["spans"] != n_spans:
            raise AssertionError(f"phase m2a: restore at {n_shards} shards: {b.restore_stats}")
        restored = store_reads(b, truth)
        assert_reads_equal(restored, got, "phase m2a restored")
        restore_ms = b.restore_stats["restoreMs"]
        b.close()
        del b
        free()

        class Grab(logging.Handler):
            def __init__(self):
                super().__init__(logging.WARNING)
                self.text = []

            def emit(self, record):
                self.text.append(record.getMessage())

        grab = Grab()
        logging.getLogger("zipkin_tpu_torch.tpu.snapshot").addHandler(grab)
        try:
            c = TorchStorage(config=cfg, device=mesh[0])
            refused = not snap.maybe_restore(c, f"{root}/snap")
        finally:
            logging.getLogger("zipkin_tpu_torch.tpu.snapshot").removeHandler(grab)
        cause = f"has {n_shards} shards but this store has 1"
        if not refused or not any(cause in t for t in grab.text) or c.agg.host_counters["spans"]:
            raise AssertionError(f"phase m2a: a one-shard store took an {n_shards}-shard snapshot: "
                                 f"{grab.text}")
        del c
        free()
        fig["snapshot"] = dict(save_s=save_s, restore_ms=restore_ms, boot_s=boot_s, bytes=snap_bytes,
                               n_shards=meta["n_shards"])
        log(f"phase m2a: snapshot of {meta['n_shards']} shards saved in {save_s:.2f} s "
            f"({snap_bytes / 2**20:.1f} MiB on disk); a new {n_shards}-shard adapter booted in "
            f"{boot_s:.2f} s (restore {restore_ms:.1f} ms) to equal reads; a one-shard store refused "
            f"it: \"{cause}\"")

        # (m2b) the fan-out tier at n_shards
        d = Adapter(config=cfg, mesh=mesh, archive_dir=f"{root}/d")
        d._deps_max_stale_ms = 0.0
        ing = MultiProcessIngester(d, workers=workers, coalesce_max=8)
        try:
            wait_ready(ing, "phase m2b")
            ring = dict(slot_bytes=ing._ring.slot_bytes, image_bytes=ing._ring.img_cap_u32 * 4,
                        slots=ing._ring.n_workers * ing._ring.stripe_slots)
            hll_kernel.update.launches = hll_kernel.update_step.launches = 0
            t0 = time.perf_counter()
            for p in wire:
                ing.submit(p)
            ing.drain()
            wall = time.perf_counter() - t0
            launches = hll_kernel.update_step.launches
            stats = ing.stats()
        finally:
            ing.close()
        if stats["mpFallbacks"] or stats["mpAccepted"] != n_spans or d.agg.host_counters["spans"] != n_spans:
            raise AssertionError(f"phase m2b: {stats['mpAccepted']} spans accepted, "
                                 f"{stats['mpFallbacks']} fallbacks")
        if hll_kernel.update.launches or launches != n_shards * stats["mpGroups"]:
            raise AssertionError(f"phase m2b: update_step launches {launches}, want {n_shards} x "
                                 f"{stats['mpGroups']} groups")
        readback_s, sampled = read_back(d, "m2b")
        same_reads(store_reads(d, truth), want, "m2b", batches=False)
        fig["m2b"] = dict(spans_per_s=n_spans / wall, wall_ms=wall * 1e3, groups=stats["mpGroups"],
                          launches=launches, readback_s=readback_s, ring=ring, workers=workers)
        log(f"phase m2b ({card}): the fan-out tier ({workers} workers, coalesce 8) into "
            f"{n_shards} shards: {n_spans / wall:.0f} spans/s, {stats['mpGroups']} device steps, "
            f"update_step launches {launches} = {n_shards} x {stats['mpGroups']}; all {n_traces} "
            f"acked traces in the index, {sampled} read back ({readback_s:.2f} s); reads equal one "
            f"shard's; ring "
            f"{ring['slots']} slots of {ring['slot_bytes'] / 2**20:.1f} MiB (a routed image of "
            f"{n_shards} x 11 rows x {d.max_batch} lanes: {ring['image_bytes'] / 2**20:.1f} MiB)")
        d.close()
        del d
        free()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    fig["launches"] = fig["m2a"]["launches"] + fig["m2b"]["launches"]
    return fig


def phase_shards_entry(card: str, torch, timeout_s: float = 120.0, storage: str = "tpu") -> dict:
    """(m3) the entry point: ``TPU_DEVICES=1`` boots, serves and stops as
    f3 does; ``TPU_DEVICES`` one past the visible cards refuses to start
    (exit code not 0, the reference's ``requested N devices, have M``)."""
    import os

    fig = dict(card=card)
    fig["one"] = phase_entry(card, timeout_s, storage=storage, env_extra={"TPU_DEVICES": "1"},
                             what="m3")
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    ask = have + 1
    env = dict(os.environ, TPU_DEVICES=str(ask), TPU_ARCHIVE_DIR="off", QUERY_HOST="127.0.0.1")
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "zipkin_tpu_torch.server", "--port", "0",
                          "--storage", "tpu"], cwd=root, env=env, capture_output=True, text=True,
                         timeout=timeout_s)
    fig["refuse_s"] = time.perf_counter() - t0
    cause = f"requested {ask} devices, have {have}"
    if out.returncode == 0 or cause not in out.stderr:
        raise AssertionError(f"phase m3: TPU_DEVICES={ask} on {have} card(s) exited {out.returncode}: "
                             f"{out.stderr[-2000:]}")
    fig["refuse_rc"] = out.returncode
    log(f"phase m3 ({card}): TPU_DEVICES=1 boots to /health UP in {fig['one']['boot_s']:.1f} s and "
        f"serves; TPU_DEVICES={ask} on {have} card(s) exits {out.returncode} in {fig['refuse_s']:.1f} s: "
        f"\"{cause}\"")
    return fig


def phase_shards(seed: int, n_spans: int, torch, card: str, stored: dict, cfg=None, device=None,
                 n_shards: int = 8, entry_storage: str = "tpu") -> dict:
    """(m) the shard mesh: m1 the aggregator, m2 the store, m3 the entry
    point; each part's update_step launches counted from 0."""
    fig = {}
    t0 = time.perf_counter()
    fig["m1"] = phase_shards_agg(seed, n_spans, torch, card, cfg=cfg, device=device, n_shards=n_shards)
    fig["m1"]["seconds"] = time.perf_counter() - t0
    if device is None:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    fig["m2"] = phase_shards_store(seed, torch, card, stored, cfg=cfg, device=device, n_shards=n_shards)
    fig["m2"]["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    fig["m3"] = phase_shards_entry(card, torch, storage=entry_storage)
    fig["m3"]["seconds"] = time.perf_counter() - t0
    fig["launches"] = fig["m1"]["launches"] + fig["m2"]["launches"]
    log("phase m parts, s: " + ", ".join(f"{k} {fig[k]['seconds']:.1f}" for k in ("m1", "m2", "m3")))
    return fig


# -- (n) the wire entry points: broker transports, scribe, the UI, gRPC and the test kit


def scribe_frame(entries, seqid: int) -> bytes:
    """``scribe.Log(List<LogEntry>)`` as a framed, versioned thrift binary
    call; ``entries`` are (category, message) byte pairs."""
    import struct

    body = struct.pack(">I", 0x80010001) + struct.pack(">i", 3) + b"Log" + struct.pack(">i", seqid)
    body += bytes([15]) + struct.pack(">h", 1) + bytes([12]) + struct.pack(">i", len(entries))
    for category, message in entries:
        body += bytes([11]) + struct.pack(">h", 1) + struct.pack(">i", len(category)) + category
        body += bytes([11]) + struct.pack(">h", 2) + struct.pack(">i", len(message)) + message
        body += b"\x00"
    body += b"\x00"
    return struct.pack(">I", len(body)) + body


def scribe_entries(spans) -> list:
    """One (b"zipkin", base64 thrift v1 span) LogEntry a span."""
    import base64

    from zipkin_tpu_torch.model import thrift

    return [(b"zipkin", base64.b64encode(thrift.encode_span(s))) for s in spans]


def scribe_send(port: int, frames, timeout: float = 300.0) -> list:
    """Each frame on one connection, its reply read before the next; the
    ResultCode of each reply."""
    import socket
    import struct

    codes = []
    with socket.create_connection(("127.0.0.1", port), timeout=timeout) as sock:
        f = sock.makefile("rb")
        for frame in frames:
            sock.sendall(frame)
            (length,) = struct.unpack(">I", f.read(4))
            reply = f.read(length)
            codes.append(struct.unpack(">i", reply[-5:-1])[0] if reply[-7:-5] == b"\x00\x00" else -1)
    return codes


def assert_planes_by_name(store, want: dict, what: str) -> None:
    """The store's integer planes, keyed by name (arrival order assigns the
    vocab ids), equal ``want`` (:func:`planes_by_name` of another store)."""
    got = planes_by_name(store)
    for name in want:
        if got[name] != want[name]:
            raise AssertionError(f"{what}: the {name} plane differs (by name)")


def phase_transports(seed: int, torch, card: str, stored: dict, fast: dict, cfg=None,
                     device=None, workers: int = 4) -> dict:
    """(n1) the broker transports (BASELINE config[1]'s shape, a replay log
    standing in for Kafka, whose client the card lacks): phase e's payloads
    written with ``append_replay``, then

    - a QueueSource leg at one worker, whose leaves equal phase e's (= f1's)
      exactly, and at ``workers``, whose planes equal them by name;
    - ``TransportCollector(ReplayFileSource, Collector(store, fast_ingest=True),
      workers=4)`` into a TorchStorage with a disk archive: the planes equal
      the one-worker leg's by name, the reads answer as the generator
      says, every trace reads back complete, the marker stands at the last
      offset;
    - a resume leg on a second log: the collector closed once its marker
      passed half the log, a new source opened with ``resume=True`` drains
      the rest; no redelivered offset lies at or below the marker, every
      trace is present (its rows in the disk archive's index, 1,024 read
      back: cut from all 32,768 to save ~18 s), and the store counts every
      delivered payload's spans (at-least-once: the duplicates are
      counted).

    Each leg's spans/s beside f1's, and its update_step launches."""
    import os
    import shutil
    import tempfile

    from zipkin_tpu_torch.collector import Collector
    from zipkin_tpu_torch.collector.transports import (
        QueueSource,
        ReplayFileSource,
        TransportCollector,
        append_replay,
    )
    from zipkin_tpu_torch.ops import hll_kernel
    from zipkin_tpu_torch.tpu.state import AggConfig
    from zipkin_tpu_torch.tpu.store import TorchStorage

    cfg = cfg or AggConfig()
    wire, traffic, spans = stored["wire"], stored["traffic"], stored["spans"]
    n_spans, n_traces = len(spans), len(spans) // 8
    per = n_spans // len(wire)
    truth = store_truth(traffic, cfg)
    trace_ids = [spans[8 * t].trace_id for t in range(n_traces)]
    root = tempfile.mkdtemp(prefix="zt-transports-")
    fig = dict(card=card, spans=n_spans, payloads=len(wire), f1_spans_per_s=fast["spans_per_s"])

    def run(source, store, nworkers, stop_at, poll_batch=4):
        """Workers drain ``source`` until its commit reaches ``stop_at``;
        (wall s, update_step launches, the offsets polled). A poll takes
        ``poll_batch`` payloads, so the workers share the log (at the
        default 64 one poll would take all of it)."""
        polled = []
        poll = source.poll

        def recorded(n, timeout):
            out = poll(n, timeout)
            polled.extend(m.offset for m in out)
            return out

        source.poll = recorded
        tc = TransportCollector(source, Collector(store, fast_ingest=True), transport="n1",
                                workers=nworkers, poll_batch=poll_batch, poll_timeout=0.05)
        hll_kernel.update.launches = hll_kernel.update_step.launches = 0
        t0 = time.perf_counter()
        tc.start()
        try:
            while source.committed < stop_at:
                if time.perf_counter() - t0 > 300:
                    raise AssertionError(f"phase n1: commit at {source.committed} after 300 s, "
                                         f"want {stop_at}")
                time.sleep(0.002)
            store.agg.block_until_ready()
            wall = time.perf_counter() - t0
        finally:
            tc.close()
        if any(t.is_alive() for t in tc._threads):
            raise AssertionError("phase n1: a worker outlived close()")
        if hll_kernel.update.launches:
            raise AssertionError(f"phase n1: hll_update launched {hll_kernel.update.launches} times")
        return wall, hll_kernel.update_step.launches, polled

    def traces_present(store, what, exact, sample=None):
        """Every trace read back complete (``exact``: equal to the generated
        spans), or with ``sample``: every trace's rows in the disk archive's
        index, at least 8 a trace, and ``sample`` traces read back. Returns
        the spans stored past the generated ones (read back, or with
        ``sample`` the index's rows)."""
        import collections

        idx = range(n_traces)
        if sample is not None:
            have = collections.Counter()
            for ids, *_ in store._disk.views():
                u, c = np.unique(np.asarray(ids), return_counts=True)
                have.update(dict(zip(u.tolist(), c.tolist())))
            short = [t for t in trace_ids if have.get(int(t[-16:], 16), 0) < 8]
            if short:
                raise AssertionError(f"{what}: {len(short)} traces without their 8 rows in the index")
            idx = range(0, n_traces, n_traces // sample)
            stored_extra = sum(have.values()) - n_spans
        got = store.get_traces([trace_ids[t] for t in idx]).execute()
        if len(got) != len(idx):
            raise AssertionError(f"{what}: {len(got)} traces read back, want {len(idx)}")
        extra = 0
        for trace, t in zip(got, idx):
            want = spans[8 * t:8 * t + 8]
            if {(s.id, bool(s.shared)) for s in trace} != {(s.id, bool(s.shared)) for s in want}:
                raise AssertionError(f"{what}: trace {want[0].trace_id} read back incomplete")
            if exact and sorted(trace, key=lambda s: s.id) != sorted(want, key=lambda s: s.id):
                raise AssertionError(f"{what}: trace {want[0].trace_id} read back differs")
            extra += len(trace) - 8
        return extra if sample is None else stored_extra

    try:
        # the queue source at one worker (phase e's order) and at ``workers``
        for w in (1, workers):
            store = TorchStorage(config=cfg, device=device, deps_max_stale_ms=0.0)
            q = QueueSource(maxsize=len(wire))
            for p in wire:
                q.send(p)
            wall, launches, _ = run(q, store, w, len(wire) - 1)
            if launches != fast["launches"]:
                raise AssertionError(f"phase n1 queue x{w}: update_step launched {launches} times")
            if w == 1:
                assert_leaves_equal(store.agg.state_arrays(), stored["state"], "phase n1 queue x1")
                planes = planes_by_name(store)
            else:
                assert_planes_by_name(store, planes, f"phase n1 queue x{w}")
            fig[f"queue_{w}"] = dict(spans_per_s=n_spans / wall, launches=launches)
            store.close()
            del store
            torch.cuda.empty_cache()

        # the replay log, the marker at its end
        log_path = os.path.join(root, "spans.replay")
        append_replay(log_path, wire)
        store = TorchStorage(config=cfg, device=device, archive_dir=os.path.join(root, "a"),
                             deps_max_stale_ms=0.0)
        source = ReplayFileSource(log_path)
        wall, launches, polled = run(source, store, workers, len(wire) - 1)
        with open(log_path + ".offset") as f:
            marker = int(f.read())
        if marker != len(wire) - 1 or sorted(polled) != list(range(len(wire))):
            raise AssertionError(f"phase n1: marker {marker}, polled {sorted(polled)[:8]}...")
        if launches != fast["launches"]:
            raise AssertionError(f"phase n1: update_step launched {launches} times, f1 {fast['launches']}")
        assert_planes_by_name(store, planes, "phase n1 replay")
        if store.agg.host_counters["spans"] != n_spans:
            raise AssertionError(f"phase n1: host counters {store.agg.host_counters}")
        rng = np.random.default_rng(seed + 13)
        checked = check_store_answers(store, store.agg, truth, spans,
                                      rng.choice(n_traces, 64, replace=False), "phase n1")
        t0 = time.perf_counter()
        traces_present(store, "phase n1 replay", exact=True)
        fig["replay"] = dict(workers=workers, spans_per_s=n_spans / wall, launches=launches,
                             marker=marker, read_all_s=time.perf_counter() - t0,
                             edges=checked["edges"], digest_checked=checked["digest_checked"])
        store.close()
        del store
        torch.cuda.empty_cache()

        # the resume leg: close after half the log, reopen from the marker
        log2 = os.path.join(root, "resume.replay")
        append_replay(log2, wire)
        store = TorchStorage(config=cfg, device=device, archive_dir=os.path.join(root, "b"),
                             deps_max_stale_ms=0.0)
        first = ReplayFileSource(log2, resume=True)
        w1, l1, polled1 = run(first, store, workers, len(wire) // 2 - 1, poll_batch=2)
        with open(log2 + ".offset") as f:
            marker = int(f.read())
        second = ReplayFileSource(log2, resume=True)
        if second.committed != marker:
            raise AssertionError(f"phase n1 resume: reopened at {second.committed}, marker {marker}")
        w2, l2, polled2 = run(second, store, workers, len(wire) - 1, poll_batch=2)
        if not polled2 or min(polled2) <= marker or sorted(polled2) != list(range(marker + 1, len(wire))):
            raise AssertionError(f"phase n1 resume: marker {marker}, redelivered {sorted(polled2)[:8]}...")
        dups = sorted(set(polled1) & set(polled2))
        if store.agg.host_counters["spans"] != per * (len(polled1) + len(polled2)):
            raise AssertionError(f"phase n1 resume: {store.agg.host_counters['spans']} spans counted, "
                                 f"{len(polled1) + len(polled2)} payloads delivered")
        extra = traces_present(store, "phase n1 resume", exact=False, sample=1024)
        fig["resume"] = dict(marker_at_close=marker, first_offsets=len(polled1),
                             second_offsets=len(polled2), duplicates=len(dups), duplicate_spans=extra,
                             spans_per_s=n_spans / (w1 + w2), launches=l1 + l2)
        store.close()
        del store
        torch.cuda.empty_cache()

    finally:
        shutil.rmtree(root, ignore_errors=True)
    fig["launches"] = (fig["replay"]["launches"] + fig["resume"]["launches"]
                       + fig["queue_1"]["launches"] + fig[f"queue_{workers}"]["launches"])
    f1 = fast["spans_per_s"]
    log(f"phase n1 ({card}): {n_spans} spans in {len(wire)} payloads through TransportCollector -> "
        f"Collector(fast_ingest): replay log x{workers} {fig['replay']['spans_per_s']:.0f} spans/s "
        f"({fig['replay']['spans_per_s'] / f1:.3f}x f1's {f1:.0f}), queue x1 "
        f"{fig['queue_1']['spans_per_s']:.0f} ({fig['queue_1']['spans_per_s'] / f1:.3f}x), queue "
        f"x{workers} {fig[f'queue_{workers}']['spans_per_s']:.0f} "
        f"({fig[f'queue_{workers}']['spans_per_s'] / f1:.3f}x); update_step launches replay "
        f"{fig['replay']['launches']}, queue {fig['queue_1']['launches']} / "
        f"{fig[f'queue_{workers}']['launches']} (f1 {fast['launches']}); planes equal phase e's; "
        f"marker at {fig['replay']['marker']}; {n_traces} traces read back in "
        f"{fig['replay']['read_all_s']:.1f} s; {fig['replay']['edges']} edges exact")
    log(f"phase n1 resume: closed with the marker at {fig['resume']['marker_at_close']} "
        f"({fig['resume']['first_offsets']} payloads polled), {fig['resume']['second_offsets']} after "
        f"reopening, none at or below the marker; {fig['resume']['duplicates']} payloads redelivered "
        f"({fig['resume']['duplicate_spans']} duplicate rows in the archive); every trace in the index, "
        f"1,024 read back; "
        f"{fig['resume']['spans_per_s']:.0f} spans/s, launches {fig['resume']['launches']}")
    return fig


def phase_scribe(seed: int, torch, card: str, stored: dict, cfg=None, device=None,
                 per_frame: int = 1024, conns: int = 4) -> dict:
    """(n2) scribe and (n3) the UI on the card: a server with
    ``scribe_enabled``, scribe port 0 and a checkpoint dir; phase e's spans
    as base64 thrift v1 LogEntrys in frames of ``per_frame``, the first
    half over one connection and the rest over ``conns``, every reply OK.
    The planes (by name) and the reads equal those of a store fed
    ``decode_scribe_message`` of the same frames through
    ``Collector.accept``, and 64 traces read back as decoded. (Thrift v1
    has no ``shared`` flag: a parentless shared server span, which the
    generator renders, decodes unshared in both packages, so the links
    differ from (e)'s.) ``/metrics`` counts the spans under scribe. (n3) the UI routes
    on the same server. Then ``stop()`` and a boot from the checkpoint,
    whose leaves hold every acked span."""
    import concurrent.futures
    import dataclasses
    import os
    import shutil
    import tempfile

    from zipkin_tpu_torch.collector import Collector
    from zipkin_tpu_torch.collector.scribe import OK, decode_scribe_message
    from zipkin_tpu_torch.model import json_v2
    from zipkin_tpu_torch.ops import hll_kernel
    from zipkin_tpu_torch.server.app import ZipkinServer, build_storage
    from zipkin_tpu_torch.server.config import ServerConfig
    from zipkin_tpu_torch.tpu.state import AggConfig
    from zipkin_tpu_torch.tpu.store import TorchStorage

    cfg = cfg or AggConfig()
    traffic, spans = stored["traffic"], stored["spans"]
    n_spans = len(spans)
    truth = store_truth(traffic, cfg)
    t0 = time.perf_counter()
    entries = scribe_entries(spans)
    frames = [scribe_frame(entries[lo:lo + per_frame], i)
              for i, lo in enumerate(range(0, n_spans, per_frame))]
    fig = dict(card=card, spans=n_spans, frames=len(frames), encode_s=time.perf_counter() - t0,
               e_spans_per_s=stored["spans_per_s"])
    root = tempfile.mkdtemp(prefix="zt-scribe-")
    config = ServerConfig(host="127.0.0.1", port=0, storage_type="tpu", scribe_enabled=True,
                          scribe_port=0, tpu_checkpoint_dir=os.path.join(root, "snap"),
                          tpu_deps_max_stale_ms=0.0, obs_shadow_enabled=False,
                          tpu_agg=dataclasses.asdict(cfg))
    server = None
    try:
        server = ZipkinServer(config, seal_interval_s=0, device=device).start()
        store = server.storage
        half = len(frames) // 2
        hll_kernel.update.launches = hll_kernel.update_step.launches = 0
        t0 = time.perf_counter()
        codes = scribe_send(server.scribe_port, frames[:half])
        one_s = time.perf_counter() - t0
        parts = [frames[half + i::conns] for i in range(conns)]
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(conns) as pool:
            for got in pool.map(lambda fs: scribe_send(server.scribe_port, fs), parts):
                codes += got
        store.agg.block_until_ready()
        many_s = time.perf_counter() - t0
        launches = {"update": hll_kernel.update.launches, "update_step": hll_kernel.update_step.launches}
        if codes != [OK] * len(frames):
            raise AssertionError(f"phase n2: replies {sorted(set(codes))}, want all OK ({OK})")
        if launches["update"] or not launches["update_step"]:
            raise AssertionError(f"phase n2: hll launches {launches}")
        base = f"http://127.0.0.1:{server.port}"
        metrics = HttpStore(base).get("/metrics")
        if metrics.get("counter.zipkin_collector.spans.scribe") != n_spans:
            raise AssertionError(f"phase n2: /metrics spans.scribe "
                                 f"{metrics.get('counter.zipkin_collector.spans.scribe')}, want {n_spans}")

        # the reference: the same frames decoded and accepted in one store
        ref = TorchStorage(config=cfg, device=device, deps_max_stale_ms=0.0)
        collector = Collector(ref)
        decoded = []
        t0 = time.perf_counter()
        for lo in range(0, n_spans, per_frame):
            batch = [s for _, m in entries[lo:lo + per_frame] for s in decode_scribe_message(m)]
            collector.accept(batch)
            decoded += batch
        ref.agg.block_until_ready()
        fig["reference_accept_s"] = time.perf_counter() - t0
        assert_planes_by_name(store, planes_by_name(ref), "phase n2 vs accept")
        by_row = lambda rows: {(r["serviceName"], r["spanName"]): r for r in rows}  # noqa: E731
        reads, ref_reads = store_reads(store, truth), store_reads(ref, truth)
        for name in ("dependencies", "cardinalities"):
            if reads[name] != ref_reads[name]:
                raise AssertionError(f"phase n2: the {name} read differs from the accept store's")
        if by_row(reads["hist"]) != by_row(ref_reads["hist"]):
            raise AssertionError("phase n2: the histogram rows differ from the accept store's")
        ref.close()
        del ref, collector
        torch.cuda.empty_cache()
        rng = np.random.default_rng(seed + 17)
        for t in rng.choice(n_spans // 8, 64, replace=False):
            want = sorted(json_v2.encode_span(x) for x in decoded[8 * t:8 * t + 8])
            got = [json_v2.encode_span(x) for x in store.get_trace(decoded[8 * t].trace_id).execute()]
            if sorted(got) != want:
                raise AssertionError(f"phase n2: trace {decoded[8 * t].trace_id} read back differs")
        fig["ui"] = phase_ui(card, base)
        want = planes_by_name(store)
        server.stop()
        server = None
        fig.update(one_conn_spans_per_s=half * per_frame / one_s,
                   many_conn_spans_per_s=(n_spans - half * per_frame) / many_s,
                   spans_per_s=n_spans / (one_s + many_s), launches=launches["update_step"],
                   update_launches=launches["update"], edges=len(reads["dependencies"]),
                   edges_http=len(truth.edges))

        # a boot from the checkpoint holds every acked span
        t0 = time.perf_counter()
        reborn = build_storage(dataclasses.replace(config, scribe_enabled=False), device=device)
        fig["reboot_s"] = time.perf_counter() - t0
        try:
            assert_planes_by_name(reborn, want, "phase n2 reborn vs victim")
            if reborn.agg.host_counters["spans"] != n_spans:
                raise AssertionError(f"phase n2: the reborn store counts "
                                     f"{reborn.agg.host_counters['spans']} spans, want {n_spans}")
        finally:
            reborn.close()
        del reborn, store
        torch.cuda.empty_cache()
    finally:
        if server is not None:
            server.stop()
        shutil.rmtree(root, ignore_errors=True)
    log(f"phase n2 ({card}): {n_spans} spans as {len(frames)} scribe frames of {per_frame} "
        f"(encoded in {fig['encode_s']:.1f} s): one connection {fig['one_conn_spans_per_s']:.0f} spans/s, "
        f"{conns} connections {fig['many_conn_spans_per_s']:.0f}, all {fig['spans_per_s']:.0f} "
        f"({fig['spans_per_s'] / stored['spans_per_s']:.3f}x phase e's {stored['spans_per_s']:.0f}); every "
        f"reply OK; update_step launches {fig['launches']}, update {fig['update_launches']}; planes by "
        f"name and the reads equal a store fed decode_scribe_message through accept "
        f"({fig['reference_accept_s']:.1f} s; {fig['edges']} links, {fig['edges_http']} over HTTP: v1 "
        f"has no shared flag); 64 traces read back as decoded; /metrics spans.scribe {n_spans}; "
        f"stop() and a boot from the checkpoint ({fig['reboot_s']:.1f} s) hold every acked span")
    return fig


def phase_ui(card: str, base: str, reps: int = 5) -> dict:
    """(n3) the built-in UI on a running server: ``/zipkin/``, the three
    assets and ``/config.json``; bodies equal the port's files, the CSP on
    every page and asset, 404 for an unknown name; median wall ms of
    ``reps`` GETs each."""
    import os
    import urllib.error
    import urllib.request

    import zipkin_tpu_torch.server.ui as ui
    from zipkin_tpu_torch.server.app import UI_CSP

    def get(path):
        try:
            with urllib.request.urlopen(base + path, timeout=60) as r:
                return r.status, r.headers.get("Content-Security-Policy"), r.read()
        except urllib.error.HTTPError as e:
            return e.code, None, e.read()

    fig = {}
    pages = {"/zipkin/": "index.html", "/zipkin": "index.html"}
    pages.update({f"/zipkin/static/{n}": n for n in ("index.html", "app.js", "style.css")})
    for path, name in pages.items():
        with open(os.path.join(ui.STATIC_DIR, name), "rb") as f:
            want = f.read()
        status, csp, body = get(path)
        if (status, csp, body) != (200, UI_CSP, want):
            raise AssertionError(f"phase n3: {path}: {status}, CSP {csp!r}, {len(body)} bytes")
        fig[path] = median_ms(lambda: get(path), reps)
    status, _, body = get("/config.json")
    config = json.loads(body)
    if status != 200 or config.get("dependency") != {"enabled": True} or "queryLimit" not in config:
        raise AssertionError(f"phase n3: /config.json {status} {body[:200]!r}")
    fig["/config.json"] = median_ms(lambda: get("/config.json"), reps)
    if get("/zipkin/static/nope.js")[0] != 404:
        raise AssertionError("phase n3: an unknown asset does not answer 404")
    log(f"phase n3 ({card}): the UI's pages, assets and /config.json equal the port's files with the "
        f"CSP; an unknown asset 404; median ms of {reps}: "
        + json.dumps({k: round(v, 3) for k, v in fig.items()}))
    return fig


def phase_wire_entry(card: str, timeout_s: float = 120.0, storage: str = "tpu") -> dict:
    """(n4) ``python -m zipkin_tpu_torch.server`` with
    COLLECTOR_SCRIBE_ENABLED=1: boot, one scribe frame, the trace read back
    over HTTP, SIGTERM -> 0. Then with COLLECTOR_GRPC_ENABLED=1: where
    ``import grpc`` fails the run exits non-zero naming ``grpc``; where it
    succeeds one Report is sent and its spans read back."""
    import importlib.util
    import os
    import signal
    import socket
    import tempfile

    root = os.path.dirname(os.path.abspath(__file__))

    def free_port():
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            return sock.getsockname()[1]

    fig = dict(card=card)
    has_grpc = importlib.util.find_spec("grpc") is not None
    for leg in ("scribe", "grpc"):
        port, wire_port = free_port(), free_port()
        env = dict(os.environ, TPU_ARCHIVE_DIR="off", TPU_DEPS_MAX_STALE_MS="0", QUERY_HOST="127.0.0.1")
        if leg == "scribe":
            env.update(COLLECTOR_SCRIBE_ENABLED="1", COLLECTOR_SCRIBE_PORT=str(wire_port))
        else:
            env.update(COLLECTOR_GRPC_ENABLED="1", COLLECTOR_GRPC_PORT=str(wire_port))
        http = HttpStore(f"http://127.0.0.1:{port}")
        with tempfile.TemporaryFile() as out:
            t0 = time.perf_counter()
            proc = subprocess.Popen([sys.executable, "-m", "zipkin_tpu_torch.server", "--port", str(port),
                                     "--storage", storage], cwd=root, env=env, stdout=out,
                                    stderr=subprocess.STDOUT)
            try:
                if leg == "grpc" and not has_grpc:
                    rc = proc.wait(timeout=timeout_s)
                    out.seek(0)
                    text = out.read().decode(errors="replace")
                    if rc == 0 or "grpc package cannot be imported" not in text:
                        raise AssertionError(f"phase n4: gRPC without grpc: exit {rc}, {text[-400:]!r}")
                    fig["grpc"] = dict(refused=True, exit_code=rc, refuse_s=time.perf_counter() - t0)
                    continue
                while True:
                    if proc.poll() is not None:
                        raise AssertionError(f"phase n4 {leg}: exited {proc.returncode} before /health")
                    try:
                        if http.get("/health")["status"] == "UP":
                            break
                    except (OSError, AssertionError):
                        pass
                    if time.perf_counter() - t0 > timeout_s:
                        raise AssertionError(f"phase n4 {leg}: /health not UP within {timeout_s} s")
                    time.sleep(0.25)
                boot_s = time.perf_counter() - t0
                now_ms = int(time.time() * 1000)
                trace = small_trace(0x5C12BE0000000000 + (leg == "grpc"), "wire-" + leg,
                                    (now_ms - 60_000) * 1000)
                if leg == "scribe":
                    (code,) = scribe_send(wire_port, [scribe_frame(scribe_entries(trace), 1)], 60)
                    if code != 0:
                        raise AssertionError(f"phase n4: scribe reply {code}")
                else:
                    import grpc

                    from zipkin_tpu_torch.model import proto3
                    from zipkin_tpu_torch.server.grpc import METHOD

                    with grpc.insecure_channel(f"127.0.0.1:{wire_port}") as ch:
                        ch.unary_unary(METHOD)(proto3.encode_span_list(trace), timeout=60)
                got = http.get(f"/api/v2/trace/{trace[0].trace_id}")
                if len(got) != len(trace):
                    raise AssertionError(f"phase n4 {leg}: read back {got}")
                proc.send_signal(signal.SIGTERM)
                rc = proc.wait(timeout=30)
                if rc != 0:
                    raise AssertionError(f"phase n4 {leg}: exit code {rc} after SIGTERM")
                fig[leg] = dict(boot_s=boot_s, exit_code=rc)
            except BaseException:
                out.seek(0)
                log(f"phase n4 {leg}: server output:\n" + out.read().decode(errors="replace")[-4000:])
                raise
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait(timeout=30)
    grpc_text = ("refused to start, exit code {exit_code}, naming the grpc package, in {refuse_s:.1f} s"
                 if fig["grpc"].get("refused") else "a Report read back, booted in {boot_s:.1f} s")
    log(f"phase n4 ({card}): python -m zipkin_tpu_torch.server --storage {storage} with "
        f"COLLECTOR_SCRIBE_ENABLED=1: /health UP in {fig['scribe']['boot_s']:.1f} s, a scribe frame "
        f"answered OK and its trace read back over HTTP, SIGTERM -> 0; with COLLECTOR_GRPC_ENABLED=1 "
        f"(grpc {'importable' if has_grpc else 'not importable'} here): "
        + grpc_text.format(**fig["grpc"]))
    return fig


def phase_testkit(card: str) -> dict:
    """(n5) ZipkinMock: a POST read back, an enqueued 503 answered, and the
    next POST stored."""
    import urllib.error
    import urllib.request

    from zipkin_tpu_torch.model import json_v2
    from zipkin_tpu_torch.testkit import HttpFailure, ZipkinMock

    now_us = int(time.time() * 1e6)
    trace = small_trace(0x7E57C17000000000, "testkit", now_us - 60_000_000)
    body = json_v2.encode_span_list(trace)

    def post(url):
        req = urllib.request.Request(url, data=body, headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                return r.status
        except urllib.error.HTTPError as e:
            return e.code

    t0 = time.perf_counter()
    with ZipkinMock() as zipkin:
        if post(zipkin.http_url) != 202 or zipkin.trace_count != 1 or len(zipkin.traces()[0]) != 2:
            raise AssertionError("phase n5: the first POST was not stored")
        zipkin.enqueue_failure(HttpFailure.send_error_response(503, "go away"))
        if post(zipkin.http_url) != 503 or zipkin.trace_count != 1:
            raise AssertionError("phase n5: the enqueued 503 was not answered")
        if post(zipkin.http_url) != 202 or zipkin.http_request_count != 3:
            raise AssertionError("phase n5: the POST after the failure was not stored")
        spans = zipkin.collector_metrics().get("spans", "http")
    fig = dict(card=card, wall_s=time.perf_counter() - t0, spans=spans)
    log(f"phase n5 ({card}): ZipkinMock stored a POST, answered an enqueued 503, stored the next "
        f"POST ({spans} spans counted, {fig['wall_s']:.2f} s)")
    return fig


def phase_wire(seed: int, torch, card: str, stored: dict, fast: dict, cfg=None, device=None,
               entry_storage: str = "tpu") -> dict:
    """(n) the wire entry points: n1 the broker transports, n2 scribe with
    n3 the UI on its server, n4 the entry point with scribe and gRPC, n5 the
    test kit. Each part's launches are counted from 0."""
    t = time.perf_counter()
    fig = {"n1": phase_transports(seed, torch, card, stored, fast, cfg=cfg, device=device)}
    fig["n1"]["s"] = time.perf_counter() - t
    t = time.perf_counter()
    fig["n2"] = phase_scribe(seed, torch, card, stored, cfg=cfg, device=device)
    fig["n2"]["s"] = time.perf_counter() - t
    t = time.perf_counter()
    fig["n4"] = phase_wire_entry(card, storage=entry_storage)
    fig["n4"]["s"] = time.perf_counter() - t
    fig["n5"] = phase_testkit(card)
    fig["launches"] = fig["n1"]["launches"] + fig["n2"]["launches"]
    fig["update_launches"] = fig["n2"]["update_launches"]
    log(f"phase n ({card}): seconds n1 {fig['n1']['s']:.1f}, n2+n3 {fig['n2']['s']:.1f}, "
        f"n4 {fig['n4']['s']:.1f}, n5 {fig['n5']['wall_s']:.1f}")
    return fig



def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--spans", type=int, default=1 << 20)
    parser.add_argument("--store-spans", type=int, default=1 << 18,
                        help="spans through the store's object path (phase e)")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from zipkin_tpu_torch import kernels
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    kernels.build()
    log(f"kernels built in {time.perf_counter() - t0:.1f} s: {', '.join(kernels.SOURCES)}")
    for name, out in kernels.BUILD_LOGS.items():  # -Xptxas=-v: registers, shared memory, spills
        log(f"nvcc {name}: " + " | ".join(ln.strip() for ln in out.splitlines() if "ptxas info" in ln))

    # the kernels are timed without the device observatory's event pairs
    # around each launch; phase j1 measures what the plane costs
    from zipkin_tpu_torch.obs.device import OBSERVATORY

    OBSERVATORY.set_enabled(False)
    t0 = time.perf_counter()
    cases = phase_kernels(args.seed, torch)
    OBSERVATORY.set_enabled(True)
    log(f"phase a done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_gpu_vs_cpu(args.seed, torch)
    log(f"phase b done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches, agg, traffic = phase_main(args.seed, args.spans, torch)
    log(f"phase c done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    OBSERVATORY.set_enabled(False)
    step_cases = phase_step(torch, agg, traffic, 8192)
    OBSERVATORY.set_enabled(True)
    log(f"phase a2 done in {time.perf_counter() - t0:.1f} s")
    del agg, traffic
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    sampled = phase_sampled(args.seed, args.spans, torch, card)
    log(f"phase d done in {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    stored = phase_store(args.seed, args.store_spans, torch, card)
    log(f"phase e done in {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    fast = phase_fast(args.seed, torch, card, stored)
    torch.cuda.empty_cache()
    log(f"phase f1 done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    served = phase_server(args.seed, torch, card, stored)
    torch.cuda.empty_cache()
    log(f"phase f2 done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    entry = phase_entry(card)
    log(f"phase f3 done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    durable = phase_durable(torch, card, stored, fast)
    torch.cuda.empty_cache()
    log(f"phase g1 done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_resume_entry(card, stored["wire"], stored["spans"], entry["boot_s"])
    log(f"phase g2 done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    archived = phase_archive(args.seed, torch, card, stored, fast)
    torch.cuda.empty_cache()
    log(f"phase h done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    fanned = phase_fanout(args.seed, torch, card, stored, fast)
    torch.cuda.empty_cache()
    log(f"phase i done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    a2_ms = sum(c["ms"] for c in step_cases) / len(step_cases)
    observed = phase_obs(args.seed, torch, card, stored, a2_ms)
    torch.cuda.empty_cache()
    log(f"phase j done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    served_k = phase_serve(torch, card, stored)
    torch.cuda.empty_cache()
    log(f"phase k done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    admitted = phase_admission(torch, card, stored, fanned["i2"]["spans_per_s"], served_k["k2"])
    torch.cuda.empty_cache()
    log(f"phase l done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    sharded = phase_shards(args.seed, args.spans, torch, card, stored)
    torch.cuda.empty_cache()
    log(f"phase m done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    wired = phase_wire(args.seed, torch, card, stored, fast)
    torch.cuda.empty_cache()
    log(f"phase n done in {time.perf_counter() - t0:.1f} s")

    # hll_update: its single-target cases of phase a (uniform rows, both
    # shapes, fresh and filled); hll_update_step: the main path's own lanes,
    # fresh and filled. Each reports the mean over its cases, each case
    # beside it; launches are those of the main path's run (phase c),
    # launches_phase_d those of the sampled run (phase d),
    # launches_phase_e those of the store's object path (phase e),
    # launches_phase_f those of the line-rate path (phase f1; f2 is checked
    # against its own device batches and printed with it) and
    # launches_phase_g those of durable boot in process (phase g1: the
    # victim's batches and two boots' replays; g2's server is a subprocess,
    # checked through its /metrics), launches_phase_h those of the disk
    # archive's phase (h1's and h4's device batches) and launches_phase_i
    # those of the parse fan-out's (i1-i5, the i3 replay included; each
    # part's count is in launches_phase_i_parts) and launches_phase_j those
    # of the observability plane's (j1's eleven runs, j2's and j3's servers,
    # j5's eleven passes; each part's count is in launches_phase_j_parts) and
    # launches_phase_k those of the tracer, mirror and readers' (k1's twelve
    # passes, k2's two stores, k3's server; launches_phase_k_parts) and
    # launches_phase_l those of admission's (l0's server, l1's and l2's
    # server with the tier, l4's eleven runs; launches_phase_l_parts) and
    # launches_phase_m those of the shard mesh's (m1's 8-shard aggregator,
    # m2a's and m2b's 8-shard stores; launches_phase_m_parts adds m1's
    # one-shard twin, which launches once a step) and launches_phase_n
    # those of the wire entry points' (n1's four transport legs, n2's
    # scribe server; launches_phase_n_parts).
    mean = lambda cs, key: sum(c[key] for c in cs) / len(cs)
    source, replaces = "zipkin_tpu_torch/csrc/hll_update.cu", "zipkin_tpu/ops/pallas_hll.py:67"
    records = [
        dict(name="hll_update", route="cuda", source=source, replaces=replaces,
             launches=launches["update"], max_abs_err=max(c["max_abs_err"] for c in cases),
             ms=mean(cases, "ms"), plain_ms=mean(cases, "plain_ms"), bound_ms=mean(cases, "bound_ms"),
             bound_by="bytes", library_ms=mean(cases, "library_ms"),
             launches_phase_d=sampled["update_launches"],
             launches_phase_e=stored["update_launches"],
             launches_phase_f=fast["update_launches"],
             launches_phase_g=durable["update_launches"],
             launches_phase_h=archived["update_launches"],
             launches_phase_i=0,
             launches_phase_j=observed["update_launches"],
             launches_phase_k=served_k["update_launches"],
             launches_phase_l=admitted["update_launches"],
             launches_phase_m=0,
             launches_phase_n=wired["update_launches"],
             cases=cases, card=card),
        dict(name="hll_update_step", route="cuda", source=source, replaces=replaces,
             launches=launches["update_step"], max_abs_err=max(c["max_abs_err"] for c in step_cases),
             ms=mean(step_cases, "ms"), plain_ms=mean(step_cases, "plain_ms"),
             bound_ms=mean(step_cases, "bound_ms"), bound_by="bytes",
             library_ms=mean(step_cases, "library_ms"),
             four_launch_ms=mean(step_cases, "four_launch_ms"),
             launches_phase_d=sum(sampled["launches"]), launches_phase_e=stored["launches"],
             launches_phase_f=fast["launches"],
             launches_phase_g=durable["launches"],
             launches_phase_h=archived["launches"],
             launches_phase_i=fanned["launches"],
             launches_phase_i_parts={"i1": fanned["i1"]["launches"], "i2": fanned["i2"]["launches"],
                                     "i2_blocking": fanned["i2_blocking"]["launches"],
                                     "i3": fanned["i3"]["launches"],
                                     "i3_replay": fanned["i3"]["replay_launches"],
                                     "i4": fanned["i4"]["launches"], "i5": fanned["i5"]["launches"]},
             launches_phase_j=observed["launches"],
             launches_phase_j_parts={k: observed[k]["launches"] for k in ("j1", "j2", "j3", "j5")},
             event_ms_phase_j1=observed["j1"]["kernel_event_ms"],
             launches_phase_k=served_k["launches"],
             launches_phase_k_parts={k: served_k[k]["launches"] for k in ("k1", "k2", "k3")},
             launches_phase_l=admitted["launches"],
             launches_phase_l_parts={k: admitted[k]["launches"] for k in ("l0", "l1", "l2", "l4")},
             launches_phase_m=sharded["launches"],
             launches_phase_m_parts={"m1": sharded["m1"]["launches"],
                                     "m1_one_shard": sharded["m1"]["one_launches"],
                                     "m2a": sharded["m2"]["m2a"]["launches"],
                                     "m2b": sharded["m2"]["m2b"]["launches"]},
             max_abs_err_phase_m=sharded["m1"]["max_abs_err"],
             launches_phase_n=wired["launches"],
             launches_phase_n_parts={"n1": wired["n1"]["launches"], "n2": wired["n2"]["launches"]},
             cases=step_cases, card=card),
    ]
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

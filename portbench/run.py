"""One run of one cell of the port's benchmark.

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Sets up the cell's store on the card and its stream from the seed, warms
every shape the cell uses, measures for ``--seconds``, then judges what the
window produced against the plain reference and prints one JSON line last
on standard output (with ``--trace 1`` the per-layer metrics of a traced
block of the window). The cell and its configuration are found by name in
``BENCHMARK.json`` at the root; its traffic mix is
``portbench/traffic/<traffic>.json``, which names its feed entry
(``portbench/feeds/``) and its read kinds (``portbench/reads/``); each
per-layer metric is ``portbench/metrics/<metric>.py``.

``--control`` runs the cell and then puts the reference in the port's
place, one batch behind what each answer must see (a store that breaks
read-after-write) and with its digests kept in bfloat16 (the precision
below the stated one); its ``correct`` must come out false.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import os  # noqa: E402

if __name__ == "__main__":
    # one thread for the math libraries' pools, set before they load: the
    # harness's feed and Lens threads and the store's host work share the
    # host's cores, and a pool of one thread per core on top of them made
    # the reads' times swing from run to run
    for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[_var] = "1"

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from contextlib import nullcontext  # noqa: E402

import numpy as np  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "zipkin_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def load_cell(root: Path, name: str):
    """(bench, cell, configuration, traffic mix) of the cell ``name``, each
    found by name from ``root``'s ``BENCHMARK.json``: the configuration at
    its entry's ``file``, the mix at ``portbench/traffic/<traffic>.json``."""
    bench = load_json(root / "BENCHMARK.json")
    cell = find_cell(bench, name)
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])
    return (bench, cell, load_json(root / config["file"]),
            load_json(root / HERE.name / "traffic" / f"{cell['traffic']}.json"))


def metric_reader(name: str):
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}",
                                                  HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, cell: str, trace: bool) -> list:
    """The cell's end-to-end metrics, or with ``trace`` its per-layer ones
    (those that list it, or list none and move one of its metrics)."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in names else [])]


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def quantile(values, q: float) -> float:
    return float(np.percentile(np.asarray(values, np.float64), q))


def run_cell(cell: dict, config: dict, mix: dict, seed: int, seconds: float, trace: bool,
             device, metrics: list, control: bool = False,
             t_process: float = T_PROCESS) -> dict:
    """One run of ``cell``: set-up, the window, the final answers, the
    reference and the comparison. Returns the result line's object."""
    import torch

    from portbench import compare, drive, roofline
    from portbench.generator import Pool
    from portbench.reference import digest
    from portbench.reference.model import Reference
    from portbench.trace import Trace

    torch.set_num_threads(1)
    cuda = torch.device(device).type == "cuda"
    store = drive.build_store(config, device)
    folds = drive.FoldLog(store.agg)
    pool = Pool(mix, seed)
    entry = drive.feed_entry(mix, store, pool)
    maps = compare.Maps(entry.svc_map, entry.key_map, store.agg.config.max_services)
    feed = drive.Feed(entry, int(mix["in_flight"]), cuda)
    lens = int(mix["reads"]["clients"]) > 0
    readers = None
    if lens:
        total_reads = drive.read_schedule(mix, seconds)
        rng = np.random.default_rng([int(seed) & ((1 << 64) - 1), 2])
        sample = set(rng.choice(total_reads, min(int(mix["reads"]["checked"]), total_reads),
                                replace=False).tolist())
        readers = drive.Readers(store, feed, pool, mix, sample)

    # set-up: every step variant captured at the batch's lanes, the stream
    # warmed through the step, every read kind run once
    store.capture_steps([pool.batch_spans])
    g = 0
    for _ in range(int(mix["warmup_batches"])):
        feed.ingest(g)
        g += 1
    if lens:
        for kind in readers.kinds:
            readers.read(kind, feed.done)
    store.agg.block_until_ready()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    feed.call_s.clear()
    feed.spans.clear()
    tracer = Trace() if trace and cuda else None
    if tracer is not None:
        tracer.warm()
    # what set-up built is long-lived: out of the collector's way
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_process

    # the window
    plan = mix["trace"]
    traced = {}

    if tracer is not None and readers is not None:
        readers.gate = drive.Gate()
    quiet = readers.gate.exclusive if readers is not None and readers.gate else nullcontext

    def hook(now):
        if tracer is None:
            return
        if "g_a" not in traced and now >= t0 + float(plan["start_s"]):
            traced["g_a"] = feed.started
            with quiet():
                tracer.start()
        elif "g_b" not in traced and "g_a" in traced \
                and feed.started >= traced["g_a"] + int(plan["batches"]):
            with quiet():
                tracer.stop()
            traced["g_b"] = feed.started

    g_window = g
    t0 = time.perf_counter()
    if readers is not None:
        readers.start(t0, seconds)
    g = feed.run(g, t0, seconds, rate=mix.get("feed_batches_per_s"), hook=hook)
    if readers is not None:
        readers.join(timeout=seconds + 120.0)
    store.agg.block_until_ready()
    t_end = time.perf_counter()
    if tracer is not None and "g_a" in traced and "g_b" not in traced:
        tracer.stop()  # the clients have joined
        traced["g_b"] = feed.started
    n = g
    batches = n - g_window
    window_s = t_end - t0
    peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0

    cfg = store.agg.config
    windows = drive.final_windows(pool, mix, cfg, n)
    tt_range = windows["tt_range"]
    raw = None if control else drive.final_answers(store, windows, mix)
    ring_bytes = roofline.ring_lane_bytes(store.agg.states[0])
    host_spans = feed.spans + (readers.spans if readers is not None else [])
    summary = None
    if tracer is not None and "g_a" in traced:
        summary = tracer.summarize(host_spans)
    kinds = readers.kinds if readers is not None else {}
    kept_reads = dict(readers.kept) if readers is not None else {}
    read_lat = readers.latency_s if readers is not None else {}
    read_service = readers.service_s if readers is not None else {}
    reads_attempted = readers.attempted if readers is not None else 0
    reads_failed = readers.failed if readers is not None else 0
    read_errors = readers.errors[:5] if readers is not None else []
    run_ctx = {"ingest_call_s": list(feed.call_s), "feed_max_late_s": feed.max_late_s,
               "feed_end_late_s": feed.end_late_s,
               "inflight_wait_s": sum(b - a for label, a, b in feed.spans
                                      if label.startswith("wait")),
               "card": roofline.power_limit() if cuda else None}
    del store, entry, feed, readers
    gc.unfreeze()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # the reference, once the program's state is freed
    t_ref = time.perf_counter()
    agg = config["agg_config"]
    ref = Reference(pool, agg)
    snaps_wanted = set()
    for kind, n0, n1, _, _ in kept_reads.values():
        if kinds[kind].NEEDS_REGS:
            snaps_wanted.update(range(n0 - 1 if control else n0, n1 + 1))
    if control:
        snaps_wanted.add(n - 1)
    g_trace = range(max(0, traced.get("g_a", 0) - int(mix["in_flight"])), traced.get("g_b", 0))
    regs, snaps, traffic = ref.replay(n, snaps_wanted, g_trace)
    nm = compare.Names(ref.S, ref.names)
    lanes = digest.Lanes(pool, ref.lane_key, torch.device(device))
    shape = (ref.K, int(agg["digest_centroids"]))
    buffer = int(agg["digest_buffer"])
    ref_digest = digest.replay(lanes, *shape,
                               digest.fold_groups(n, pool.batch_spans, buffer, folds.counts))
    ref_values = digest.quantiles(ref_digest, compare.QS).T.cpu().numpy()
    if control:
        m = n - 1
        low = digest.replay(lanes, *shape, digest.fold_groups(
            m, pool.batch_spans, buffer, [c for c in folds.counts if c <= m]), lower=True)
        port = compare.control_final(ref, m, snaps[m], windows, tt_range,
                                     digest.quantiles(low, compare.QS).T.cpu().numpy())
    else:
        port = compare.port_final(raw, maps, ref, nm)
    want = compare.expected_final(ref, n, regs, windows, tt_range)
    gaps = compare.final_gaps(port, want)
    dvalues = np.vstack([port["digest_values"], ref_values])
    below, upto = digest.rank_ranges(lanes, n, torch.as_tensor(dvalues, dtype=torch.float32,
                                                               device=torch.device(device)))
    gaps["digest_rank_gap"], ranks = compare.digest_gaps(
        dvalues, below.cpu().numpy(), upto.cpu().numpy(), want["key_total"],
        int(config["min_points"]))
    if lens:
        reads = []
        for kind, n0, n1, end_ts, ans in kept_reads.values():
            mod = kinds[kind]
            if control:
                reads.append((kind, n0, n0, end_ts,
                              mod.want(ref, n0 - 1, end_ts, mix["reads"], snaps.get(n0 - 1))))
            else:
                reads.append((kind, n0, n1, end_ts, mod.answer(ans, nm)))
        gaps.update(compare.read_gaps(reads, kinds, ref, mix, snaps))
    reference_s = time.perf_counter() - t_ref
    limits = config["limits"]
    checks = {k: {"value": v, "limit": limits[k]} for k, v in gaps.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values()) and reads_failed == 0 \
        and (not lens or len(kept_reads) > 0)

    all_reads = [x for v in read_lat.values() for x in v]
    values = {
        "ingest_spans_per_s": batches * pool.batch_spans / window_s,
        "setup_s": setup_s,
    }
    if all_reads:
        values["read_p99_ms"] = quantile(all_reads, 99) * 1e3
        values["read_p50_ms"] = quantile(all_reads, 50) * 1e3
    ctx = {
        "trace": summary,
        "read_service_s": read_service,
        "hll_traffic": [traffic[k] for k in sorted(traffic)],
        "batch_spans": pool.batch_spans,
        "ring_capacity": cfg.ring_capacity,
        "ring_lane_bytes": ring_bytes,
        "timetier": cfg.timetier_enabled,
    }
    ctx.update(run_ctx)
    out_metrics = {}
    for m in metrics:
        if trace:
            v = metric_reader(m["name"])(ctx)
        else:
            v = values.get(m["name"])
        if v is not None:
            out_metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    result = {
        "correct": bool(correct),
        "attempted": batches + reads_attempted,
        "failed": reads_failed,
        "metrics": out_metrics,
        "device": {"platform": "gpu" if cuda else str(device),
                   "kind": torch.cuda.get_device_name(device) if cuda else str(device),
                   "count": 1, "memory_peak_bytes": peak},
    }
    if summary is not None:
        result["device"]["busy_s"] = summary["busy_s"]
        result["device"]["window_s"] = summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["run"] = {"batches": batches, "window_s": window_s, "batches_total": n,
                     "reads": len(all_reads), "reads_checked": len(kept_reads),
                     "read_ms_by_kind": {k: [quantile(v, 50) * 1e3, quantile(v, 99) * 1e3,
                                             quantile(read_service[k], 50) * 1e3]
                                         for k, v in read_lat.items() if v},
                     "read_errors": read_errors, "read_folds": len(folds.counts),
                     "ingest_call_ms_p50": quantile(run_ctx["ingest_call_s"], 50) * 1e3,
                     "inflight_wait_s": run_ctx["inflight_wait_s"],
                     "feed_max_late_s": run_ctx["feed_max_late_s"],
                     "feed_end_late_s": run_ctx["feed_end_late_s"],
                     "traced_batches": traced, "card": run_ctx.get("card"),
                     "digest_rank": ranks, "reference_s": reference_s}
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", action="store_true",
                   help="put the reference, one batch behind and its digests in bfloat16, "
                        "in the port's place")
    args = p.parse_args(argv)

    bench, cell, config, mix = load_cell(ROOT, args.workload)
    # kernel caches at fixed paths inside the checkout
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / ".portbench_cache" / "triton")
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"portbench: the cell needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 2
    result = run_cell(cell, config, mix, args.seed, args.seconds, bool(args.trace), "cuda:0",
                      cell_metrics(bench, cell["name"], bool(args.trace)),
                      control=args.control)
    bad = loaded_forbidden()
    if bad:
        print(f"portbench: the process loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    print(json.dumps({k: v for k, v in result.items() if k != "checks"}, sort_keys=False),
          file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Drives the port through its own API: builds the configuration's store,
feeds the stream through the mix's feed entry (``portbench/feeds/``), runs
the Lens clients with the mix's read kinds (``portbench/reads/``), logs
the store's read-time digest folds, and reads the answers that the
comparison judges.

Only this module, the feed entries, the read kinds and
:mod:`portbench.run` reach the program (``zipkin_tpu_torch``); the
reference and the comparison never do.
"""

from __future__ import annotations

import importlib
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Dict, List, Optional

import numpy as np

from portbench.generator import Pool

QS = (0.5, 0.99)
# the store options the harness can build, each with the values it can give
STORE_OPTIONS = {"read_mirror": (False, True), "deps_max_stale_ms": None,
                 "wal": (False,), "archive": (False,)}


def build_store(config: dict, device):
    """The configuration's store: one resume-adapter ``TorchStorage`` (the
    storage the server mounts) on ``device``. Refuses a store option, or a
    value of one, that it cannot build (a WAL, an archive, the sampling
    tier) rather than run a store that gives less than the configuration
    states."""
    opts = config["store"]
    for key, value in opts.items():
        if key not in STORE_OPTIONS:
            raise ValueError(f"store option {key!r} is not one the harness builds")
        allowed = STORE_OPTIONS[key]
        if allowed is not None and value not in allowed:
            raise ValueError(f"store option {key}={value!r} is not one the harness builds")
    if config["agg_config"].get("sampling"):
        raise ValueError("the harness does not arm the sampling tier")
    # the read mirror is read from the environment when the store is built
    os.environ["TPU_READ_MIRROR"] = "1" if opts.get("read_mirror") else "0"
    from zipkin_tpu_torch.storage.tpu import TorchStorage
    from zipkin_tpu_torch.tpu.state import AggConfig

    return TorchStorage(config=AggConfig(**config["agg_config"]), device=device,
                        deps_max_stale_ms=float(opts["deps_max_stale_ms"]))


def feed_entry(mix: dict, store, pool: Pool):
    """The mix's feed entry (``portbench/feeds/<feed>.py``) on ``store``."""
    return importlib.import_module(f"portbench.feeds.{mix['feed']}").Entry(store, pool)


def read_kinds(mix: dict) -> Dict[str, object]:
    """The mix's read kinds by name (``portbench/reads/<kind>.py``)."""
    return {k: importlib.import_module(f"portbench.reads.{k}") for k in mix["reads"]["kinds"]}


def read_cycle(mix: dict) -> List[str]:
    """The kinds in the order a client takes them: each kind as many times
    as its share, interleaved."""
    shares = {k: int(v) for k, v in mix["reads"]["kinds"].items()}
    cycle = []
    for r in range(max(shares.values(), default=0)):
        cycle += [k for k, v in shares.items() if v > r]
    return cycle


class FoldLog:
    """The batch counts at which a read folded the store's pending digest
    points (the store's flush-then-read, under its lock): the reference's
    digests fold at the same counts."""

    def __init__(self, agg):
        self.counts: List[int] = []
        inner = agg._flush_now

        def logged():
            self.counts.append(int(agg.host_counters["batches"]))
            inner()

        agg._flush_now = logged


class Feed:
    """The feed entry back to back or on a schedule, with at most
    ``in_flight`` batches queued on the card: before batch k it waits on
    the CUDA event recorded after batch k - in_flight."""

    def __init__(self, entry, in_flight: int, cuda: bool):
        self.entry = entry
        self.in_flight = in_flight
        self.cuda = cuda
        self.started = 0  # batches whose ingest call began
        self.done = 0  # batches whose ingest call returned
        self._events: deque = deque()
        self.call_s: List[float] = []  # host seconds of each ingest call
        self.spans: List[tuple] = []  # (label, t0, t1) host spans, perf_counter s
        self.max_late_s = 0.0
        self.end_late_s = 0.0  # how late the open loop's last batch was issued

    def ingest(self, g: int) -> None:
        inputs = self.entry.inputs(g)
        if self.cuda and len(self._events) >= self.in_flight:
            t0 = time.perf_counter()
            self._events.popleft().synchronize()
            self.spans.append(("wait for the card (in-flight bound)", t0, time.perf_counter()))
        self.started = g + 1
        t0 = time.perf_counter()
        self.entry(inputs)
        t1 = time.perf_counter()
        self.done = g + 1
        self.call_s.append(t1 - t0)
        self.spans.append(("feed call (host)", t0, t1))
        if self.cuda:
            import torch

            ev = torch.cuda.Event()
            ev.record()
            self._events.append(ev)

    def run(self, g0: int, t_start: float, seconds: float, rate: Optional[float] = None,
            hook=None) -> int:
        """Feed from batch ``g0`` until ``seconds`` after ``t_start``:
        closed loop, or open loop at ``rate`` batches a second (batch k due
        at ``t_start + k / rate``). ``hook(now)`` runs between batches.
        Returns the next batch index."""
        g = g0
        end = t_start + seconds
        k = 0
        while True:
            now = time.perf_counter()
            if rate is not None:
                due = t_start + k / rate
                if due >= end:
                    break
                if due > now:
                    time.sleep(due - now)
                    self.spans.append(("feed idle (open loop)", now, due))
                else:
                    self.max_late_s = max(self.max_late_s, now - due)
                self.end_late_s = max(0.0, now - due)
            elif now >= end:
                break
            if hook is not None:
                hook(time.perf_counter())
            self.ingest(g)
            g += 1
            k += 1
        return g


class Gate:
    """Lets the Lens clients' reads run together, and the tracer start or
    stop the profiler with none of them in flight: the profiler's switch
    on or off while another thread runs torch operations can crash the
    process."""

    def __init__(self):
        self._cond = threading.Condition()
        self._reads = 0
        self._closed = False

    @contextmanager
    def reading(self):
        with self._cond:
            while self._closed:
                self._cond.wait()
            self._reads += 1
        try:
            yield
        finally:
            with self._cond:
                self._reads -= 1
                self._cond.notify_all()

    @contextmanager
    def exclusive(self):
        with self._cond:
            self._closed = True
            while self._reads:
                self._cond.wait()
        try:
            yield
        finally:
            with self._cond:
                self._closed = False
                self._cond.notify_all()


class Readers:
    """``clients`` Lens clients, open loop, each ``rate`` reads a second,
    the mix's kinds in turn by their shares; every read is timed from when
    it was due. A sample of reads (``sample``: their indices) keeps its
    answer and the batch counts around it for the comparison."""

    def __init__(self, store, feed: Feed, pool: Pool, mix: dict, sample: set):
        r = mix["reads"]
        self.store = store
        self.feed = feed
        self.reads = r
        self.kinds = read_kinds(mix)
        self.cycle = read_cycle(mix)
        self.clients = int(r["clients"])
        self.rate = float(r["per_client_per_s"])
        self.pool = pool
        self.sample = sample
        self.latency_s: Dict[str, List[float]] = {k: [] for k in self.kinds}
        self.service_s: Dict[str, List[float]] = {k: [] for k in self.kinds}
        self.kept: Dict[int, tuple] = {}
        self.failed = 0
        self.attempted = 0
        self.spans: List[tuple] = []
        self._lock = threading.Lock()
        self._threads: List[threading.Thread] = []
        self.errors: List[str] = []
        self.gate: Optional[Gate] = None  # set while a trace may switch on or off

    def end_ts(self, n: int) -> int:
        """The read's endTs: the end of the newest minute folded (n batches)."""
        return (self.pool.minute(max(n, 1) - 1) + 1) * 60_000 - 1

    def read(self, kind: str, n0: int):
        return self.kinds[kind].issue(self.store, self.end_ts(n0), self.reads)

    def _client(self, c: int, t_start: float, seconds: float) -> None:
        j = 0
        end = t_start + seconds
        stagger = c / (self.clients * self.rate)
        while True:
            due = t_start + stagger + j / self.rate
            if due >= end:
                return
            now = time.perf_counter()
            if due > now:
                time.sleep(due - now)
            kind = self.cycle[(c + j) % len(self.cycle)]
            idx = j * self.clients + c
            n0 = self.feed.done
            t0 = time.perf_counter()
            try:
                if self.gate is None:
                    ans = self.read(kind, n0)
                else:
                    with self.gate.reading():
                        ans = self.read(kind, n0)
            except Exception as e:  # a failed read counts against the run
                with self._lock:
                    self.failed += 1
                    self.errors.append(f"{kind}: {type(e).__name__}: {e}")
                ans = None
            t1 = time.perf_counter()
            n1 = self.feed.started
            with self._lock:
                self.attempted += 1
                self.latency_s[kind].append(t1 - due)
                self.service_s[kind].append(t1 - t0)
                self.spans.append((f"read {kind} (host)", t0, t1))
                if idx in self.sample and ans is not None:
                    self.kept[idx] = (kind, n0, n1, self.end_ts(n0), ans)
            j += 1

    def start(self, t_start: float, seconds: float) -> None:
        for c in range(self.clients):
            th = threading.Thread(target=self._client, args=(c, t_start, seconds),
                                  name=f"lens-{c}", daemon=True)
            th.start()
            self._threads.append(th)

    def join(self, timeout: float) -> None:
        for th in self._threads:
            th.join(timeout)
        if any(th.is_alive() for th in self._threads):
            raise RuntimeError("a Lens client did not finish")


def read_schedule(mix: dict, seconds: float) -> int:
    """How many reads the clients' schedule issues in the window."""
    r = mix["reads"]
    clients, rate = int(r["clients"]), float(r["per_client_per_s"])
    n = 0
    for c in range(clients):
        stagger = c / (clients * rate)
        n += max(0, int(np.ceil((seconds - stagger) * rate)))
    return n


def final_windows(pool: Pool, mix: dict, cfg, n: int) -> dict:
    """The final reads' windows after ``n`` batches: ``end_ts`` (the end of
    the newest minute), the dashboard's ``window`` and the day's
    ``deps_window`` in minutes, and the time tier's live ``tt_range`` of
    bucket epochs (None with the tier off)."""
    minute = pool.minute(n - 1)
    end_ts = (minute + 1) * 60_000 - 1
    r = mix["reads"]
    hi_ep = minute // cfg.time_bucket_minutes
    return {"end_ts": end_ts,
            "window": (minute - int(r["window_minutes"]), minute),
            "deps_window": ((end_ts - int(r["deps_lookback_ms"])) // 60_000, minute),
            "tt_range": (hi_ep - cfg.time_buckets + 1, hi_ep) if cfg.timetier_enabled else None}


def final_answers(store, windows: dict, mix: dict) -> dict:
    """Every answer the comparison reads once the window has closed and
    the card has caught up: the merged sketches and counters, the digests'
    weights, the digest quantile rows, the dashboard window's quantile rows
    and histograms, the cardinalities, the day's dependency links, the time
    tier's live buckets."""
    agg = store.agg
    end_ts = windows["end_ts"]
    hist, hll, counters = agg.merged_sketches()
    digest = agg.merged_digest()
    out = {
        "digest_weight": digest[..., 1].astype(np.float64).sum(axis=1),
        "hist": hist, "hll": hll, "counters": counters.astype(np.int64),
        "host_counters": dict(agg.host_counters),
        "rows": store.latency_quantiles(list(QS)),
        "window_rows": store.latency_quantiles(
            list(QS), end_ts=end_ts, lookback=int(mix["reads"]["window_minutes"]) * 60_000),
        "cards": store.trace_cardinalities(),
        "deps": store.get_dependencies(end_ts, int(mix["reads"]["deps_lookback_ms"])).execute(),
        "window_hist": agg.windowed_histograms(*windows["window"]),
    }
    if windows["tt_range"] is not None:
        _, regs, tt_digest, calls, errs = agg.tt_read(*windows["tt_range"])
        out["tt"] = (regs, tt_digest[..., 1].astype(np.float64).sum(axis=1), calls, errs)
    return out

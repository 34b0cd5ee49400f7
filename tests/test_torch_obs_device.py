"""The port's device observatory (``zipkin_tpu_torch/obs/device.py``):
the wrapper counts calls and host walls, resolves no CUDA events off the
card and answers ``hbm {}`` on the CPU, merges builds of one name, counts a
kernel build as a compile, and sees the store's programs under the
reference's names (tests/test_obs_device.py's specs on the port)."""

from __future__ import annotations

import numpy as np
import pytest

import tests.torch_cpu  # noqa: F401  (one intra-op thread a test process)
from zipkin_tpu_torch import readpack
from zipkin_tpu_torch.obs import device as obs_device
from zipkin_tpu_torch.obs.device import DeviceObservatory, OBSERVATORY, hbm_stats
from zipkin_tpu_torch.tpu.state import AggConfig
from zipkin_tpu_torch.tpu.store import TorchStorage

SMALL = AggConfig(max_services=32, max_keys=128, hll_precision=8, digest_centroids=16,
                  digest_buffer=1 << 12, ring_capacity=1 << 12)


def test_wrapper_counts_calls_and_resolves_no_events_on_the_cpu():
    import torch

    obs = DeviceObservatory()
    seen = []
    fn = obs.wrap("spmd_test", lambda t, k=1: seen.append(k) or t * k, device=torch.device("cpu"))
    out = [fn(torch.ones(4), k=k) for k in range(5)]
    assert seen == list(range(5)) and float(out[3].sum()) == 12.0
    prog = obs.programs()["spmd_test"]
    assert prog["calls"] == 5 and prog["builds"] == 1
    assert prog["compiles"] == prog["recompiles"] == 0
    assert prog["callWallMs"] >= prog["maxCallMs"] >= 0.0
    # no CUDA device: no event pair was recorded, none resolved
    assert prog["deviceCalls"] == prog["eventsPending"] == prog["eventsDropped"] == 0
    assert prog["deviceMs"] == 0.0
    assert "cost" not in prog and "memory" not in prog
    assert obs.totals() == {"programs": 1, "calls": 5, "compiles": 0, "recompiles": 0}
    # the first argument's device decides when none is given
    bare = obs.wrap("spmd_bare", lambda t: t + 1)
    bare(torch.zeros(2))
    assert obs.programs()["spmd_bare"]["eventsPending"] == 0


def test_hbm_is_empty_on_the_cpu_and_status_has_the_reference_keys():
    assert hbm_stats() == {}
    status = OBSERVATORY.status()
    assert set(status) == {"enabled", "analysis", "totals", "programs", "hbm", "transfers"}
    assert status["hbm"] == {}
    assert status["transfers"] == {"count": readpack.transfer_count(),
                                   "bytes": readpack.transfer_bytes()}
    assert set(status["totals"]) == {"programs", "calls", "compiles", "recompiles"}


def test_disabled_observatory_is_transparent_and_builds_merge():
    obs = DeviceObservatory(enabled=False)
    a = obs.wrap("spmd_x", lambda v: v + 1)
    b = obs.wrap("spmd_x", lambda v: v + 2)
    assert a(1) == 2 and b(1) == 3 and a.__wrapped__(1) == 2
    assert obs.programs()["spmd_x"]["calls"] == 0
    obs.set_enabled(True)
    a(1), b(1), b(1)
    merged = obs.programs()["spmd_x"]
    assert merged["builds"] == 2 and merged["calls"] == 3
    obs.reset_counters()
    assert obs.programs()["spmd_x"]["calls"] == 0 and obs.programs()["spmd_x"]["builds"] == 2


def test_a_build_during_a_call_is_a_compile():
    builds = [0]

    def launch(first):
        if first:
            builds[0] += 1  # the first use ran nvcc
        return first

    obs = DeviceObservatory()
    fn = obs.wrap("hll_test", launch, compile_probe=lambda: builds[0])
    fn(True), fn(False), fn(False)
    prog = obs.programs()["hll_test"]
    assert (prog["calls"], prog["compiles"], prog["recompiles"]) == (3, 1, 0)
    assert prog["compileWallMs"] <= prog["callWallMs"]


def test_event_queue_drops_and_resolves_consistently_across_threads(monkeypatch):
    """A full queue's drop (the caller's thread) and the peek-then-pop of
    ``resolve`` (statusz's threads) never fold one pair and discard
    another: the pairs ``resolve`` takes off the queue are exactly the
    pairs it folds, and every call's pair is folded or counted dropped."""
    import threading
    import time
    from collections import deque

    import torch

    folded, taken = [], []

    class FakeEvent:
        def __init__(self, enable_timing=False):
            self.t = 0.0

        def record(self, stream=None):
            self.t = time.perf_counter()

        def query(self):
            time.sleep(0)  # yield between the peek and the pop
            return True

        def elapsed_time(self, end):
            folded.append(id(self))
            return (end.t - self.t) * 1e3 + 1e-3

    class Queue(deque):
        def popleft(self):
            item = super().popleft()
            if threading.current_thread() is not threading.main_thread():
                taken.append(id(item[0]))
            return item

    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: "stream")
    monkeypatch.setattr(obs_device, "_cuda_device", lambda device, args: "cuda")
    monkeypatch.setattr(obs_device, "deque", Queue)
    monkeypatch.setattr(obs_device, "EVENT_QUEUE", 8)
    obs = DeviceObservatory()
    fn = obs.wrap("spmd_race", lambda v: v)
    stop = threading.Event()

    def reader():
        while not stop.is_set():
            obs.programs()

    threads = [threading.Thread(target=reader) for _ in range(2)]
    for t in threads:
        t.start()
    try:
        for i in range(3000):
            fn(i)
    finally:
        stop.set()
        for t in threads:
            t.join()
    threads = [threading.Thread(target=obs.programs)]  # the last pairs, off the main thread
    threads[0].start()
    threads[0].join()
    prog = obs.programs()["spmd_race"]
    assert prog["calls"] == 3000 and prog["eventsPending"] == 0
    assert sorted(folded) == sorted(taken)
    assert prog["deviceCalls"] == len(folded)
    assert prog["deviceCalls"] + prog["eventsDropped"] == prog["calls"]
    assert prog["eventsDropped"] > 0 and prog["minDeviceMs"] > 0.0


def _store_with_planes():
    store = TorchStorage(config=SMALL, device="cpu")
    store.set_query_observatory(True)
    return store, [store, store.agg]


def _store_with_accuracy():
    from zipkin_tpu_torch.obs.accuracy import AccuracyEstimator
    from zipkin_tpu_torch.obs.shadow import HostShadow

    store = TorchStorage(config=SMALL, device="cpu")
    store.shadow = HostShadow(max_services=SMALL.max_services,
                              svc_resolver=store.vocab.services.get)
    store.accuracy = AccuracyEstimator(store, store.shadow, rollup_s=0.0)
    return store, [store, store.agg]


def _cleared_store():
    store = TorchStorage(config=SMALL, device="cpu")
    old = store.agg
    store.clear()
    return store, [old]


def _store_with_published_mirror_and_segment():
    from zipkin_tpu_torch.serving.segment import MirrorSegment

    store = TorchStorage(config=SMALL, device="cpu")
    store.latency_quantiles([0.5, 0.99])  # a miss registers a key of its own
    segment = MirrorSegment(readers=1, capacity=1 << 20)
    store.attach_mirror_segment(segment)
    assert store.publish_mirror(force=True) and store._segment_publisher.publishes == 1
    store.mirror.segment_sink = None
    segment.close()
    return store, [store, store.agg]


def _store_with_overload_controller():
    """The server's admission wiring: the controller (with a tenant table)
    on the store and its read modes exercised by a browned-out read."""
    from zipkin_tpu_torch.runtime.overload import OverloadController
    from zipkin_tpu_torch.runtime.tenant import TenantAdmission

    store = TorchStorage(config=SMALL, device="cpu")
    ctl = OverloadController(seed=1, ema_alpha=1.0, hbm_stats=dict,
                             rate_controller=store.sampling_controller)
    ctl.tenant_admission = TenantAdmission(bytes_per_s=100.0)
    store.overload = ctl
    ctl.evaluate({"critpathQueueSaturation": 0.9})  # B3: cache-only reads
    store.latency_quantiles([0.5, 0.99])
    return store, [store, store.agg]


@pytest.mark.parametrize("make", [_store_with_planes, _store_with_accuracy, _cleared_store,
                                  _store_with_published_mirror_and_segment,
                                  _store_with_overload_controller],
                         ids=["query_plane", "accuracy", "clear", "mirror_segment", "overload"])
def test_a_dropped_store_frees_its_state_without_the_cycle_collector(make):
    """The wrapped programs, the query plane's lock provider, the accuracy
    estimator and the read mirror (its demand closures and segment sink)
    hold no strong cycle through the store or its aggregator, so dropping
    them frees the device state at once."""
    import gc
    import weakref

    gc.collect()
    gc.disable()
    try:
        store, watched = make()
        refs = [weakref.ref(o) for o in watched]
        del store, watched
        assert [r() is None for r in refs] == [True] * len(refs)
    finally:
        gc.enable()


@pytest.mark.parametrize("planes", ["default", "every_plane"])
def test_a_stopped_dropped_server_frees_its_store_without_the_cycle_collector(planes, tmp_path):
    """A ZipkinServer that ran (a POST, the aggregate reads, statusz, a few
    ticks) and stopped holds no cycle through itself or its store: dropping
    it frees the aggregator at once."""
    import gc
    import json
    import time
    import urllib.request
    import weakref

    from zipkin_tpu_torch.model import json_v2
    from zipkin_tpu_torch.model.span import Endpoint, Span
    from zipkin_tpu_torch.server.app import ZipkinServer
    from zipkin_tpu_torch.server.config import ServerConfig
    from zipkin_tpu_torch.storage.tpu import TorchStorage as Adapter

    extra, adapter = {}, {}
    if planes == "every_plane":
        extra = dict(obs_selfspans_enabled=True, self_tracing_enabled=True,
                     obs_incident_dir=str(tmp_path / "incidents"))
        adapter = dict(mirror_segment_bytes=1 << 20)
    gc.collect()
    gc.disable()
    try:
        store = Adapter(config=SMALL, device="cpu", batch_size=256, **adapter)
        server = ZipkinServer(ServerConfig(host="127.0.0.1", port=0, storage_type="tpu",
                                           obs_windows_tick_s=0.05, **extra),
                              storage=store).start()
        base = f"http://127.0.0.1:{server.port}"
        spans = [Span.create(trace_id=f"{t + 1:016x}", id=f"{t + 1:016x}", name="op",
                             timestamp=1_700_000_000_000_000 + t, duration=100,
                             local_endpoint=Endpoint.create("svc"))
                 for t in range(50)]
        req = urllib.request.Request(base + "/api/v2/spans", data=json_v2.encode_span_list(spans),
                                     headers={"Content-Type": "application/json"}, method="POST")
        assert urllib.request.urlopen(req, timeout=60).status == 202
        for path in ("/api/v2/tpu/percentiles", "/api/v2/tpu/cardinalities",
                     "/api/v2/tpu/statusz", "/prometheus"):
            assert urllib.request.urlopen(base + path, timeout=60).status == 200
        deadline = time.monotonic() + 30
        while server._obs_windows.ticks < 3 and time.monotonic() < deadline:
            time.sleep(0.02)
        status = json.loads(urllib.request.urlopen(base + "/api/v2/tpu/statusz", timeout=60).read())
        if planes == "every_plane":
            assert status["mirror"]["mirrorPublishes"] >= 1 and "serving" in status
        server.stop()
        refs = [weakref.ref(o) for o in (server, store, store.agg)]
        del server, store, req, status
        assert [r() is None for r in refs] == [True] * len(refs)
    finally:
        gc.enable()


def test_store_programs_report_under_the_reference_names():
    before = OBSERVATORY.programs()
    store = TorchStorage(config=SMALL, device="cpu", pad_to_multiple=256)
    rng = np.random.default_rng(3)
    from zipkin_tpu_torch.model.span import Endpoint, Kind, Span

    spans = [Span.create(trace_id=f"{int(t) + 1:016x}", id=f"{i + 1:016x}", name="op",
                         kind=Kind.SERVER, timestamp=1_700_000_000_000_000 + i, duration=100 + i,
                         local_endpoint=Endpoint.create(f"svc{i % 3}"))
             for i, t in enumerate(rng.integers(0, 200, 600))]
    store.accept(spans).execute()
    store.latency_quantiles([0.5, 0.99])
    store.trace_cardinalities()
    store.get_dependencies(1_700_000_100_000, 86_400_000).execute()
    after = OBSERVATORY.programs()
    calls = {k: after[k]["calls"] - before.get(k, {}).get("calls", 0) for k in after}
    assert calls["spmd_init"] >= 1
    assert sum(calls[k] for k in calls if k.startswith("spmd_step")) == store.agg.host_counters["batches"]
    assert calls["spmd_quant_digest"] >= 1 and calls["spmd_card"] >= 1
    assert calls["spmd_edges_fresh"] + calls["spmd_edges_rolled"] >= 1
    # the CPU takes the kernel's plain twin: no launch, so no call
    assert calls.get("hll_update_step", 0) == 0
    totals = store.ingest_counters()
    assert totals["deviceProgramCalls"] == OBSERVATORY.totals()["calls"]
    assert totals["deviceRecompiles"] == 0
    store.close()


@pytest.mark.parametrize("name", ["hll_update", "hll_update_step"])
def test_the_kernel_launch_is_wrapped(name):
    """Both entry points of the hand kernel launch through a wrapper of the
    kernel's own name, so statusz counts each launch; the plain twins do
    not go through it."""
    from zipkin_tpu_torch.ops import hll_kernel

    wrapper = {"hll_update": hll_kernel._launch_update_observed,
               "hll_update_step": hll_kernel._launch_step_observed}[name]
    assert wrapper.__name__ == name and wrapper.program_stats in [
        e for e in obs_device.OBSERVATORY._entries() if e.name == name]

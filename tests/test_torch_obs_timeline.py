"""The device observatory's step timeline (``zipkin_tpu_torch/obs/device.py``):
one record per ingest step with its host spans on ``perf_counter_ns``, its
device intervals from three CUDA events mapped onto that clock through
anchors, the card's idle gaps named by the host spans, the ``/statusz``
summary, and the benchmark's readers of it (``portbench/metrics/``).

The CPU has no CUDA event, so the events here are stand-ins on a device
clock the test sets; the clock mapping and the gap arithmetic are pure
functions over synthetic times."""

from __future__ import annotations

import json
import time

import pytest
import torch

import tests.torch_cpu  # noqa: F401  (one intra-op thread a test process)
from portbench import run as bench_run
from tests.test_torch_server import TRACE_BODY, Client, serve
from tests.test_torch_step_graph import CFG
from tests.test_torch_store import small_store
from zipkin_tpu_torch.obs import device as od
from zipkin_tpu_torch.obs.device import (OBSERVATORY, OUTSIDE, SPANS, Span, StepTimeline,
                                         idle_gaps, map_clock, map_step, step_timeline)
from zipkin_tpu_torch.parallel.aggregator import TorchAggregator
from zipkin_tpu_torch.tpu.columnar import route_fused
from zipkin_tpu_torch.workload import generate, slice_columns

CARD = torch.device("cuda", 0)


@pytest.fixture
def observed():
    was = OBSERVATORY.enabled
    OBSERVATORY.set_enabled(True)
    yield
    OBSERVATORY.set_enabled(was)


def _cols(n: int, seed: int):
    return slice_columns(generate(n, seed=seed).cols, 0, n)


# -- the CPU ingest path ----------------------------------------------------


def test_one_record_per_ingest_with_its_spans_nested_in_order(observed):
    agg = TorchAggregator(CFG, device="cpu")
    batches = [_cols(64, s) for s in (1, 2, 3)]
    t_before = time.perf_counter()
    for cols in batches:
        agg.ingest(cols)
    t_after = time.perf_counter()
    recs = step_timeline(3)
    assert [r["batch"] for r in recs] == [1, 2, 3] and agg.host_counters["batches"] == 3
    for r in recs:
        assert r["root"] == "ingest" and not r["profiled"] and r["device"] == []
        root, *children = r["spans"]
        assert [s.name for s in r["spans"]] == list(SPANS)
        assert root.parent is None and {s.parent for s in children} == {"ingest"}
        assert {s.batch for s in r["spans"]} == {r["batch"]}
        # perf_counter_ns stamps: comparable with time.perf_counter()
        assert t_before * 1e9 <= root.start_ns <= root.end_ns <= t_after * 1e9
        for a, b in zip(children, children[1:]):
            assert a.end_ns <= b.start_ns
        assert all(root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns for s in children)
    assert [r["variant"] for r in recs][0] == "plain"


def test_a_fan_out_caller_roots_its_steps_at_ingest_fused(observed):
    agg = TorchAggregator(CFG, device="cpu")
    cols = _cols(64, 4)
    agg.ingest_fused(route_fused(cols, 1), int(cols.valid.sum()), 0, 0, (0, 0))
    (rec,) = step_timeline(1)
    assert rec["root"] == "ingest_fused" and rec["batch"] == 1
    assert [s.name for s in rec["spans"]] == ["ingest_fused", "lock_wait", "upload", "replay"]
    assert {s.parent for s in rec["spans"][1:]} == {"ingest_fused"}


def test_a_contended_lock_wait_is_the_locks_own_stamp(observed):
    import threading

    agg = TorchAggregator(CFG, device="cpu")
    cols = _cols(64, 5)
    held = threading.Event()

    def hold():
        with agg.lock:
            held.set()
            time.sleep(0.05)

    t = threading.Thread(target=hold)
    t.start()
    held.wait(5)
    agg.ingest(cols)
    t.join()
    (rec,) = step_timeline(1)
    wait = next(s for s in rec["spans"] if s.name == "lock_wait")
    assert (wait.start_ns, wait.end_ns) == agg.lock.wait_stamp
    assert wait.end_ns - wait.start_ns >= 20_000_000


def test_the_ring_keeps_its_newest_steps_and_records_nothing_when_off():
    tl = StepTimeline()
    for _ in range(od.TIMELINE_STEPS + 5):
        rec = tl.begin("ingest")
        rec.end()
    recs = tl.records(od.TIMELINE_STEPS + 100)
    assert len(recs) == od.TIMELINE_STEPS == 4096
    assert tl._next == od.TIMELINE_STEPS + 5
    was = OBSERVATORY.enabled
    agg = TorchAggregator(CFG, device="cpu")
    try:
        OBSERVATORY.set_enabled(False)
        before = OBSERVATORY.timeline._next
        assert OBSERVATORY.begin_step("ingest") is None
        agg.ingest(_cols(64, 6))
        assert OBSERVATORY.timeline._next == before
    finally:
        OBSERVATORY.set_enabled(was)


# -- the clock mapping and the gaps, as pure functions -----------------------


def test_two_anchors_with_drift_map_linearly_and_extrapolate():
    # the card's clock runs 10 ppm fast against the host's
    points = [(0.0, 1_000_000), (1.00001e9, 1_001_000_000)]
    assert map_clock(points, 0.0) == 1_000_000
    assert map_clock(points, 1.00001e9) == pytest.approx(1_001_000_000)
    assert map_clock(points, 0.500005e9) == pytest.approx(501_000_000)
    assert map_clock(points, 2.00002e9) == pytest.approx(2_001_000_000)  # past the last
    # one anchor: the card's own rate
    assert map_clock(points[:1], 5_000.0) == 1_005_000
    raw = (0.500005e9, 100_001.0, 2_000_020.0)
    (c, c0, c1), (g, g0, g1) = map_step(raw, points)
    assert (c, g) == ("h2d_copy", "graph") and c1 == g0
    assert c0 == pytest.approx(501_000_000) and c1 - c0 == pytest.approx(100_000, abs=1e-3)
    assert g1 - g0 == pytest.approx(2_000_000, abs=1e-3)
    assert map_step((None, 1.0, 1.0), points) == [] and map_step(raw, []) == []


def _rec(batch, enqueue, copy, graph, spans=(), profiled=False, variant="plain"):
    root = Span("ingest", enqueue - 500, enqueue + 200, None, batch)
    return {"batch": batch, "variant": variant, "root": "ingest", "profiled": profiled,
            "spans": [root] + [Span(n, a, b, "ingest", batch) for n, a, b in spans],
            "enqueue_ns": enqueue,
            "device": [("h2d_copy", copy[0], copy[1]), ("graph", graph[0], graph[1])]}


def test_a_card_that_runs_dry_idles_between_steps_and_names_the_host_span():
    # each step's copy starts as the host enqueues it: the card waits
    recs = [_rec(1, 1_000, (1_000, 1_100), (1_100, 2_000), [("upload", 700, 1_050)]),
            _rec(2, 3_000, (3_000, 3_100), (3_100, 4_000), [("upload", 2_800, 3_050)]),
            _rec(3, 5_500, (5_500, 5_600), (5_600, 6_000), [("route", 4_500, 5_000)])]
    g = idle_gaps(recs)
    assert g["window_s"] == pytest.approx(5_000 / 1e9)
    assert g["busy_s"] == pytest.approx(2_500 / 1e9)
    assert g["idle_share"] == pytest.approx(0.5)
    # the second gap ends inside the second step's upload; the third ends
    # in the third step's root, outside its route
    assert [(a, b, n) for a, b, n in g["gaps"]] == [(2_000, 3_000, "upload"),
                                                    (4_000, 5_500, "ingest")]
    assert g["by_span"] == {"upload": pytest.approx(1e-6), "ingest": pytest.approx(1.5e-6)}
    assert g["max_correction_ns"] == 0.0


def test_a_backlogged_card_has_no_gap_and_a_gap_outside_any_span_says_so():
    recs = [_rec(1, 1_000, (1_000, 1_100), (1_100, 5_000)),
            _rec(2, 1_500, (5_000, 5_100), (5_100, 9_000))]
    g = idle_gaps(recs)
    assert g["gaps"] == [] and g["idle_share"] == 0.0 and g["max_correction_ns"] == 0.0
    recs.append(_rec(3, 20_000, (20_000, 20_100), (20_100, 21_000)))
    recs[-1]["spans"] = [Span("ingest", 19_990, 20_500, None, 3)]
    recs[-1]["device"] = [("h2d_copy", 19_000, 19_100), ("graph", 19_100, 21_000)]
    g = idle_gaps(recs)
    assert g["gaps"] == [(9_000, 19_000, OUTSIDE)]
    # the third copy mapped 1,000 ns before its host enqueue: the correction
    assert g["max_correction_ns"] == 1_000
    assert idle_gaps([dict(r, device=[]) for r in recs]) is None


def test_the_deepest_open_span_wins_and_the_latest_among_equals():
    spans = sorted([Span("ingest", 0, 100, None, 1), Span("route", 10, 40, "ingest", 1),
                    Span("ingest", 30, 200, None, 2), Span("lock_wait", 35, 60, "ingest", 2)],
                   key=lambda s: s.start_ns)
    assert od.deepest_open(spans, 38) == "lock_wait"
    assert od.deepest_open(spans, 20) == "route"
    assert od.deepest_open(spans, 70) == "ingest"
    assert od.deepest_open(spans, 250) == OUTSIDE


# -- the card path on stand-in events ---------------------------------------


class _Card:
    """A device clock and CUDA events that read it when recorded."""

    def __init__(self):
        self.now = 0.0  # ns
        self.done_to = float("inf")
        self.made = 0
        card = self

        class Event:
            def __init__(self, enable_timing=False):
                card.made += 1
                self.t = None

            def record(self, stream=None):
                self.t = card.now

            def query(self):
                return self.t is not None and self.t <= card.done_to

            def elapsed_time(self, other):
                return (other.t - self.t) / 1e6

        self.Event = Event


@pytest.fixture
def card(monkeypatch):
    c = _Card()
    monkeypatch.setattr(torch.cuda, "Event", c.Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None: object())
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    return c


def _step(tl, card, host_ns, copy_ns, graph_ns, stats=None, variant=0, lag_ns=0.0):
    """One step on the stand-in card: enqueued at host time ``host_ns``,
    run ``lag_ns`` after it on the card's clock."""
    rec = tl.begin("ingest")
    rec.ns[0] = host_ns - 1_000
    card.now = card.offset + host_ns + lag_ns
    rec.copy_begin(CARD)
    rec.enqueue_ns = host_ns
    card.now += copy_ns
    rec.copy_end()
    card.now += graph_ns
    rec.graph_end()
    rec.step(tl.steps, variant, stats)
    tl.steps += 1
    rec.end()
    rec.ns[1] = host_ns + 2_000
    return rec


def _anchor(tl, card, host_ns, monkeypatch):
    card.now = card.offset + host_ns
    monkeypatch.setattr(time, "perf_counter_ns", lambda: host_ns)
    tl.anchor(CARD)


def test_events_resolve_through_two_drifting_anchors(card, monkeypatch):
    tl = StepTimeline()
    tl.steps = 1
    card.offset = 7_000_000.0  # the card's clock against the host's
    real = time.perf_counter_ns
    _anchor(tl, card, 1_000_000, monkeypatch)
    monkeypatch.setattr(time, "perf_counter_ns", real)
    stats = od.ProgramStats("spmd_step_probe", events=False)
    _step(tl, card, 2_000_000, 100_000, 900_000, stats)
    _step(tl, card, 2_500_000, 100_000, 900_000, stats, lag_ns=500_000)
    assert stats.timeline_pending == 2 and stats.as_dict()["eventsPending"] == 2
    # the second anchor: the card's clock gained 1,000 ns over 10 ms
    card.offset += 1_000.0
    _anchor(tl, card, 11_000_000, monkeypatch)
    monkeypatch.setattr(time, "perf_counter_ns", real)
    recs = tl.records(2)
    assert [r["batch"] for r in recs] == [1, 2]
    (_, c0, c1), (_, g0, g1) = recs[0]["device"]
    # mapped back to the host clock within the drift's share at that time
    assert c0 == pytest.approx(2_000_000, abs=200) and c1 - c0 == pytest.approx(100_000, abs=20)
    assert g1 - g0 == pytest.approx(900_000, abs=100)
    (_, c0b, _), _ = recs[1]["device"]
    assert c0b == pytest.approx(3_000_000, abs=200)  # behind the first step, not at its enqueue
    # the step programs' device wall comes from these events: copy + graph
    assert stats.device_calls == 2 and stats.timeline_pending == 0
    assert stats.device_ms == pytest.approx(2.0)
    g = idle_gaps(recs)
    assert len(g["gaps"]) == 0
    # the drift the anchors correct places the first copy 100 ns before
    # the host enqueued it: the mapping's error, reported as its correction
    assert g["max_correction_ns"] == pytest.approx(100, abs=1)


def test_a_slot_overwritten_unread_is_a_dropped_event(card):
    tl = StepTimeline(steps=4)
    tl.steps = 1
    card.offset = 0.0
    stats = od.ProgramStats("spmd_step_probe", events=False)
    for i in range(6):
        _step(tl, card, 1_000_000 * (i + 1), 10.0, 10.0, stats)
    assert stats.events_dropped == 2 and stats.timeline_pending == 4
    tl.resolve()
    assert stats.device_calls == 4 and stats.timeline_pending == 0


def test_boot_makes_every_slots_events_and_a_step_makes_none(card):
    tl = StepTimeline(steps=8)
    tl.steps = 1
    card.offset = 0.0
    tl.arm(CARD)
    assert card.made == 3 * 8
    for i in range(10):
        _step(tl, card, 1_000 * (i + 1), 10.0, 10.0)
    assert card.made == 3 * 8


def test_a_step_program_records_no_wrapper_pair(card):
    obs = od.DeviceObservatory()
    step = obs.wrap("spmd_step_probe", lambda: None, device=CARD, events=False)
    read = obs.wrap("spmd_read_probe", lambda: None, device=CARD)
    step()
    assert card.made == 0
    read()
    assert card.made == 2


# -- /statusz --------------------------------------------------------------


def test_statusz_device_block_carries_the_timeline_summary_without_device_events(observed):
    server = serve(small_store(), storage_type="tpu", tpu_fast_ingest=True)
    try:
        client = Client(server)
        assert client.request("POST", "/api/v2/spans", TRACE_BODY,
                              {"Content-Type": "application/json"})[0] in (200, 202)
        status, body = client.request("GET", "/api/v2/tpu/statusz")
    finally:
        server.stop()
    assert status == 200
    tl = json.loads(body)["device"]["timeline"]
    assert set(tl) == {"steps", "stepsOnDevice", "profiledSteps", "cardIdleShare",
                       "idleSecondsBySpan", "maxCorrectionUs"}
    assert tl["steps"] >= 1 and tl["stepsOnDevice"] == 0
    assert tl["cardIdleShare"] is None and tl["idleSecondsBySpan"] == {}
    assert tl["maxCorrectionUs"] is None


# -- the benchmark's readers ---------------------------------------------------


def _synthetic(profiled_at=None):
    """Eight steps, every second one a flush and fold; the card idles
    200 us after each flush and fold but the last, until the next copy
    starts inside its step's upload."""
    recs, t = [], 1_000_000
    for b in range(1, 9):
        fr = b % 2 == 0
        graph = 10_000_000 if fr else 1_000_000
        up = (t - 300_000, t + 20_000)
        spans = [("route", t - 1_500_000, t - 400_000), ("lock_wait", t - 400_000, t - 390_000),
                 ("upload", *up), ("replay", t + 30_000, t + 60_000)]
        rec = _rec(b, t, (t, t + 100_000), (t + 100_000, t + 100_000 + graph), spans,
                   profiled=b == profiled_at, variant="flush_rollup" if fr else "plain")
        rec["spans"][0] = Span("ingest", t - 2_000_000, t + 500_000, None, b)
        recs.append(rec)
        t += 100_000 + graph + (200_000 if fr else 0)
    return recs


READERS = {
    "card_idle_share.feed": pytest.approx(100.0 * 3 * 200_000 / (
        8 * 100_000 + 4 * 1_000_000 + 4 * 10_000_000 + 3 * 200_000)),
    "ingest_span_ms.feed": pytest.approx(2.5),
    "route_ms.feed": pytest.approx(1.1),
    "upload_ms.feed": pytest.approx(0.32),
    "h2d_copy_ms.feed": pytest.approx(0.1),
    "flush_rollup_graph_ms.feed": pytest.approx(10.0),
}


@pytest.mark.parametrize("name", sorted(READERS))
def test_each_timeline_reader_reads_a_synthetic_timeline_and_none_under_the_profiler(name,
                                                                                     monkeypatch):
    read = bench_run.metric_reader(name)
    ctx = {"ingest_call_s": [0.0025] * 8, "trace": None}
    monkeypatch.setattr(od, "step_timeline", lambda n: _synthetic()[-n:])
    assert read(ctx) == READERS[name]
    monkeypatch.setattr(od, "step_timeline", lambda n: _synthetic(profiled_at=5)[-n:])
    assert read(ctx) is None
    # the window made no ingest call: nothing of it to read
    assert read(dict(ctx, ingest_call_s=[])) is None


def test_the_card_idle_reader_names_its_gaps_by_upload():
    g = idle_gaps(_synthetic())
    assert {n for _, _, n in g["gaps"]} == {"upload"} and len(g["gaps"]) == 3


def test_the_recapture_reader_sums_the_step_programs_recompiles(monkeypatch):
    read = bench_run.metric_reader("step_recaptures.feed")
    rows = {"spmd_step": {"recompiles": 1}, "spmd_step_flush_rollup": {"recompiles": 2},
            "spmd_card": {"recompiles": 5}}
    monkeypatch.setattr(OBSERVATORY, "programs", lambda: rows)
    assert read({"ingest_call_s": [0.001]}) == 3.0
    assert read({"ingest_call_s": []}) is None


def test_outside_the_anchors_the_mapping_follows_the_longest_baseline():
    # the middle anchor ran 40 us late: between its neighbours the mapping
    # bends through it, past the ends it keeps the first-to-last rate
    points = [(0.0, 0), (1e6 + 40_000, 1_000_000), (10e6, 10_000_000)]
    assert map_clock(points, 1e6 + 40_000) == 1_000_000
    assert map_clock(points, 12e6) == pytest.approx(12_000_000)
    assert map_clock(points, -1e6) == pytest.approx(-1_000_000)

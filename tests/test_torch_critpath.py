"""The port's ingest critical-path tracer (``zipkin_tpu_torch.obs.critpath``)
on the CPU, against the JAX package's (``zipkin_tpu.obs.critpath``).

The reference's own cases (tests/test_obs_critpath.py) run against the
port: the ledger's torn-read freedom under threaded slot reuse (every
writer stamps a fixed, pid-derived pattern, so a torn read fails the
decode), the pid guard against stragglers, the reclaim of a stale open
slot, conservation over driven runs of the port's fan-out tier with 1 and
2 workers (segments sum to the measured wall within 10% at p50), no stuck
timeline after a SIGKILLed worker, and the Little's-law gauges surviving
idle stitches. Across packages: the two modules share the slot layout word
for word, and a ledger the port's tier filled folds into equal waterfalls
under both packages' stitchers. Through the port's server: statusz's
``critpath`` section, the ``critpath*`` gauges of ``/metrics`` and the
segment families of ``/prometheus``.

Tolerances: none; the waterfalls are compared exactly, less the Little's-law
rates, which divide by each stitcher's own wall since its creation.
"""

from __future__ import annotations

import json
import threading
import time

import numpy as np
import pytest

import tests.torch_cpu  # noqa: F401  (one intra-op thread a test process)
from zipkin_tpu.obs import critpath as ref_cp
from zipkin_tpu_torch import native
from zipkin_tpu_torch.obs import critpath as cp
from zipkin_tpu_torch.obs.critpath import (
    MAX_D_IV,
    SEG_ENQUEUE,
    CritPathLedger,
    CritPathStitcher,
    _OFF_D_IV,
    _OFF_N_D,
    _OFF_PID,
    _OFF_STATE,
    _ST_FREE,
    _ST_OPEN,
)

needs_native = pytest.mark.skipif(not native.available(), reason="no C compiler for the native parser")


def test_the_slot_layout_is_the_references_word_for_word():
    names = [n for n in dir(ref_cp) if n.startswith(("_OFF_", "SEG_", "_ST_", "_FLAG_", "MAX_"))]
    names += ["SLOT_WORDS", "N_SEGS", "SEG_NAMES", "SEG_KIND", "_HDR_WORDS", "_CAL_WORDS", "_MAGIC"]
    assert {n: getattr(cp, n) for n in names} == {n: getattr(ref_cp, n) for n in names}


# -- ledger fuzz ------------------------------------------------------------


def _writer(led, widx: int, iters: int, fail: list) -> None:
    """alloc -> a pid-derived pattern -> ack -> release: the whole slot
    lifecycle with reuse (release feeds the free list, so the other writers
    recycle the slot under the readers)."""
    try:
        for i in range(iters):
            pid = widx * 1_000_000 + i + 1
            slot = led.alloc(pid, 0, wire_t0_ns=1)
            if slot < 0:
                continue  # transient exhaustion is legal (counted)
            for j in range(1 + i % 5):
                t0 = pid * 1000 + j * 10
                led.stamp(slot, SEG_ENQUEUE, t0, t0 + 7, pid=pid)
            led.ack(slot, pid=pid, t_ns=2)
            led.release(slot)
    except Exception as e:  # pragma: no cover - surfaced by the assert
        fail.append(e)


def _reader(led, stop: threading.Event, fail: list) -> None:
    """Every consistent copy of a non-free slot decodes to its header's pid."""
    try:
        while not stop.is_set():
            for slot in range(led.slots):
                blk = led.read_slot(slot)
                if blk is None or int(blk[_OFF_STATE]) == _ST_FREE:
                    continue
                pid = int(blk[_OFF_PID])
                n = int(blk[_OFF_N_D])
                assert 0 <= n <= MAX_D_IV, f"slot {slot}: n_d={n}"
                for j in range(n):
                    base = _OFF_D_IV + 3 * j
                    assert int(blk[base]) == SEG_ENQUEUE
                    t0 = int(blk[base + 1])
                    assert t0 == pid * 1000 + j * 10, f"slot {slot}: torn interval {j}"
                    assert int(blk[base + 2]) == t0 + 7
    except Exception as e:  # pragma: no cover - surfaced by the assert
        fail.append(e)


def test_ledger_fuzz_torn_read_free_under_slot_reuse():
    led = CritPathLedger(1, slots=8)  # few slots: constant reuse
    fail: list = []
    stop = threading.Event()
    readers = [threading.Thread(target=_reader, args=(led, stop, fail)) for _ in range(2)]
    writers = [threading.Thread(target=_writer, args=(led, w, 1500, fail)) for w in range(4)]
    try:
        for t in readers + writers:
            t.start()
        for t in writers:
            t.join(timeout=60)
        stop.set()
        for t in readers:
            t.join(timeout=10)
        assert not fail, fail[0]
    finally:
        stop.set()
        led.close()


def test_ledger_pid_guard_rejects_stragglers_after_reuse():
    """A stamp or ack with the old owner's pid bounces once the slot was
    reclaimed and reallocated (a SIGKILLed worker's straggler)."""
    led = CritPathLedger(1, slots=1)
    try:
        s1 = led.alloc(7, 0, wire_t0_ns=1)
        assert s1 == 0
        led.abandon(s1)
        s2 = led.alloc(8, 0, wire_t0_ns=1)
        assert s2 == 0
        led.stamp(s2, SEG_ENQUEUE, 8000, 8007, pid=7)
        led.ack(s2, pid=7)
        blk = led.read_slot(0)
        assert int(blk[_OFF_STATE]) == _ST_OPEN and int(blk[_OFF_N_D]) == 0
        led.stamp(s2, SEG_ENQUEUE, 8000, 8007, pid=8)
        assert int(led.read_slot(0)[_OFF_N_D]) == 1
        assert led.abandoned == 1
    finally:
        led.close()


def test_stale_open_slot_reclaimed_no_stuck_timeline():
    led = CritPathLedger(1, slots=4)
    st = CritPathStitcher(led, queue_capacity=4, reclaim_age_s=0.05)
    try:
        slot = led.alloc(99, 0, wire_t0_ns=time.perf_counter_ns())
        assert slot >= 0
        assert st.stitch() == 0  # too young: untouched
        assert led.state(slot) == _ST_OPEN
        time.sleep(0.1)
        st.stitch()
        assert st.reclaimed == 1 and led.state(slot) == _ST_FREE
        assert led.alloc(100, 0, wire_t0_ns=1) >= 0
    finally:
        led.close()


def test_gauges_survive_idle_stitches_until_stale_horizon():
    led = CritPathLedger(1, 8)
    try:
        st = CritPathStitcher(led, queue_capacity=4, gauge_stale_s=3600.0)
        st.lambda_cps, st.little_l, st.worker_occupancy, st.queue_saturation = 123.0, 4.5, 0.5, 0.25
        st._gauges_at_ns = time.perf_counter_ns()
        st.stitch()  # idle, inside the horizon: kept
        assert (st.lambda_cps, st.little_l, st.worker_occupancy, st.queue_saturation) == (
            123.0, 4.5, 0.5, 0.25)
        st._gauges_at_ns = time.perf_counter_ns() - int(7200 * 1e9)
        st.stitch()  # past the horizon: zeroed
        assert (st.lambda_cps, st.little_l, st.worker_occupancy, st.queue_saturation) == (
            0.0, 0.0, 0.0, 0.0)
    finally:
        led.close()


def test_stamp_active_lands_in_the_armed_timelines_only():
    """The WAL's stamps ride the dispatcher's thread-local: one payload or a
    coalesced group gets the interval, other threads none."""
    led = CritPathLedger(1, slots=4)
    try:
        a = led.alloc(1, 0, wire_t0_ns=1)
        b = led.alloc(2, 0, wire_t0_ns=1)
        cp.stamp_active(cp.SEG_WAL_APPEND, 10, 20)  # nothing armed: a no-op
        cp.set_active(led, a, 1)
        cp.stamp_active(cp.SEG_WAL_APPEND, 10, 20)
        cp.set_active_group(led, [(a, 1), (b, 2), (-1, 3)])
        other = threading.Thread(target=cp.stamp_active, args=(cp.SEG_WAL_FSYNC, 1, 2))
        other.start()
        other.join()
        cp.stamp_active(cp.SEG_WAL_FSYNC, 20, 30)
        cp.clear_active()
        cp.stamp_active(cp.SEG_WAL_FSYNC, 30, 40)
        assert [int(led.read_slot(s)[_OFF_N_D]) for s in (a, b)] == [2, 1]
    finally:
        cp.clear_active()
        led.close()


# -- the port's fan-out tier, driven ----------------------------------------


def _tier_run(n_payloads, spans_each, workers, seed, kill_widx=None, keep_raw=False):
    """Drive the port's tier with the ledger on; returns the stitched
    waterfall, the counters, the slot states and (``keep_raw``) a copy of the
    ledger's words taken before any stitch."""
    from tests.fixtures import lots_of_spans
    from tests.test_torch_mp_ingest import make_store
    from zipkin_tpu.model.json_v2 import encode_span_list
    from zipkin_tpu_torch.tpu.mp_ingest import MultiProcessIngester

    store = make_store()
    ps = [encode_span_list(lots_of_spans(spans_each, seed=seed + i, services=8 + (seed + i) % 7,
                                         span_names=16 + (seed + 2 * i) % 9))
          for i in range(n_payloads)]
    ing = MultiProcessIngester(store, workers=workers, queue_depth=8, critpath_slots=64)
    try:
        for i, p in enumerate(ps):
            cp.WIRE_T0_NS.set(time.perf_counter_ns())
            ing.submit(p)
            if kill_widx is not None and i == 0:
                ing._procs[kill_widx].kill()
                deadline = time.monotonic() + 30
                while ing._maps[kill_widx] is not None and time.monotonic() < deadline:
                    time.sleep(0.05)
                assert ing._maps[kill_widx] is None, "never reaped"
        ing.drain()
        raw = np.array(ing._cp_ledger._a) if keep_raw else None
        ing.critpath.stitch()
        wf = ing.critpath.waterfall()
        counters = ing.critpath.counters()
        states = [ing._cp_ledger.state(s) for s in range(ing._cp_ledger.slots)]
        assert counters == {k: v for k, v in ing.stats().items() if k.startswith("critpath")}
        return wf, counters, states, raw
    finally:
        cp.WIRE_T0_NS.set(0)
        ing.close()


@needs_native
@pytest.mark.parametrize("workers,seed", [(1, 11), (2, 23)])
def test_conservation_segments_sum_to_wall(workers, seed):
    wf, counters, states, _ = _tier_run(4, 512, workers, seed)
    assert wf["timelines"] == 4 == counters["critpathTimelines"]
    assert abs(wf["conservation"]["p50"] - 1.0) <= 0.10, wf["conservation"]
    assert wf["wireToDurable"]["count"] == wf["timelines"]
    assert wf["wireToDurable"]["p99Us"] >= wf["wireToDurable"]["p50Us"] > 0
    assert wf["queueWaitVsService"]["serviceUs"] > 0
    assert 0.0 <= wf["queueWaitVsService"]["waitFraction"] <= 1.0
    segs = {row["segment"]: row for row in wf["segments"]}
    # the workers' stages crossed the process boundary; the dispatcher's too
    assert segs["parse"]["count"] >= wf["timelines"]
    assert {"pack", "route", "enqueue", "device_feed"} <= set(segs)
    assert segs["device_feed"]["kind"] == "service"
    # the report's own stitch is idle: the gauges keep the load's window
    assert wf["littlesLaw"]["lambdaCps"] > 0 and wf["littlesLaw"]["workerOccupancy"] > 0
    assert all(s == _ST_FREE for s in states)


@needs_native
def test_sigkilled_worker_slots_reclaimed_no_stuck_timelines():
    wf, counters, states, _ = _tier_run(6, 256, 2, 31, kill_widx=0)
    assert all(s == _ST_FREE for s in states), states
    assert counters["critpathAbandoned"] >= 1
    if wf["timelines"]:
        assert abs(wf["conservation"]["p50"] - 1.0) <= 0.10


@needs_native
def test_a_port_ledger_stitches_to_equal_waterfalls_under_both_packages():
    """The words the port's tier wrote, copied into a ledger of each
    package, fold into the same timelines, segments, percentiles,
    conservation and slowest chunk."""
    _, _, _, raw = _tier_run(4, 512, 2, 41, keep_raw=True)
    out = {}
    for name, mod in (("port", cp), ("ref", ref_cp)):
        led = mod.CritPathLedger(2, 64)
        try:
            led._a[:] = raw
            wf = mod.CritPathStitcher(led, queue_capacity=16).waterfall()
        finally:
            led.close()
        wf.pop("littlesLaw")  # rates over each stitcher's own wall
        out[name] = wf
    assert out["port"]["timelines"] == 4
    assert json.dumps(out["port"], sort_keys=True) == json.dumps(out["ref"], sort_keys=True)


@needs_native
def test_statusz_metrics_and_prometheus_carry_the_critical_path():
    from tests.test_torch_server import Client, _mp_payloads, _mp_server, _post_until_accepted
    from tests.test_torch_store import small_store

    server = _mp_server(small_store(), tpu_mp_workers=1)
    try:
        client = Client(server)
        for body in _mp_payloads(2):
            assert _post_until_accepted(client, body)[0] == 202
        server._mp_ingester.drain()
        status, body = client.request("GET", "/api/v2/tpu/statusz")
        assert status == 200
        wf = json.loads(body)["critpath"]
        assert wf["timelines"] == 2 and wf["skipped"] == 0
        assert abs(wf["conservation"]["p50"] - 1.0) <= 0.10
        assert {"boundary", "enqueue", "parse", "device_feed"} <= {r["segment"] for r in wf["segments"]}
        metrics = json.loads(client.request("GET", "/metrics")[1])
        assert metrics["gauge.zipkin_tpu.critpathTimelines"] == 2
        prom = client.request("GET", "/prometheus")[1].decode()
        assert 'zipkin_tpu_critpath_segment_count_total{segment="parse",kind="service"} 2' in prom
        assert "zipkin_tpu_critpath_timelines 2" in prom
    finally:
        server.stop()

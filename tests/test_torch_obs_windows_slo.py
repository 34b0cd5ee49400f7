"""The port's windowed plane, SLO watchdog and incident capture
(``zipkin_tpu_torch/obs/{windows,slo,incidents}.py``) against the JAX
package's: the same scripted ticks on a fake clock give equal window stats
and equal verdicts through a trip and a clear of every spec kind, and the
same incident bundle (tests/test_obs_windows.py's and tests/test_obs_slo.py's
specs run on both packages)."""

from __future__ import annotations

import json
import os

import pytest

import tests.torch_cpu  # noqa: F401  (one intra-op thread a test process)
from zipkin_tpu.obs import incidents as ref_inc
from zipkin_tpu.obs import recorder as ref_rec
from zipkin_tpu.obs import slo as ref_slo
from zipkin_tpu.obs import windows as ref_win
from zipkin_tpu_torch.obs import incidents as port_inc
from zipkin_tpu_torch.obs import recorder as port_rec
from zipkin_tpu_torch.obs import slo as port_slo
from zipkin_tpu_torch.obs import windows as port_win

PACKAGES = {"ref": (ref_rec, ref_win, ref_slo, ref_inc), "port": (port_rec, port_win, port_slo, port_inc)}


class Clock:
    def __init__(self) -> None:
        self.t = 1000.0

    def __call__(self) -> float:
        return self.t


class Harness:
    """One package's recorder, counter dict, windows (short = 4 ticks, long
    = 8) and watchdog over the three spec kinds, driven tick by tick."""

    def __init__(self, pkg: str, incident_dir=None) -> None:
        rec_mod, win_mod, slo_mod, inc_mod = PACKAGES[pkg]
        self.rec = rec_mod.StageRecorder()
        self.vals = {"mpRejected": 0, "mpAccepted": 0, "snapshotAgeS": 0.0}
        self.clock = Clock()
        self.win = win_mod.WindowedTelemetry(
            self.rec, lambda: dict(self.vals), tick_s=1.0, slots=16, coarse_slots=4,
            coarse_factor=16, clock=self.clock)
        kw = dict(short_s=4, long_s=8)
        specs = [
            slo_mod.SloSpec("q_p99", "latency", burn_threshold=2.0, objective=0.9,
                            stage="query_fresh", threshold_us=1000, **kw),
            slo_mod.SloSpec("throttle", "ratio", burn_threshold=2.0, objective=0.9,
                            bad="mpRejected", good="mpAccepted", **kw),
            slo_mod.SloSpec("snap_age", "gauge", gauge="snapshotAgeS", limit=100.0, **kw),
        ]
        self.dog = slo_mod.SloWatchdog(self.win, specs)
        self.incidents = None
        if incident_dir is not None:
            self.incidents = inc_mod.IncidentRecorder(str(incident_dir), retention=2)
            self.incidents.add_source("slo", self.dog.status)
            self.incidents.add_source("windows", self.win.status)
            self.dog.on_trip.append(self.incidents.on_slo_trip)

    def tick(self, fast: int, slow: int, rejected: int = 0, age: float = 0.0) -> None:
        for _ in range(fast):
            self.rec.record("query_fresh", 10e-6)
        for _ in range(slow):
            self.rec.record("query_fresh", 0.050)
        self.rec.record_relayed("parse", 0.003)
        self.vals["mpRejected"] += rejected
        self.vals["mpAccepted"] += 20
        self.vals["snapshotAgeS"] = age
        self.clock.t += 1.0
        self.win.tick(self.clock())


# healthy, burning (all three kinds), then recovery: every alert trips
# and clears
SCRIPT = [(20, 0, 0, 1.0)] * 4 + [(10, 10, 20, 150.0)] * 4 + [(20, 0, 0, 1.0)] * 10


def _run(pkg: str, incident_dir=None):
    h = Harness(pkg, incident_dir)
    trail = []
    for fast, slow, rejected, age in SCRIPT:
        h.tick(fast, slow, rejected, age)
        w = h.win.window(6.0)
        trail.append((
            w.counts, w.sums, w.maxes, w.ticks, w.span_s, w.counter_deltas,
            [(v["name"], v["alert"], v["windows"]) for v in h.dog.verdicts()],
        ))
    return h, trail


def test_same_ticks_give_equal_windows_and_verdicts():
    port, got = _run("port")
    ref, want = _run("ref")
    assert got == want
    assert (port.dog.trips, port.dog.clears) == (ref.dog.trips, ref.dog.clears) == (3, 3)
    # the block-aligned long lookbacks and the status page agree too
    for lb in (4.0, 8.0, 40.0):
        a, b = port.win.window(lb), ref.win.window(lb)
        assert (a.counts, a.ticks, a.counter_deltas) == (b.counts, b.ticks, b.counter_deltas)
    assert port.win.status() == {**ref.win.status(), "tickerRunning": False}
    assert port.dog.status() == ref.dog.status()


def test_a_trip_writes_the_reference_incident_bundle(tmp_path):
    port, _ = _run("port", tmp_path / "port")
    ref, _ = _run("ref", tmp_path / "ref")
    got, want = port.incidents.bundles(), ref.incidents.bundles()
    assert [os.path.basename(p)[27:] for p in got] == [os.path.basename(p)[27:] for p in want]
    assert len(got) == 2  # three trips, retention 2
    for a, b in zip(got, want):
        ja, jb = json.loads(open(a).read()), json.loads(open(b).read())
        ja.pop("capturedAtMs"), jb.pop("capturedAtMs")
        assert ja == jb
        assert ja["trigger"]["kind"] == "slo_trip" and ja["trigger"]["verdict"]["alert"]
    assert port.incidents.counters() == ref.incidents.counters()


@pytest.mark.parametrize("short_s,long_s,burn", [(60.0, 300.0, 2.0), (5.0, 30.0, 1.5)])
def test_default_specs_equal_the_reference(short_s, long_s, burn):
    got = port_slo.default_specs(short_s=short_s, long_s=long_s, burn_threshold=burn)
    want = ref_slo.default_specs(short_s=short_s, long_s=long_s, burn_threshold=burn)
    assert [vars(s) if hasattr(s, "__dict__") else s.__getstate__() for s in got] == [
        vars(s) if hasattr(s, "__dict__") else s.__getstate__() for s in want]
    assert [s.name for s in got] == [s.name for s in want]


def test_tick_if_due_and_reset_match_the_reference():
    out = []
    for pkg in ("port", "ref"):
        h = Harness(pkg)
        h.tick(5, 0)
        h.clock.t += 5.0
        due = h.win.tick_if_due(h.clock())
        h.rec.reset()
        h.clock.t += 1.0
        h.win.tick(h.clock())
        out.append((due, h.win.ticks, h.win.resets, h.win.window(10.0).counts))
    assert out[0] == out[1] and out[0][0] == 5

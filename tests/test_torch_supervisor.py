"""The port's resume supervisor (``zipkin_tpu_torch.runtime.supervisor``)
against the JAX package's, on the CPU.

The reference's cases (tests/test_supervisor.py) run against the port:
degraded windows trip against a rolling baseline of healthy ones (and never
feed it), a deadline trips whatever the rate, the threaded mode calls
``on_trip``, and the snapshot -> exit -> boot -> resume round trip loses no
acked span (the exit snapshot covers the WAL, so the boot replays nothing,
and the resumed run answers as an uninterrupted one). Parity: the same
seeded stream of span counts on one injected clock trips both packages'
supervisors at the same observation with equal stats.

Tolerances: none.
"""

from __future__ import annotations

import threading

import numpy as np
import pytest

import tests.torch_cpu  # noqa: F401  (one intra-op thread a test process)
from tests.test_torch_overload import _assert_same_state
from tests.test_torch_store import to_port
from tests.test_torch_wal import batches, crash, port_adapter
from zipkin_tpu.runtime.supervisor import ResumeSupervisor as RefSupervisor
from zipkin_tpu_torch.runtime.supervisor import EX_RESTART, ResumeSupervisor


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _drive(sup, clock, rate, seconds, spans_start=0):
    """One observation a second at ``rate`` spans/s: (the last reason, the
    final span count)."""
    spans, reason = spans_start, None
    for _ in range(seconds):
        clock.t += 1.0
        spans += rate
        reason = sup.observe(spans)
        if reason:
            break
    return reason, spans


def test_degraded_windows_trip_against_rolling_baseline():
    clock = FakeClock()
    sup = ResumeSupervisor(None, window_s=1.0, warmup_windows=3, degraded_fraction=0.5,
                           degraded_windows=3, clock=clock)
    sup.observe(0)
    reason, spans = _drive(sup, clock, rate=1000, seconds=6)
    assert reason is None and sup.baseline_rate() == pytest.approx(1000.0)
    reason, spans = _drive(sup, clock, 100, 1, spans)  # one bad window, then recovery
    assert reason is None
    reason, spans = _drive(sup, clock, 1000, 3, spans)
    assert reason is None
    reason, spans = _drive(sup, clock, 100, 2, spans)
    assert reason is None
    reason, spans = _drive(sup, clock, 100, 1, spans)
    assert reason == "degraded" and sup.tripped == "degraded"
    assert sup.baseline_rate() == pytest.approx(1000.0)  # degraded windows never fed it
    assert sup.observe(spans + 1000) == "degraded"  # sticky
    stats = sup.stats()
    assert stats["supervisorTripped"] == "degraded"
    assert stats["supervisorBaselineRate"] == pytest.approx(1000.0)


def test_deadline_trips_regardless_of_rate():
    clock = FakeClock()
    sup = ResumeSupervisor(None, window_s=1.0, deadline_s=5.0, clock=clock)
    sup.observe(0)
    assert _drive(sup, clock, rate=10_000, seconds=4)[0] is None
    assert _drive(sup, clock, rate=10_000, seconds=1, spans_start=40_000)[0] == "deadline"
    assert EX_RESTART == 75


def test_threaded_mode_invokes_on_trip():
    class StubStore:
        spans = 0

        def ingest_counters(self):
            return {"spans": self.spans}

    sup = ResumeSupervisor(StubStore(), window_s=0.02, deadline_s=0.05)
    tripped, reasons = threading.Event(), []
    sup.start(lambda r: (reasons.append(r), tripped.set()))
    assert tripped.wait(5.0)
    sup.stop()
    assert reasons == ["deadline"]


def test_a_seeded_rate_stream_trips_both_packages_alike():
    """400 seeded observations (healthy, dipping, then collapsed) through
    both packages' supervisors: the same reason at the same observation,
    and equal stats after every one."""
    rng = np.random.default_rng(5)
    clock = FakeClock()
    kw = dict(window_s=2.0, warmup_windows=3, degraded_fraction=0.4, degraded_windows=3,
              baseline_windows=6, clock=clock)
    port, ref = ResumeSupervisor(None, **kw), RefSupervisor(None, **kw)
    spans, tripped_at = 0, None
    for i in range(400):
        clock.t += float(rng.uniform(0.2, 0.9))
        rate = 5000.0 if i < 250 else 600.0
        spans += int(rate * rng.uniform(0.2, 1.0))
        got, want = port.observe(spans), ref.observe(spans)
        assert got == want, i
        assert port.stats() == ref.stats(), i
        if got is not None and tripped_at is None:
            tripped_at = i
    assert tripped_at is not None and tripped_at > 250


def test_round_trip_snapshot_exit_boot_resume_zero_acked_loss(tmp_path):
    """A supervised run trips on its deadline, drains and snapshots, the
    process exits (the store is abandoned), a relaunch boots from the same
    dirs with every acked span, and the resumed run ends equal to an
    uninterrupted one."""
    bs = batches(6)
    clock = FakeClock()
    victim = port_adapter(tmp_path)
    sup = ResumeSupervisor(victim, window_s=1.0, deadline_s=3.5, clock=clock)
    tripped_at = None
    for i, spans in enumerate(bs):
        victim.accept(to_port(spans)).execute()
        clock.t += 1.0
        if sup.observe(victim.agg.host_counters["spans"]):
            tripped_at = i
            break
    assert tripped_at is not None and tripped_at < len(bs) - 1
    assert sup.finalize() is not None  # drain and the exit snapshot
    acked = victim.agg.host_counters["spans"]
    crash(victim)  # exit restartable: the device state is gone
    del victim
    resumed = port_adapter(tmp_path)
    assert resumed.agg.host_counters["spans"] == acked
    assert resumed.resume_offset == acked
    assert resumed.restore_stats["walReplayBatches"] == 0  # the snapshot covered the WAL
    for spans in bs[tripped_at + 1:]:
        resumed.accept(to_port(spans)).execute()
    oracle = port_adapter(tmp_path / "oracle", wal_dir=False, checkpoint=False)
    for spans in bs:
        oracle.accept(to_port(spans)).execute()
    _assert_same_state(oracle, resumed)
    resumed.close()
    oracle.close()


def test_finalize_without_snapshot_dir_is_safe(tmp_path):
    store = port_adapter(tmp_path, checkpoint=False)
    sup = ResumeSupervisor(store, deadline_s=0.001)
    assert sup.finalize() is None
    store.close()

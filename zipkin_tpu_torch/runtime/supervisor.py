"""Resume supervisor and respawn pacing (the port's copy of
``zipkin_tpu/runtime/supervisor.py``).

:class:`ResumeSupervisor` watches the ingest rate against a rolling
baseline of healthy windows. When the rate stays collapsed, or a wall
deadline arrives, it drains the device work in flight, takes a snapshot
(which truncates the covered WAL segments) and tells the host loop to exit
with :data:`EX_RESTART`, so an outer relauncher (systemd, a job runner, a
script) relaunches it on the same resume dir and boot restore carries on
with no acked span lost. Two ways to drive it:

- **passive**: the ingest loop calls :meth:`ResumeSupervisor.observe` with
  the cumulative span count after each batch; a non-None return is the trip
  reason, and the loop calls :meth:`ResumeSupervisor.finalize` and exits.
- **threaded**: :meth:`ResumeSupervisor.start` samples
  ``store.ingest_counters()["spans"]`` every window on a daemon thread and
  calls ``on_trip(reason)`` once tripped. That thread is then the only
  writer of the supervisor's state, so the class needs no lock.

:class:`RespawnBackoff` paces the reader-process supervisor's respawns
(:mod:`zipkin_tpu_torch.serving.supervisor`). The module imports neither
torch nor numpy.
"""

from __future__ import annotations

import logging
import statistics
import threading
import time
from collections import deque
from typing import Callable, Optional

logger = logging.getLogger(__name__)

# BSD sysexits EX_TEMPFAIL: "transient failure, retry", the contract
# between a supervised window and its relauncher
EX_RESTART = 75


class RespawnBackoff:
    """Per-child respawn pacing: exponential delay, reset on a child
    that stayed up past ``healthy_s``. Shared by the reader-process
    supervisor (`serving/supervisor.py`) and usable by any relauncher
    that must not hot-loop a crash-on-boot child.

    ``ready_at`` answers "may child ``key`` respawn now?" without
    sleeping — supervisor loops poll, they do not block per child."""

    def __init__(
        self,
        *,
        base_s: float = 0.5,
        max_s: float = 30.0,
        healthy_s: float = 30.0,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.base_s = float(base_s)
        self.max_s = float(max_s)
        self.healthy_s = float(healthy_s)
        self._clock = clock
        # key -> [consecutive_fails, earliest_respawn_at]
        self._state: dict = {}
        self.respawns = 0

    def note_spawn(self, key) -> None:
        st = self._state.setdefault(key, [0, 0.0])
        self._state[key] = [st[0], self._clock()]

    def note_death(self, key, uptime_s: float) -> float:
        """Record a child death; returns the delay before its respawn
        (0 when the child had been up long enough to reset the run)."""
        st = self._state.setdefault(key, [0, 0.0])
        fails = 0 if uptime_s >= self.healthy_s else st[0] + 1
        delay = (
            0.0 if fails == 0
            else min(self.max_s, self.base_s * (2 ** (fails - 1)))
        )
        self._state[key] = [fails, self._clock() + delay]
        self.respawns += 1
        return delay

    def ready_at(self, key) -> float:
        return self._state.get(key, [0, 0.0])[1]

    def ready(self, key) -> bool:
        return self._clock() >= self.ready_at(key)


class ResumeSupervisor:
    def __init__(
        self,
        store,
        *,
        window_s: float = 5.0,
        baseline_windows: int = 12,
        warmup_windows: int = 3,
        degraded_fraction: float = 0.25,
        degraded_windows: int = 3,
        deadline_s: float = 0.0,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        """``degraded_fraction``: a window is degraded when its rate is
        below this fraction of the rolling baseline (median of the last
        ``baseline_windows`` healthy windows); ``degraded_windows``
        consecutive degraded windows trip. ``deadline_s`` (0 = off)
        trips unconditionally at that wall age. ``clock`` is injectable
        so tests fabricate time."""
        self.store = store
        self.window_s = float(window_s)
        self.warmup_windows = int(warmup_windows)
        self.degraded_fraction = float(degraded_fraction)
        self.degraded_windows = int(degraded_windows)
        self.deadline_s = float(deadline_s)
        self._clock = clock
        self._baseline: deque = deque(maxlen=int(baseline_windows))
        self._t0: Optional[float] = None
        self._last_t = 0.0
        self._last_spans = 0
        self._degraded_run = 0
        self._tripped: Optional[str] = None
        self.windows = 0
        self.last_rate = 0.0
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- sampling --------------------------------------------------------

    @property
    def tripped(self) -> Optional[str]:
        return self._tripped

    def baseline_rate(self) -> float:
        return statistics.median(self._baseline) if self._baseline else 0.0

    def observe(self, spans_total: int) -> Optional[str]:
        """Feed the cumulative span count; returns the trip reason
        ("degraded" / "deadline", sticky) or None while healthy."""
        if self._tripped is not None:
            return self._tripped
        now = self._clock()
        if self._t0 is None:
            self._t0 = now
            self._last_t, self._last_spans = now, int(spans_total)
            return None
        if self.deadline_s and now - self._t0 >= self.deadline_s:
            return self._trip("deadline")
        elapsed = now - self._last_t
        if elapsed < self.window_s:
            return None
        rate = (int(spans_total) - self._last_spans) / elapsed
        self._last_t, self._last_spans = now, int(spans_total)
        self.windows += 1
        self.last_rate = rate
        baseline = self.baseline_rate()
        if (
            len(self._baseline) >= self.warmup_windows
            and rate < self.degraded_fraction * baseline
        ):
            self._degraded_run += 1
            logger.warning(
                "supervisor: degraded window %d/%d (%.0f spans/s vs "
                "baseline %.0f)",
                self._degraded_run, self.degraded_windows, rate, baseline,
            )
            if self._degraded_run >= self.degraded_windows:
                return self._trip("degraded")
        else:
            # only healthy windows feed the baseline, so a long
            # degradation cannot talk the baseline down to itself
            self._degraded_run = 0
            self._baseline.append(rate)
        return None

    def _trip(self, reason: str) -> str:
        self._tripped = reason
        logger.warning(
            "supervisor tripped (%s) after %d windows: snapshot and "
            "exit restartable (exit code %d)",
            reason, self.windows, EX_RESTART,
        )
        return reason

    # -- the exit-restartable sequence -----------------------------------

    def finalize(self) -> Optional[str]:
        """Drain in-flight batches, snapshot (truncates covered WAL).
        After this returns, the process may exit with EX_RESTART and a
        relaunch against the same dirs resumes with zero acked loss."""
        agg = getattr(self.store, "agg", None)
        if agg is not None:
            # quiesce before the snapshot: no device batch in flight is
            # lost between the last ack and the exit snapshot
            agg.block_until_ready()
        path = None
        if hasattr(self.store, "snapshot"):
            path = self.store.snapshot()
        logger.info("supervisor: exit snapshot %s", path or "(no dir)")
        return path

    def stats(self) -> dict:
        """Gauge-shaped telemetry for /metrics-style surfaces."""
        return {
            "supervisorWindows": self.windows,
            "supervisorLastRate": round(self.last_rate, 3),
            "supervisorBaselineRate": round(self.baseline_rate(), 3),
            "supervisorTripped": self._tripped or "",
        }

    # -- optional threaded mode ------------------------------------------

    def start(self, on_trip: Callable[[str], None]) -> None:
        """Sample ``store.ingest_counters()["spans"]`` every window on a
        daemon thread; call ``on_trip(reason)`` once when tripped."""
        if self._thread is not None:
            raise RuntimeError("supervisor already started")

        def loop() -> None:
            while not self._stop.wait(self.window_s):
                reason = self.observe(
                    self.store.ingest_counters().get("spans", 0)
                )
                if reason is not None:
                    on_trip(reason)
                    return

        self._thread = threading.Thread(
            target=loop, name="zt-resume-supervisor", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.window_s + 5.0)
            self._thread = None

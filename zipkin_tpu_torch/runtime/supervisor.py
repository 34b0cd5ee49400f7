"""Respawn pacing for relaunched child processes (the port's copy of
``RespawnBackoff`` from ``zipkin_tpu/runtime/supervisor.py:44``).

Only this class is ported so far: the reader-process supervisor
(:mod:`zipkin_tpu_torch.serving.supervisor`) needs it. The rest of the
reference module (``ResumeSupervisor``, ``EX_RESTART``) comes with the
admission slice.
"""

from __future__ import annotations

import time
from typing import Callable


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

"""Reader-process supervisor: spawn, health-check, respawn, aggregate (the
port's copy of ``zipkin_tpu/serving/supervisor.py``).

Spawns ``TPU_READERS`` reader processes (spawn context — a reader
import chain is numpy + the standard library, never torch), each on
``port_base + idx``, and keeps them alive: a dead child respawns on
the shared :class:`RespawnBackoff` schedule (`runtime/supervisor.py`),
and the cumulative respawn count lands in the segment's supervisor
header words so the INGEST process's ``/statusz`` serving block sees
it without any channel beyond the segment itself.

Health is read from the segment, not guessed: each serve updates the
reader's heartbeat stripe (pid, last generation seen, serve age), so
``status()`` reports per-reader generation lag against the segment's
live generation — a reader that stopped advancing is visibly lagging
before it is visibly dead.

Aggregation: :meth:`scrape_metrics` / :meth:`scrape_prometheus` fan
out to every live reader's HTTP surface and merge — prometheus lines
already carry their ``reader="rN"`` label from the reader itself, so
the merge is concatenation plus a supervisor self-block.
"""

from __future__ import annotations

import logging
import os
import time
import urllib.error
import urllib.request
from typing import Callable, Dict, List, Optional

from zipkin_tpu_torch.runtime.supervisor import RespawnBackoff
from zipkin_tpu_torch.serving.reader import run_reader
from zipkin_tpu_torch.serving.segment import MirrorSegment

logger = logging.getLogger(__name__)

_SCRAPE_TIMEOUT_S = 2.0


class ReaderSupervisor:
    """Owns N reader children over one attached segment."""

    def __init__(
        self,
        segment: MirrorSegment,
        n_readers: int,
        port_base: int,
        *,
        target: Callable = run_reader,
        backoff: Optional[RespawnBackoff] = None,
    ) -> None:
        import multiprocessing as mp

        self._ctx = mp.get_context("spawn")
        self.segment = segment
        self.n_readers = int(n_readers)
        self.port_base = int(port_base)
        self._target = target
        self._backoff = backoff or RespawnBackoff()
        self._children: Dict[int, object] = {}
        self._spawned_at: Dict[int, float] = {}
        self.respawns = 0
        self.started = False

    def _spawn(self, idx: int):
        proc = self._ctx.Process(
            target=self._target,
            args=(self.segment.params(), idx, self.port_base + idx),
            name=f"zt-reader-r{idx}",
            daemon=True,
        )
        proc.start()
        self._children[idx] = proc
        self._spawned_at[idx] = time.monotonic()
        self._backoff.note_spawn(idx)
        return proc

    def start(self) -> None:
        if self.started:
            raise RuntimeError("reader supervisor already started")
        self.started = True
        self.segment.note_supervisor(os.getpid(), self.respawns)
        for idx in range(self.n_readers):
            self._spawn(idx)
        logger.info(
            "reader supervisor: %d readers on ports %d..%d",
            self.n_readers, self.port_base,
            self.port_base + self.n_readers - 1,
        )

    def poll(self) -> int:
        """One supervision pass: respawn dead children whose backoff
        window has passed. Returns how many respawned (the chaos test's
        observable)."""
        respawned = 0
        for idx, proc in list(self._children.items()):
            if proc is not None and proc.is_alive():
                continue
            if proc is not None:
                # newly observed death: record it once, then wait out
                # the backoff window before the respawn below
                proc.join(timeout=0)
                uptime = time.monotonic() - self._spawned_at.get(idx, 0.0)
                delay = self._backoff.note_death(idx, uptime)
                logger.warning(
                    "reader r%d died (exit %s, up %.1fs); respawning%s",
                    idx, proc.exitcode, uptime,
                    f" after {delay:.1f}s backoff" if delay else "",
                )
                self._children[idx] = None
            if self._backoff.ready(idx):
                self._spawn(idx)
                self.respawns += 1
                respawned += 1
                self.segment.note_supervisor(os.getpid(), self.respawns)
        return respawned

    def run(self, poll_s: float = 0.5,
            stop: Optional[Callable[[], bool]] = None) -> None:
        """Blocking supervision loop (the ``__main__`` driver)."""
        while stop is None or not stop():
            self.poll()
            time.sleep(poll_s)

    def stop(self, timeout_s: float = 5.0) -> None:
        # a child that died and waits out its backoff is None here
        procs = [p for p in self._children.values() if p is not None]
        for proc in procs:
            if proc.is_alive():
                proc.terminate()
        for proc in procs:
            proc.join(timeout=timeout_s)
            if proc.is_alive():  # pragma: no cover - stuck child
                proc.kill()
                proc.join(timeout=timeout_s)
        self._children.clear()

    # -- health / aggregation ---------------------------------------------

    def status(self) -> Dict:
        """The serving status block: segment header + per-reader
        heartbeats (generation lag, serve ages) + child liveness."""
        body = self.segment.status()
        alive = {
            idx: proc is not None and proc.is_alive()
            for idx, proc in self._children.items()
        }
        for row in body["readers"]:
            idx = int(row["reader"][1:])
            row["childAlive"] = alive.get(idx, False)
        body["respawns"] = self.respawns
        body["configuredReaders"] = self.n_readers
        body["portBase"] = self.port_base
        return body

    def _scrape(self, idx: int, path: str) -> Optional[str]:
        url = f"http://127.0.0.1:{self.port_base + idx}{path}"
        try:
            with urllib.request.urlopen(
                url, timeout=_SCRAPE_TIMEOUT_S
            ) as resp:
                return resp.read().decode("utf-8", "replace")
        except (urllib.error.URLError, OSError, TimeoutError):
            return None

    def scrape_metrics(self) -> Dict:
        """Per-reader ``/metrics`` JSON, reader-keyed, plus the
        supervisor's own block."""
        import json

        readers: Dict[str, object] = {}
        for idx in range(self.n_readers):
            raw = self._scrape(idx, "/metrics")
            if raw is None:
                readers[f"r{idx}"] = {"unreachable": True}
                continue
            try:
                readers[f"r{idx}"] = json.loads(raw).get("reader", {})
            except ValueError:
                readers[f"r{idx}"] = {"unreachable": True}
        return {
            "supervisor": {
                "pid": os.getpid(),
                "respawns": self.respawns,
                "configuredReaders": self.n_readers,
            },
            "readers": readers,
        }

    def scrape_prometheus(self) -> str:
        """Concatenated reader families (each line already labeled
        ``reader="rN"`` at the source) + supervisor gauges."""
        parts: List[str] = [
            f"zipkin_tpu_reader_supervisor_respawns {self.respawns}",
            f"zipkin_tpu_reader_supervisor_readers {self.n_readers}",
        ]
        for idx in range(self.n_readers):
            raw = self._scrape(idx, "/prometheus")
            if raw is None:
                parts.append(
                    f'zipkin_tpu_reader_up{{reader="r{idx}"}} 0'
                )
                continue
            parts.append(f'zipkin_tpu_reader_up{{reader="r{idx}"}} 1')
            parts.append(raw.rstrip("\n"))
        return "\n".join(parts) + "\n"

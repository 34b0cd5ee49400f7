"""Incident capture: SLO trips dump a debug bundle that outlives rings.

The observability planes are deliberately volatile — slow rings,
windowed delta rings, stitcher aggregates — so by the time an operator
looks at a tripped SLO, the evidence has often rotated out. The
watchdog's ``on_trip`` hook hands each trip to an
:class:`IncidentRecorder`, which snapshots every registered source
(statusz-equivalent dicts: stage histograms, the slow ring, ingest and
query waterfalls, windowed percentiles, the verdict list) into one JSON
bundle under ``TPU_OBS_INCIDENT_DIR``, with bounded retention so a
flapping SLO cannot fill the disk.

Capture runs on the ticker thread (evaluate → trip → hook), so sources
must be plain functions that build dicts; every source is wrapped in its own
try/except and a failing source degrades to an error note instead of
losing the bundle.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable, Dict, Optional

_PREFIX = "incident-"


class IncidentRecorder:
    """Writes bounded-retention incident bundles to ``directory``."""

    def __init__(self, directory: str, retention: int = 16,
                 sources: Optional[Dict[str, Callable]] = None) -> None:
        self.directory = directory
        self.retention = max(1, int(retention))
        self.sources: Dict[str, Callable] = dict(sources or {})
        self._lock = threading.Lock()
        self.captured = 0
        self.errors = 0
        os.makedirs(directory, exist_ok=True)

    def add_source(self, name: str, fn: Callable) -> None:
        self.sources[name] = fn

    def on_slo_trip(self, name: str, verdict: Dict) -> Optional[str]:
        """Watchdog ``on_trip`` adapter."""
        return self.capture({"kind": "slo_trip", "name": name,
                             "verdict": verdict})

    def capture(self, trigger: Dict) -> Optional[str]:
        """Snapshot every source into one bundle; returns its path."""
        bundle: Dict = {
            "trigger": trigger,
            "capturedAtMs": int(time.time() * 1000),
        }
        for name, fn in list(self.sources.items()):
            try:
                bundle[name] = fn()
            except Exception as e:
                bundle[name] = {"error": str(e)}
        stem = str(trigger.get("name", "incident")).replace(os.sep, "_")
        with self._lock:
            path = os.path.join(
                self.directory,
                f"{_PREFIX}{bundle['capturedAtMs']:013d}-"
                f"{self.captured:04d}-{stem}.json",
            )
            try:
                tmp = path + ".tmp"
                with open(tmp, "w") as f:
                    json.dump(bundle, f, default=str)
                os.replace(tmp, path)
            except Exception:
                self.errors += 1
                return None
            self.captured += 1
            self._prune_locked()
        return path

    def bundles(self):
        """Bundle paths, oldest first (name order == capture order)."""
        try:
            names = sorted(
                n for n in os.listdir(self.directory)
                if n.startswith(_PREFIX) and n.endswith(".json")
            )
        except OSError:
            return []
        return [os.path.join(self.directory, n) for n in names]

    def _prune_locked(self) -> None:
        stale = self.bundles()[:-self.retention]
        for p in stale:
            try:
                os.remove(p)
            except OSError:
                pass

    def counters(self) -> Dict:
        return {
            "incidentsCaptured": self.captured,
            "incidentWriteErrors": self.errors,
            "incidentRetention": self.retention,
        }

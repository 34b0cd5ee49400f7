"""Device-program observatory over CUDA events (the port's counterpart of
``zipkin_tpu/obs/device.py``, rewritten for the card).

Every device entry point of the aggregator (the ingest step variants, the
flush and rollup, the ``spmd_*`` reads) and the hand kernel itself
(``hll_update_step``, ``hll_update``) is wrapped in
:meth:`DeviceObservatory.wrap`, under the reference's program names, which
captures:

- **calls and the host wall of each call** (``callWallMs``,
  ``maxCallMs``): the Python the entry point runs, its launches and any
  host read inside it. Torch launches are asynchronous, so on the card this
  is mostly the host's enqueue cost, as the reference's dispatch wall is;
- **the per-call device wall**: on a CUDA device, a pair of
  ``torch.cuda.Event(enable_timing=True)`` recorded on the device's current
  stream before and after the call (the stream the step and the kernel
  launch on). The pairs wait in a bounded per-program queue and are
  resolved with ``Event.query()`` only when :meth:`status` or
  :meth:`programs` is read — the wrapper never synchronizes, so the
  asynchronous dispatch the ingest path relies on is untouched. A pair
  measures from the first to the last work the call queued, gaps
  included; queued work of other threads on the same stream lands inside
  it too;
- **compiles**: the port has no jit, so nothing recompiles
  (``recompiles`` stays 0). ``compiles`` counts the first-use ``nvcc``
  build of the hand kernel's library when a wrapped kernel call ran it,
  and is 0 for every other program. ``cost`` and ``memory`` are absent, as
  the reference leaves them when its analysis fails;
- **live device memory and host-transfer gauges**:
  ``torch.cuda.memory_stats()`` and ``torch.cuda.mem_get_info()`` on the
  card (``{}`` on the CPU), and the readpack transfer count and bytes.

An S-shard aggregator's program runs every shard inside one wrapped call
(one call a step or a read, as the reference's one SPMD program), and its
event pair is recorded on the first shard's device: on a mesh of several
cards the other cards' work shows only where the merge waits for it.

Counter updates are plain attribute writes: the aggregator's programs run
under its lock and these are debug gauges. The registry is process-global
and name-keyed; every aggregator wraps its own programs, so one name may
hold several builds — reads merge them. This is the one obs module that
uses torch, and it imports it at the first CUDA call, never at load.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from zipkin_tpu_torch.obs import querytrace

# unresolved event pairs a program keeps; past it the oldest is dropped
# (counted), so a program nobody reads holds bounded memory
EVENT_QUEUE = 4096


class ProgramStats:
    """Counters for one wrapped program build."""

    __slots__ = ("name", "calls", "compiles", "call_wall_s", "compile_wall_s",
                 "last_compile_s", "max_call_s", "device_ms", "device_calls",
                 "max_device_ms", "min_device_ms", "events_dropped", "_pending",
                 "_qlock", "_compile_probe")

    def __init__(self, name: str, compile_probe: Optional[Callable[[], int]] = None) -> None:
        self.name = name
        self.calls = 0
        self.compiles = 0
        self.call_wall_s = 0.0
        self.compile_wall_s = 0.0
        self.last_compile_s = 0.0
        self.max_call_s = 0.0
        self.device_ms = 0.0
        self.device_calls = 0
        self.max_device_ms = 0.0
        self.min_device_ms = 0.0
        self.events_dropped = 0
        self._pending: deque = deque()
        # the queue's drop in observe() and the peek-then-pop in resolve()
        # run on different threads (the caller's, statusz's)
        self._qlock = threading.Lock()
        self._compile_probe = compile_probe

    recompiles = 0  # no jit: a shape change never rebuilds anything

    def observe(self, fn: Callable, device, args: tuple, kw: dict) -> Any:
        probe = self._compile_probe
        before = probe() if probe is not None else 0
        stream = None
        dev = _cuda_device(device, args)
        if dev is not None:
            import torch

            stream = torch.cuda.current_stream(dev)
            e0 = torch.cuda.Event(enable_timing=True)
            e0.record(stream)
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        dt = time.perf_counter() - t0
        if stream is not None:
            e1 = torch.cuda.Event(enable_timing=True)
            e1.record(stream)
            with self._qlock:
                if len(self._pending) >= EVENT_QUEUE:
                    self._pending.popleft()
                    self.events_dropped += 1
                self._pending.append((e0, e1))
        # a traced query's device_dispatch segment is this call's host wall
        # (perf_counter and perf_counter_ns share a clock)
        querytrace.stamp_active(querytrace.QSEG_DEVICE_DISPATCH, int(t0 * 1e9), int((t0 + dt) * 1e9))
        self.calls += 1
        self.call_wall_s += dt
        if dt > self.max_call_s:
            self.max_call_s = dt
        if probe is not None:
            built = probe() - before
            if built > 0:
                self.compiles += built
                self.compile_wall_s += dt
                self.last_compile_s = dt
        return out

    def resolve(self) -> None:
        """Fold every finished event pair, oldest first, into the device
        wall; stop at the first unfinished one (a stream finishes in
        order). ``query()`` never blocks."""
        pending = self._pending
        while True:
            with self._qlock:
                if not pending or not pending[0][1].query():
                    return
                e0, e1 = pending.popleft()
            ms = float(e0.elapsed_time(e1))
            if self.device_calls == 0 or ms < self.min_device_ms:
                self.min_device_ms = ms
            self.device_calls += 1
            self.device_ms += ms
            if ms > self.max_device_ms:
                self.max_device_ms = ms

    def reset(self) -> None:
        self.calls = self.compiles = 0
        self.call_wall_s = self.compile_wall_s = self.last_compile_s = self.max_call_s = 0.0
        self.device_ms = self.max_device_ms = self.min_device_ms = 0.0
        self.device_calls = self.events_dropped = 0
        with self._qlock:
            self._pending.clear()

    def as_dict(self) -> Dict:
        return {
            "calls": self.calls,
            "compiles": self.compiles,
            "recompiles": self.recompiles,
            "callWallMs": round(self.call_wall_s * 1e3, 3),
            "compileWallMs": round(self.compile_wall_s * 1e3, 3),
            "lastCompileMs": round(self.last_compile_s * 1e3, 3),
            "maxCallMs": round(self.max_call_s * 1e3, 3),
            "deviceCalls": self.device_calls,
            "deviceMs": self.device_ms,
            "maxDeviceMs": self.max_device_ms,
            "minDeviceMs": self.min_device_ms,
            "eventsPending": len(self._pending),
            "eventsDropped": self.events_dropped,
        }


def _cuda_device(device, args: tuple):
    """The CUDA device a call runs on, or None (no events off the card).
    ``device`` is the one given at wrap time; without it, the first
    argument's ``.device`` (a kernel wrapper's register file)."""
    if device is None and args:
        device = getattr(args[0], "device", None)
    if device is None or getattr(device, "type", None) != "cuda":
        return None
    return device


class DeviceObservatory:
    """Process-global registry of wrapped device programs."""

    def __init__(self, enabled: bool = True) -> None:
        self._enabled = bool(enabled)
        self._lock = threading.Lock()
        self._programs: Dict[str, List[ProgramStats]] = {}

    def wrap(self, name: str, fn: Callable, device=None,
             compile_probe: Optional[Callable[[], int]] = None) -> Callable:
        """Wrap one device entry point; transparent when disabled.
        ``device`` (a ``torch.device``) is where its work runs: without it,
        the first argument's device. ``compile_probe`` returns a count that
        grows when the call built the kernel it launches."""
        entry = ProgramStats(name, compile_probe)
        with self._lock:
            self._programs.setdefault(name, []).append(entry)
        obs = self

        def wrapper(*args, **kw):
            if not obs._enabled:
                return fn(*args, **kw)
            return entry.observe(fn, device, args, kw)

        wrapper.__name__ = name
        wrapper.__wrapped__ = fn
        wrapper.program_stats = entry
        return wrapper

    # -- configuration -------------------------------------------------

    @property
    def enabled(self) -> bool:
        return self._enabled

    def set_enabled(self, on: bool) -> None:
        self._enabled = bool(on)

    def reset_counters(self) -> None:
        """Forget every entry's counters and pending events; keeps wraps."""
        for e in self._entries():
            e.reset()

    # -- query side ----------------------------------------------------

    def _entries(self) -> List[ProgramStats]:
        with self._lock:
            return [e for lst in self._programs.values() for e in lst]

    def totals(self) -> Dict[str, int]:
        calls = compiles = recompiles = 0
        for e in self._entries():
            calls += e.calls
            compiles += e.compiles
            recompiles += e.recompiles
        return {"programs": len(self._programs), "calls": calls,
                "compiles": compiles, "recompiles": recompiles}

    def programs(self) -> Dict[str, Dict]:
        """Per-name merged view (several builds of one name sum up), with
        every finished event pair resolved first."""
        with self._lock:
            items = {k: list(v) for k, v in self._programs.items()}
            for entries in items.values():
                for e in entries:
                    e.resolve()
        out: Dict[str, Dict] = {}
        for name, entries in sorted(items.items()):
            merged: Dict = {
                "builds": len(entries), "calls": 0, "compiles": 0, "recompiles": 0,
                "callWallMs": 0.0, "compileWallMs": 0.0, "lastCompileMs": 0.0,
                "maxCallMs": 0.0, "deviceCalls": 0, "deviceMs": 0.0,
                "maxDeviceMs": 0.0, "minDeviceMs": 0.0, "eventsPending": 0,
                "eventsDropped": 0,
            }
            for e in entries:
                d = e.as_dict()
                for key in ("calls", "compiles", "recompiles", "deviceCalls", "eventsPending",
                            "eventsDropped"):
                    merged[key] += d[key]
                for key in ("callWallMs", "compileWallMs"):
                    merged[key] = round(merged[key] + d[key], 3)
                merged["deviceMs"] += d["deviceMs"]
                for key in ("lastCompileMs", "maxCallMs", "maxDeviceMs"):
                    merged[key] = max(merged[key], d[key])
                if d["deviceCalls"] and (merged["minDeviceMs"] == 0.0
                                         or d["minDeviceMs"] < merged["minDeviceMs"]):
                    merged["minDeviceMs"] = d["minDeviceMs"]
            merged["meanDeviceMs"] = (merged["deviceMs"] / merged["deviceCalls"]
                                      if merged["deviceCalls"] else 0.0)
            merged["deviceMs"] = round(merged["deviceMs"], 6)
            out[name] = merged
        return out

    def status(self) -> Dict:
        """Full dict for the ``/statusz`` device section."""
        from zipkin_tpu_torch import readpack  # imports torch, as this read does

        return {
            "enabled": self._enabled,
            "analysis": False,  # no compiler analysis on the card
            "totals": self.totals(),
            "programs": self.programs(),
            "hbm": hbm_stats(),
            "transfers": {"count": readpack.transfer_count(),
                          "bytes": readpack.transfer_bytes()},
        }


def hbm_stats() -> Dict:
    """Live device memory of the visible cards from the caching allocator
    (``allocated_bytes.all.current`` and ``.peak``) and the CUDA runtime
    (``mem_get_info``: the card's total as the limit); ``{}`` when no card
    is in use (the store runs on the CPU)."""
    import sys

    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return {}
    in_use = limit = peak = seen = 0
    for d in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(d)
        if not stats:
            continue
        seen += 1
        in_use += int(stats.get("allocated_bytes.all.current", 0))
        peak += int(stats.get("allocated_bytes.all.peak", 0))
        limit += int(torch.cuda.mem_get_info(d)[1])
    if not seen:
        return {}
    return {"devices": seen, "bytesInUse": in_use, "bytesLimit": limit,
            "peakBytesInUse": peak}


def _env_on(name: str, default: str = "1") -> bool:
    return os.environ.get(name, default).strip().lower() not in ("0", "false", "no")


OBSERVATORY = DeviceObservatory(enabled=_env_on("TPU_OBS_DEVICE") and _env_on("TPU_OBS"))

wrap = OBSERVATORY.wrap

"""Captured CUDA graphs of the ingest step: the port's counterpart of the
reference's compiled step (``zipkin_tpu/tpu/ingest.py:590-599``,
``jit_ingest``, and ``zipkin_tpu/parallel/sharded.py:125-150``, its
``jax.jit(shard_map(...), donate_argnums=(0,))`` per step variant).

The reference runs every ingest step as one compiled device program,
cached by shape. Here a step variant (plain, with the digest flush, with
the link rollup, with both) of one shard's state at one lane count is one
``torch.cuda.CUDAGraph``, captured once and replayed for every later batch
of that lane count: the hundreds of launches of the step's torch ops and
hand kernels go to the card as one graph launch. The shapes are the ones
the callers already pad to (``route_fused``'s pad multiple, the
``lane_bucket`` ladder), as jit's cache is keyed by shape.

- Each graph reads its shard's ``[11, lanes]`` int32 wire image from a
  static input buffer (one per lane count and shard) that the pinned
  upload copies into before the replay; widening and unpacking the image
  run inside the graph.
- A graph is captured before it first runs, and the capture touches no
  state: the first batch of a (variant, lanes, shard) captures its graph
  and then replays it, so a capture that fails raises with the state and
  the caller's bookkeeping as they were (there is no eager fallback on a
  card). :meth:`StepGraphs.capture` alone is what a store or server calls
  at boot (``TorchAggregator.capture_steps``), so no capture lands in a
  serving window.
- The first capture of a (variant, lanes) on a device of a process is
  preceded by a warm-up: the program runs eagerly on a scratch copy of the
  state over the same input, so first-use work (the kernels' builds, their
  device words, the library's lazily loaded kernels) lands outside the
  capture. Its launches count as warm-ups
  (:func:`zipkin_tpu_torch.kernels.warming_up`), not as steps.
- The capture is ``capture_begin``/``capture_end`` on a side stream,
  which records the work and runs none of it, with
  ``capture_error_mode="thread_local"`` (other threads may use the card
  meanwhile) and without the ``torch.cuda.graph`` context's device sync,
  garbage collection and cache release: it runs under the aggregator's
  lock. A device-wide sync would break it, so captures and
  ``TorchAggregator.block_until_ready`` take turns (``CAPTURE_LOCK``).
- Every step runs on the device's current stream, warm-up and replay
  alike: the kernels' scratch and barrier words are one set per device,
  so their launches must not overlap, and one stream orders them.
- All graphs of a device share one memory pool: they never run at the
  same time (the aggregator's lock orders the steps, and every replay goes
  to the device's current stream).
- A replay reads the addresses the capture saw, so the state's leaves must
  never be swapped, only written into (:mod:`zipkin_tpu_torch.tpu.ingest`).
  Each graph keeps the leaves' addresses and a replay against other
  addresses raises; the aggregator drops its graphs whenever its states are
  replaced (:meth:`StepGraphs.drop`).
- A replay adds to each kernel wrapper's ``launches`` the launches its
  graph holds (:func:`zipkin_tpu_torch.kernels.recording_launches`).
- Given the step's timeline record (:mod:`zipkin_tpu_torch.obs.device`), a
  step stamps its ``upload`` span (the staging into pinned memory and the
  copy's enqueue) and its ``replay`` span (the replay and the launch tally),
  and records the record's three events on the device's current stream:
  before the copy (after the staging), between the copy and the replay,
  and after the replay.
- A capture is the port's compile (the reference's jit cache growing): its
  owner's ``on_capture(variant, seconds, recompile)`` hears of each one.
  Once ``booted`` is set (the owner's boot captures are done) a capture
  that a step has to make, for a lane count nobody captured, is a
  recompile, as a shape the reference's warm-up missed compiles inside a
  request.

Only CUDA states are captured; on the CPU the aggregator runs the same
static-shape step eagerly. Nothing here runs the flight recorder; the
step's timeline record, when given, times the copy and the replay.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from zipkin_tpu_torch import kernels, u32
from zipkin_tpu_torch.obs.device import REPLAY, UPLOAD


class Captured(NamedTuple):
    graph: "torch.cuda.CUDAGraph"
    launches: Dict[object, int]  # kernel wrapper -> launches the graph holds
    leaves: Tuple[int, ...]  # the state leaves' addresses at capture


def addresses(state) -> Tuple[int, ...]:
    return tuple(t.data_ptr() for t in state)


def _end_failed_capture(graph) -> None:
    """Leave capture mode after the program raised inside it; the
    program's error is the one to report."""
    try:
        graph.capture_end()
    except RuntimeError:
        pass


# held from a capture's begin to its end, and by a device-wide sync
# (TorchAggregator.block_until_ready): a device sync while any stream of the
# process captures fails, breaks that capture and leaves its pool marked as
# recording, so every later capture into it fails too
CAPTURE_LOCK = threading.Lock()

# (device, variant, lanes, state shapes) already warmed in this process: the
# warm-up's first-use work is the process's, not one aggregator's
_warmed = set()
_warmed_lock = threading.Lock()


def _shapes(state) -> tuple:
    return tuple((tuple(t.shape), t.dtype) for t in state)


class StepGraphs:
    """The captured step programs of one aggregator, by (variant, lanes,
    shard)."""

    def __init__(self, on_capture: Optional[Callable[[tuple, float, bool], None]] = None) -> None:
        self._graphs: Dict[tuple, Captured] = {}
        self._inputs: Dict[tuple, torch.Tensor] = {}  # (lanes, shard) -> [11, lanes] int32
        self._pools: Dict[torch.device, object] = {}
        self._streams: Dict[torch.device, torch.cuda.Stream] = {}
        self._on_capture = on_capture
        self.booted = False  # the owner's boot captures are done
        self.captures = 0
        self.replays = 0
        self.warmups = 0

    def __len__(self) -> int:
        return len(self._graphs)

    def drop(self) -> None:
        """Forget every graph and input buffer (their pool goes with the
        last graph): the next step of each variant captures again."""
        self._graphs.clear()
        self._inputs.clear()
        self._pools.clear()

    def _input(self, lanes: int, shard: int, dev) -> torch.Tensor:
        buf = self._inputs.get((lanes, shard))
        if buf is None:
            buf = self._inputs[(lanes, shard)] = torch.zeros((11, lanes), dtype=torch.int32,
                                                             device=dev)
        return buf

    def step(self, variant, shard: int, state, wire: np.ndarray, program: Callable,
             rec=None) -> None:
        """Run ``program(state, bits)`` (one shard's step of ``variant``
        over the ``[11, lanes]`` int32 bits of ``wire``) on the state's
        card as a replay of its captured graph, captured first if this is
        the key's first batch. Writes the state's leaves in place. ``rec``:
        the step's timeline record, stamped and given its events."""
        dev = state.hll.device
        lanes = int(wire.shape[-1])
        buf = self._input(lanes, shard, dev)
        t_up = time.perf_counter_ns() if rec is not None else 0
        staged = u32.stage_bits(wire, dev)
        if rec is not None:
            rec.copy_begin(dev)
        buf.copy_(staged, non_blocking=True)
        if rec is not None:
            rec.copy_end()
            rec.span(UPLOAD, t_up, time.perf_counter_ns())
        key = (variant, lanes, shard)
        captured = self._graphs.get(key)
        if captured is None:
            captured = self.capture(variant, shard, state, lanes, program, in_step=True)
        elif captured.leaves != addresses(state):
            raise RuntimeError(f"step graph {key}: a state leaf was swapped for another tensor "
                               "since the capture (leaves must be written in place)")
        t_rep = time.perf_counter_ns() if rec is not None else 0
        captured.graph.replay()
        if rec is not None:
            rec.graph_end()
        kernels.add_launches(captured.launches)
        if rec is not None:
            rec.span(REPLAY, t_rep, time.perf_counter_ns())
        self.replays += 1

    def capture(self, variant, shard: int, state, lanes: int, program: Callable,
                in_step: bool = False) -> Captured:
        """Capture ``program``'s step of ``variant`` for ``state`` at
        ``lanes`` (or return the graph already captured), running nothing
        on ``state``; the first capture of its kind in the process warms
        up on a scratch copy of the state first. Raises if the capture
        fails, and keeps no graph then. ``in_step``: a step's batch asked
        for it (a recompile once booted)."""
        key = (variant, lanes, shard)
        if key in self._graphs:
            return self._graphs[key]
        t0 = time.perf_counter()
        dev = state.hll.device
        buf = self._input(lanes, shard, dev)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(dev):
            self._warm_up(variant, lanes, state, buf, program)
            side = self._streams.get(dev)
            if side is None:
                side = self._streams[dev] = torch.cuda.Stream(dev)
            pool = self._pools.get(dev)
            if pool is None:
                pool = self._pools[dev] = torch.cuda.graph_pool_handle()
            with CAPTURE_LOCK, kernels.recording_launches() as tally, torch.cuda.stream(side):
                graph.capture_begin(pool=pool, capture_error_mode="thread_local")
                try:
                    program(state, buf)
                except BaseException:
                    _end_failed_capture(graph)
                    raise
                graph.capture_end()
        captured = self._graphs[key] = Captured(graph, dict(tally), addresses(state))
        self.captures += 1
        if self._on_capture is not None:
            self._on_capture(variant, time.perf_counter() - t0, in_step and self.booted)
        return captured

    def _warm_up(self, variant, lanes: int, state, buf, program) -> None:
        mark = (state.hll.device, variant, lanes, _shapes(state))
        with _warmed_lock:
            if mark in _warmed:
                return
        scratch = type(state)(*(t.clone() for t in state))
        with kernels.warming_up():
            program(scratch, buf)
        del scratch
        with _warmed_lock:
            _warmed.add(mark)
        self.warmups += 1

    def pool_bytes(self) -> int:
        """Device bytes the graphs' pools hold (the allocator's segments of
        those pools)."""
        ids = {tuple(pool) for pool in self._pools.values()}
        if not ids:
            return 0
        return int(sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                       if tuple(seg.get("segment_pool_id", ())) in ids))

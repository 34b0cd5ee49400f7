"""A ``torch.profiler`` trace of a block of the window and its reduction:
the device's busy time (the union of its operations' intervals), the
operations that took most time, the kernels' own intervals, and the idle
gaps named by what the harness's threads were doing on the host then."""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

MARK = "portbench.mark"


class Trace:
    def __init__(self):
        self.prof = None
        self.t0 = self.t1 = None
        self._mark_host = None

    def warm(self) -> None:
        """One short trace at set-up, so the window's trace does not pay
        the profiler's first start."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()
        with record_function(MARK):
            self._mark_host = time.perf_counter()
        self.t0 = time.perf_counter()
        self._torch = torch

    def stop(self) -> None:
        """Wait for the card (the block's work is all in the trace), then
        close the trace."""
        self._torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)

    def summarize(self, host_spans: Sequence[tuple]) -> Optional[dict]:
        """None when the trace holds no device operation; else the block's
        ``window_s``, ``busy_s``, ``kernels`` [(name, start_us, end_us)],
        ``device_ops`` and ``idle_gaps`` ([name, seconds], 10 at most)."""
        events = self.prof.events()
        mark = [e for e in events if e.name == MARK]
        if not mark:
            return None
        offset = mark[0].time_range.start - self._mark_host * 1e6  # host s -> trace us
        lo, hi = self.t0 * 1e6 + offset, self.t1 * 1e6 + offset
        dev = [(e.name, max(e.time_range.start, lo), min(e.time_range.end, hi)) for e in events
               if str(getattr(e, "device_type", "")).endswith("CUDA")]
        dev = [d for d in dev if d[2] > d[1]]
        if not dev:
            return None
        busy = union(sorted((s, e) for _, s, e in dev))
        ops: Dict[str, float] = defaultdict(float)
        for name, s, e in dev:
            ops[name[:120]] += (e - s) / 1e6
        spans = [(label, a * 1e6 + offset, b * 1e6 + offset) for label, a, b in host_spans
                 if b * 1e6 + offset > lo and a * 1e6 + offset < hi]
        gaps: Dict[str, float] = defaultdict(float)
        prev = lo
        for s, e in busy + [(hi, hi)]:
            if s > prev:
                gaps[host_label(spans, 0.5 * (prev + s))] += (s - prev) / 1e6
            prev = max(prev, e)
        return {
            "window_s": (hi - lo) / 1e6,
            "busy_s": sum(e - s for s, e in busy) / 1e6,
            "kernels": sorted(dev, key=lambda d: d[1]),
            "device_ops": sorted(([k, v] for k, v in ops.items()), key=lambda r: -r[1])[:10],
            "idle_gaps": sorted(([k, v] for k, v in gaps.items()), key=lambda r: -r[1])[:10],
        }


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Sorted intervals merged where they overlap."""
    out: List[Tuple[float, float]] = []
    for s, e in intervals:
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def host_label(spans: Sequence[tuple], t: float) -> str:
    """What the harness was doing on the host at ``t``: a Lens read before
    the feed's calls, the feed's call before its waits."""
    found = [label for label, a, b in spans if a <= t < b]
    for prefix in ("read ", "feed call", "wait", "feed idle"):
        for label in found:
            if label.startswith(prefix):
                return label
    return "none of the harness's calls (Python between calls, GC, the window's edges)"

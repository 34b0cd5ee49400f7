"""The median device ms of a step that flushes the digests and folds the
ring's older half (the steps whose device work holds a ``link_chase``
launch), from the profiler: the union of the device's intervals between
the end of one step's ring append and the end of the next."""

import numpy as np

from portbench.trace import union

RING = "ring_append_tiles"
CHASE = "link_chase_kernel"


def read(ctx):
    t = ctx["trace"]
    if t is None:
        return None
    kernels = t["kernels"]
    ends = [e for name, _, e in kernels if RING in name]
    steps = []
    for a, b in zip(ends, ends[1:]):
        inside = [(s, e) for name, s, e in kernels if a < e <= b]
        if any(CHASE in name for name, s, e in kernels if a < e <= b):
            busy = union(sorted((max(s, a), e) for s, e in inside))
            steps.append(sum(e - s for s, e in busy) / 1e3)
    return float(np.median(steps)) if steps else None

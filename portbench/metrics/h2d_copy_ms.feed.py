"""The median device ms of a step's ``h2d_copy`` (the wire image's copy
to the card, 11 x 65,536 x 4 B a step) over the window's newest 1,024
ingest steps, from the program's step timeline (its CUDA events). None
where one of those steps ran under the profiler, or the program keeps no
timeline."""

import numpy as np

STEPS = 1024


def read(ctx):
    n = min(STEPS, len(ctx["ingest_call_s"]))
    if not n:
        return None
    try:
        from zipkin_tpu_torch.obs.device import step_timeline
    except ImportError:  # a program without the step timeline
        return None
    recs = step_timeline(n)
    if not recs or any(r["profiled"] for r in recs):
        return None
    ms = [(e - s) / 1e6 for r in recs for name, s, e in r["device"] if name == "h2d_copy"]
    return float(np.median(ms)) if ms else None

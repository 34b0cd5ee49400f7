"""The median host ms of the ``ingest`` span (the root:
``TorchAggregator.ingest`` from entry to return) over the window's newest
1,024 ingest steps, from the program's step timeline. None where one of
those steps ran under the profiler, or the program keeps no timeline."""

import numpy as np

STEPS = 1024
SPAN = "ingest"


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
    ms = [(s.end_ns - s.start_ns) / 1e6 for r in recs for s in r["spans"] if s.name == SPAN]
    return float(np.median(ms)) if ms else None

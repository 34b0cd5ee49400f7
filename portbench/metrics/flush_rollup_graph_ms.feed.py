"""The median device ms of the ``graph`` interval (from the copy's end to
the replay's end) of the steps that flush the digests and fold the ring
(the ``flush_rollup`` variant) among the window's newest 1,024 ingest
steps, from the program's step timeline (its CUDA events). None where one
of those steps ran under the profiler, or the program keeps no
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
    ms = [(e - s) / 1e6 for r in recs if r["variant"] == "flush_rollup"
          for name, s, e in r["device"] if name == "graph"]
    return float(np.median(ms)) if ms else None

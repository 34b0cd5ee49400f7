"""The share of the card's time in which it ran none of the window's
newest 1,024 ingest steps, from the program's step timeline (its CUDA
events on the host clock, not the profiler): 1 - the union of the steps'
``h2d_copy`` and ``graph`` intervals over the interval from the first
copy's start to the last graph's end, in percent. None where one of
those steps ran under the profiler, or the program keeps no timeline."""

STEPS = 1024


def read(ctx):
    n = min(STEPS, len(ctx["ingest_call_s"]))
    if not n:
        return None
    try:
        from zipkin_tpu_torch.obs.device import idle_gaps, step_timeline
    except ImportError:  # a program without the step timeline
        return None
    recs = step_timeline(n)
    if not recs or any(r["profiled"] for r in recs):
        return None
    gaps = idle_gaps(recs)
    return None if gaps is None else 100.0 * gaps["idle_share"]

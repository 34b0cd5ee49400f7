"""The median host ms of one ``store.agg.ingest`` call in the window: the
routing, the upload and the step graph's launch under the aggregator's
lock (the device runs the step after the call returns)."""

import numpy as np


def read(ctx):
    calls = ctx["ingest_call_s"]
    return float(np.median(calls)) * 1e3 if calls else None

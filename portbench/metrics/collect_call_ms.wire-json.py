"""The median host ms of one collector call in the window
(``Collector.accept_spans_bytes`` of one message, by the harness's clock):
the native parse and intern, the pack, the host archive's sample and the
aggregation tier's ingest (the device runs the step after the call
returns)."""

import numpy as np


def read(ctx):
    calls = ctx["ingest_call_s"]
    return float(np.median(calls)) * 1e3 if calls else None

"""The median host ms of the Lens dependency reads in the window, each
from its call to its answer (the store's lock wait and the fresh link
context included; the wait before its call, which the end-to-end tail
counts, left out)."""

import numpy as np


def read(ctx):
    ms = ctx["read_service_s"].get("deps") or []
    return float(np.median(ms)) * 1e3 if ms else None

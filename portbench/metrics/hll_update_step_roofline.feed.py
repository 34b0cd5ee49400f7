"""``hll_update_step``'s share of its roofline: the bytes the traced
steps' register updates must move (``roofline.hll_step_bytes``, the words
from the reference's registers before each step) over the kernel's own
profiler time, against the card's peak bandwidth."""

from portbench import roofline

KERNEL = "hll_step_kernel"


def read(ctx):
    t = ctx["trace"]
    if t is None:
        return None
    launches = [e - s for name, s, e in t["kernels"] if KERNEL in name]
    traffic = ctx["hll_traffic"][-len(launches):] if launches else []
    if not launches or len(traffic) != len(launches):
        return None
    nbytes = sum(roofline.hll_step_bytes(ctx["batch_spans"], words, written, ctx["timetier"])
                 for words, written in traffic)
    return roofline.share(nbytes, sum(launches) / 1e6)

"""``ring_append``'s share of its roofline: each traced step's append of
a full batch into the ring (``roofline.ring_append_bytes``) over the
kernel's own profiler time, against the card's peak bandwidth."""

from portbench import roofline

KERNEL = "ring_append_tiles"


def read(ctx):
    t = ctx["trace"]
    if t is None:
        return None
    launches = [e - s for name, s, e in t["kernels"] if KERNEL in name]
    if not launches:
        return None
    n = ctx["batch_spans"]
    src, dst = ctx["ring_lane_bytes"]
    return roofline.share(len(launches) * roofline.ring_append_bytes(n, n, src, dst),
                          sum(launches) / 1e6)

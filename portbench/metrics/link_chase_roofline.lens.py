"""``link_chase``'s share of its roofline: every traced chase (the fresh
dependency reads' link contexts and the folds) runs over the whole ring
(``roofline.link_chase_bytes``); over the kernel's own profiler time,
against the card's peak bandwidth."""

from portbench import roofline

KERNEL = "link_chase_kernel"


def read(ctx):
    t = ctx["trace"]
    if t is None:
        return None
    launches = [e - s for name, s, e in t["kernels"] if KERNEL in name]
    if not launches:
        return None
    return roofline.share(len(launches) * roofline.link_chase_bytes(ctx["ring_capacity"]),
                          sum(launches) / 1e6)

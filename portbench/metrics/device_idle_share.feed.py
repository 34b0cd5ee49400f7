"""The share of the traced block in which no operation ran on the card:
1 - (the union of the device's intervals / the block), in percent."""


def read(ctx):
    t = ctx["trace"]
    return None if t is None else 100.0 * (1.0 - t["busy_s"] / t["window_s"])

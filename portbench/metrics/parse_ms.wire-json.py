"""The mean host ms of the store's ``parse`` stage over the window, from
the program's flight recorder (``obs.RECORDER``, its sums and counts at
the window's open and close): the native parse of one message and the
intern of its names (``TorchStorage._fast_parse``). None where the
window recorded none."""

STAGE = "parse"


def read(ctx):
    count, us = ctx.get("stages", {}).get(STAGE, (0, 0))
    return us / count / 1e3 if count else None

"""The mean host ms of the store's ``pack`` stage over the window, from the
program's flight recorder (``obs.RECORDER``, its sums and counts at the
window's open and close): the pack of one message's parsed lanes into
the store's columns (``pack_parsed``). None where the window recorded
none."""

STAGE = "pack"


def read(ctx):
    count, us = ctx.get("stages", {}).get(STAGE, (0, 0))
    return us / count / 1e3 if count else None

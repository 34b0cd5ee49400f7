"""The mean host ms of the store's ``archive_write`` stage over the window,
from the program's flight recorder (``obs.RECORDER``, its sums and
counts at the window's open and close): the host archive's write of one
message: the 1-in-64 trace sample decoded and stored
(``TorchStorage._fast_dispatch``). None where the window recorded none."""

STAGE = "archive_write"


def read(ctx):
    count, us = ctx.get("stages", {}).get(STAGE, (0, 0))
    return us / count / 1e3 if count else None

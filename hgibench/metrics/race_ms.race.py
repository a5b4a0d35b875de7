"""Host ms a scene spends racing its tiles' coders: the program's span
``tiles.race``, one a block on the command's thread, around
``write_archive`` (the subband payload, the jobs handed to the coders'
pool, the wait for them, the smallest taken and framed).  Over the
window's served scenes, the one its close cut run to its end among them
(``spans.per_request_ms``)."""

from hgibench import spans


def read(ctx):
    return spans.per_request_ms(ctx, ("tiles.race",))

"""Host ms a scene spends copying its tiles' residual grids from the card
to the host: the program's span ``tiles.fetch`` (one copy of the whole
batch, 484 x 512 x 512 bytes).  Over the window's served scenes, the one
its close cut run to its end among them (``spans.per_request_ms``)."""

from hgibench import spans


def read(ctx):
    return spans.per_request_ms(ctx, ("tiles.fetch",))

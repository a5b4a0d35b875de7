"""Host ms a scene spends in DEFLATE's jobs, ``coder.deflate`` (two
strategies on each of two layouts a tile), summed over the threads of
the race's pool.  Over the window's served scenes, the one its close cut
run to its end among them (``spans.per_request_ms``)."""

from hgibench import spans


def read(ctx):
    return spans.per_request_ms(ctx, ("coder.deflate",))

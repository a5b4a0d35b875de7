"""How busy the race's pool of ``POOL`` coder threads is while the
command races a tile: the ``coder.*`` spans' time over ``POOL`` times the
``tiles.race`` time, in percent.  Near 100% the coders set the pace;
well below it, the command's own serial part (the payload, the wait, the
framing) does.  Both times are a served scene's (``spans.per_request_ms``),
so the count of scenes cancels."""

from hgibench import spans

POOL = 4  # threads of the program's candidate pool
CODERS = ("coder.deflate", "coder.rans", "coder.rans_mt", "coder.ctx", "coder.ctx_mt")


def read(ctx):
    coders = spans.per_request_ms(ctx, CODERS)
    race = spans.per_request_ms(ctx, ("tiles.race",))
    if coders is None or not race:
        return None
    return 100.0 * coders / (POOL * race)

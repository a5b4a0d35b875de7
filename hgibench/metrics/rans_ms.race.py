"""Host ms a scene spends in the host rANS's jobs, ``coder.rans`` (and
``coder.rans_mt``, whose payloads a 512 x 512 tile never reaches), summed
over the threads of the race's pool.  Over the window's served scenes,
the one its close cut run to its end among them
(``spans.per_request_ms``)."""

from hgibench import spans


def read(ctx):
    return spans.per_request_ms(ctx, ("coder.rans", "coder.rans_mt"))

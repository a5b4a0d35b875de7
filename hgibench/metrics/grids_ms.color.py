"""Host ms a pass over the suite spends coding its images' planes to
grids: the program's span ``color.grids``, one a transform (two an
image), around K1 on the three planes and the grids' copy to the host.
Over the window's served passes, the one its close cut run to its end
among them (``spans.per_request_ms``)."""

from hgibench import spans


def read(ctx):
    return spans.per_request_ms(ctx, ("color.grids",))

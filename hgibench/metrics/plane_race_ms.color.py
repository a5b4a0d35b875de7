"""Host ms a pass over the suite spends racing the host coders on whole
planes: the program's span ``color.plane``, one a plane of a transform
(six an image), around ``write_archive`` (the subband payload, the jobs
handed to the coders' pool, the wait for them, the smallest taken and
framed).  Over the window's served passes, the one its close cut run to
its end among them (``spans.per_request_ms``)."""

from hgibench import spans


def read(ctx):
    return spans.per_request_ms(ctx, ("color.plane",))

"""Host ms a pass over the suite spends reading its images: the program's
span ``cli.load`` (``load_rgb``: PIL decoding the PNG to RGB), one an
encode command, summed over the window's served passes, the one its
close cut run to its end among them (``spans.per_request_ms``)."""

from hgibench import spans


def read(ctx):
    return spans.per_request_ms(ctx, ("cli.load",))

"""GB/s of the program's span ``codec.h2d`` in the window: the bytes it
counts (the chunks of tiles copied from host memory to the card) over
its host seconds."""

from hgibench import spans


def read(ctx):
    records = spans.window_spans(ctx)
    if records is None:
        return None
    h2d = [s for s in records if s.name == "codec.h2d"]
    ns = sum(s.end_ns - s.start_ns for s in h2d)
    return sum(s.nbytes or 0 for s in h2d) / ns if ns else None

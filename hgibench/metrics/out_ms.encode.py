"""Host ms a scene spends in the program's span ``tiles.write``: the
command's write and flush of each block, and of the header, into its
output."""

from hgibench import spans


def read(ctx):
    return spans.per_request_ms(ctx, ("tiles.write",))

"""Host ms a scene spends in the program's span ``tiles.split``: the
command's ``tile_plane``, which cuts the plane into its padded tiles."""

from hgibench import spans


def read(ctx):
    return spans.per_request_ms(ctx, ("tiles.split",))

"""Host ms a scene spends in the program's span ``codec.h2d``:
``HGICodec._to_device`` copying each chunk of tiles from pageable host
memory to the card."""

from hgibench import spans


def read(ctx):
    return spans.per_request_ms(ctx, ("codec.h2d",))

"""Host ms a write request spends in ``HGICodec._to_device`` (the plane's
copy from pageable host memory to the card), the card synchronized at
its end."""


def read(ctx):
    return ctx.per_request_ms("h2d")

"""Host ms a scene spends in the command's image read,
``cli.load_luma`` (PIL opening the TIFF and converting it to luma)."""


def read(ctx):
    return ctx.per_request_ms("load")

"""Host ms a scene spends framing: the program's spans ``codec.frame``
(each tile's codec-7 payload and ``.thgi`` container, in
``write_fast_batch``) and ``tiles.frame`` (each block's length and
CRC32, in the command's loop)."""

from hgibench import spans


def read(ctx):
    return spans.per_request_ms(ctx, ("codec.frame", "tiles.frame"))

"""Host ms a read request spends in ``ops/tpurans.decode_bytes``, the
codec-7 payload decoded on the host by the native library."""


def read(ctx):
    return ctx.per_request_ms("rans_decode")

"""Host ms a request spends in the device coder's two fetches,
``ops/tpurans.fetch_heads`` (tables, word counts, states) and
``fetch_words`` (exactly the coded words), each ending in its copy to
the host."""


def read(ctx):
    return ctx.per_request_ms("fetch")

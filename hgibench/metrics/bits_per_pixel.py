"""Archive bytes written in the window, times 8, over their source
pixels: what storage users pay, and what keeps a gain in speed from
being bought with a weaker coder.  Taken by the harness from the bytes
the program returned."""


def read(ctx):
    pixels = sum(r.info.get("pixels", 0) for r in ctx.ok)
    return 8 * sum(r.info.get("bytes", 0) for r in ctx.ok) / pixels if pixels else None

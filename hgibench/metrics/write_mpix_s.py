"""Source megapixels whose archives were back on the host within the
window, over the window's seconds: all the work and all the time of the
window (the request that the window's close cut is left out)."""


def read(ctx):
    return sum(r.info["pixels"] for r in ctx.ok if r.end <= ctx.seconds) / ctx.seconds / 1e6

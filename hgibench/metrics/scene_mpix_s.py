"""Source megapixels whose blocks were written within the window, over the
window's seconds: all the work and all the time of the window (a scene
cut by the window's end counts the blocks that had left the command)."""


def read(ctx):
    return sum(r.info.get("pixels", 0) for r in ctx.ok) / ctx.seconds / 1e6

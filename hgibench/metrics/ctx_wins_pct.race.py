"""Percent of the tiles whose race the ctx coder won (codec 4, or 6),
read from the program's count of races won by (layout, codec),
``container.RACE_WINS``, around each request the window served, the one
its close cut run to its end.  A program without the count reads
nothing."""

CTX_CODECS = ("4", "6")


def read(ctx):
    wins = [r.info["wins"] for r in ctx.ok if "wins" in r.info]
    total = sum(n for w in wins for n in w.values())
    if not total:
        return None
    return 100.0 * sum(n for w in wins for k, n in w.items()
                       if k.split(".")[1] in CTX_CODECS) / total

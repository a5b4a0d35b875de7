"""Percent of the images whose container kept the green-delta transform,
read from the program's count of transforms kept, ``color.TRANSFORM_WINS``
(``gdelta``, ``identity``), around each pass the window served, the one
its close cut run to its end.  A program without the count reads
nothing."""


def read(ctx):
    wins = [r.info["transforms"] for r in ctx.ok if "transforms" in r.info]
    total = sum(n for w in wins for n in w.values())
    if not total:
        return None
    return 100.0 * sum(w.get("gdelta", 0) for w in wins) / total

"""Median host ms of one write call, HGICodec.write_fast(plane), from its start
to its result on the host.  Read in the traced run, whose timers
synchronize the card at the end of each timed function."""

import statistics


def read(ctx):
    service = [r.service for r in ctx.ok]
    return 1e3 * statistics.median(service) if service else None

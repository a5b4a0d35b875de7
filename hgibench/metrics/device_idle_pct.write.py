"""Percent of the profiled slice in which no kernel, copy or memset ran on
the card: one minus the union of the device records' intervals over the
slice's length."""


def read(ctx):
    r = ctx.reading
    return None if r is None else 100.0 * (1.0 - r.busy_s / r.window_s)

"""How busy the race's pool of coder threads is while the color command
races a plane: ``pool_busy_pct.race``'s reading (its ``POOL`` and
``CODERS``), with ``color.plane`` in place of ``tiles.race``.  Near 100%
the coders set the pace; well below it, the command's own serial part
(the payload, the wait, the framing) does, or one long job.  Both times
are a served pass's (``spans.per_request_ms``), so the count of passes
cancels."""

from hgibench import spans, spec


def read(ctx):
    race = spec.load_metric("pool_busy_pct.race")
    coders = spans.per_request_ms(ctx, race.CODERS)
    plane = spans.per_request_ms(ctx, ("color.plane",))
    if coders is None or not plane:
        return None
    return 100.0 * coders / (race.POOL * plane)

"""Ms a scene's ctx jobs (``coder.ctx``, ``coder.ctx_mt``) waited in the
race's pool for a thread: each span's ``queued_ns``, from the job's
hand-over (``profiling.carry``) to its start, both on the host clock,
summed over the window's spans and divided by the served scenes, the one
the close cut run to its end among them (as ``spans.per_request_ms``
counts them).  A program whose spans lack the field, or a window without
the spans, reads nothing rather than 0."""

from hgibench import spans

NAMES = ("coder.ctx", "coder.ctx_mt")


def read(ctx):
    named = [s for s in spans.window_spans(ctx) or () if s.name in NAMES]
    if not named or not ctx.ok or any(getattr(s, "queued_ns", None) is None for s in named):
        return None
    return sum(s.queued_ns for s in named) / 1e6 / len(ctx.ok)

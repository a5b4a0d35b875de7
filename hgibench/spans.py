"""The program's own spans, read in a traced run, and the profiled slice's
idle time split by them.

The program records a span at each stage of its scene path
(``rustyhgi_tpu_torch.utils.profiling.span``: ``cli.encode_tiled``, the
command, around ``cli.load``, ``tiles.split``, ``tiles.chunk``,
``codec.h2d``, ``codec.fetch_heads`` and the rest) on
``time.perf_counter_ns()``, the host clock of the window.  Importing this
module turns the program's recorder on; only the readers of a traced run
import it, after set-up, so an untraced run records nothing.  A program
without the recorder gives no span, and every reader of one reads
nothing.

The device records of the profiled slice are on the profiler's clock.
The harness's own ranges, ``hgibench.<label>`` in the slice, are calls
whose host-clock starts the timers hold (``Clock.calls``): matched in
order, their differences give the offset from one clock to the other.
"""

from __future__ import annotations

import bisect
import statistics
from typing import Dict, List, Optional, Sequence, Tuple

from . import stats

__all__ = ["CAPACITY", "MAX_OFFSET_SPREAD_S", "UNNAMED", "recorded", "window_spans",
           "per_request_ms", "offset_s", "split_gaps", "idle_by_span"]

CAPACITY = 1 << 17  # spans the ring keeps: a 20-s window makes about 35k
MAX_OFFSET_SPREAD_S = 1e-4  # the matched offsets' middle half may spread this much
UNNAMED = "unnamed"  # idle time no span below the command's covers

try:
    from rustyhgi_tpu_torch.utils import profiling as _profiling
except ImportError:  # no program: nothing is recorded, and nothing read
    _profiling = None
_ON = hasattr(_profiling, "enable_spans")
if _ON:
    _profiling.enable_spans(CAPACITY)


def recorded(since_ns: int) -> Optional[list]:
    """The recorder's spans that started at ``since_ns`` or later, or None
    without a recorder, or when the ring is full (its oldest spans, maybe
    of the window, are gone)."""
    if not _ON:
        return None
    if len(_profiling.spans()) >= CAPACITY:
        return None
    return _profiling.spans(since_ns)


def window_spans(ctx) -> Optional[list]:
    """The spans that started in the window, or None in a run with no
    kept slice (untraced, on the CPU, or every slice short of records):
    the span metrics come from the runs the device metrics come from."""
    if ctx.reading is None or not ctx.ok:
        return None
    return recorded(int(ctx.window.t0 * 1e9))


def per_request_ms(ctx, names: Sequence[str]) -> Optional[float]:
    """Host ms a served request of the window spent in the named spans, or
    None when none of them started in the window (a program that records
    other spans, or none there, reads nothing rather than 0 ms)."""
    records = window_spans(ctx)
    named = [s for s in records or () if s.name in names]
    if not named:
        return None
    return sum(s.end_ns - s.start_ns for s in named) / 1e6 / len(ctx.ok)


def offset_s(calls: Dict[str, List[Tuple[float, float]]],
             ranges: Sequence[Tuple[str, float, float]]) -> Optional[float]:
    """Host clock less profiler clock, from the harness's ranges in the
    slice (``(label, start, end)``) and its timers' calls (``{label:
    [(start, end), ...]}``).  The label with the most ranges is matched in
    order to the run of calls whose start differences agree best; every
    range is then paired with its label's call nearest that guess.  The
    median difference, or None without a range, or when the differences'
    quartiles lie more than ``MAX_OFFSET_SPREAD_S`` apart."""
    starts = {label: sorted(s for name, s, _ in ranges if name == label) for label in calls}
    hosts = {label: sorted(a for a, _ in c) for label, c in calls.items()}
    label = max(starts, key=lambda k: len(starts[k]), default=None)
    k = len(starts[label]) if label is not None else 0
    if not k or len(hosts[label]) < k:
        return None
    host, first = hosts[label], starts[label]
    best = min(([host[j + i] - first[i] for i in range(k)] for j in range(len(host) - k + 1)),
               key=lambda d: max(d) - min(d))
    guess = statistics.median(best)
    diffs = []
    for label, st in starts.items():
        host = hosts[label]
        for s in st:
            i = bisect.bisect_left(host, s + guess)
            near = min(host[max(0, i - 1) : i + 1], key=lambda a: abs(a - s - guess))
            diffs.append(near - s)
    if len(diffs) > 1:
        q1, _, q3 = statistics.quantiles(diffs, n=4)
        if q3 - q1 > MAX_OFFSET_SPREAD_S:
            return None
    return statistics.median(diffs)


def _innermost(records, offset: float, lo: float, hi: float) -> List[Tuple[float, float, str]]:
    """Sorted stretches ``(a, b, name)`` of ``[lo, hi]`` on the profiler's
    clock, each with the innermost span below an outermost one over it."""
    spans = []
    for s in records:
        a, b = s.start_ns / 1e9 - offset, s.end_ns / 1e9 - offset
        if s.parent is not None and b > lo and a < hi:
            spans.append((max(a, lo), min(b, hi), s.depth, s.name))
    spans.sort()
    bounds = sorted({t for a, b, _, _ in spans for t in (a, b)})
    out, active, i = [], [], 0
    for p, q in zip(bounds, bounds[1:]):
        while i < len(spans) and spans[i][0] <= p:
            active.append(spans[i])
            i += 1
        active = [s for s in active if s[1] > p]
        if active:
            out.append((p, q, max(active, key=lambda s: (s[2], s[0]))[3]))
    return out


def split_gaps(gaps: Sequence[Tuple[float, float]], stretches) -> Dict[str, float]:
    """Seconds of the gaps by the name of the stretch over each piece,
    ``UNNAMED`` where none is; both lists sorted, the stretches apart."""
    out: Dict[str, float] = {UNNAMED: 0.0}
    j = 0
    for a, b in gaps:
        while j < len(stretches) and stretches[j][1] <= a:
            j += 1
        covered, k = 0.0, j
        while k < len(stretches) and stretches[k][0] < b:
            p, q, name = stretches[k]
            piece = min(b, q) - max(a, p)
            if piece > 0:
                out[name] = out.get(name, 0.0) + piece
                covered += piece
            k += 1
        out[UNNAMED] += (b - a) - covered
    return out


def idle_by_span(ctx) -> Optional[Dict[str, float]]:
    """The kept slice's device-idle seconds by the innermost program span
    below the command's over each piece, ``UNNAMED`` for the rest; None
    without a span below an outermost one in the window, or when the
    clocks cannot be matched."""
    records = window_spans(ctx)
    if not any(s.parent is not None for s in records or ()) or ctx.clock is None:
        return None
    r = ctx.reading
    offset = offset_s(ctx.clock.calls, r.host)
    if offset is None:
        return None
    lo, hi = r.window
    gaps = stats.idle_gaps(((s, e) for _, s, e in r.device), lo, hi)
    return split_gaps(gaps, _innermost(records, offset, lo, hi))

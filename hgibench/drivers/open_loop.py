"""Open loop: requests arrive on a schedule, whatever the system does.

Independent clients send at the mix's ``rate_per_s``.  Every seed gets
the same ``round(rate * seconds)`` gaps, the quantiles of an exponential
distribution (Poisson arrivals) scaled to fill the window, in an order
drawn from the seed; the pool's items are drawn as often each, also in
the seed's order.  One worker serves the requests in arrival order, as a
process with one codec a card does; the queue is the harness's.  A
request's latency runs from its due time to its result on the host, so
a stall is charged to every request queued behind it.  Requests due in
the window that have not started a minute after it closed never come
and count as failed.  The times are kept in arrays made before the
window, so that the harness's records add no objects for the garbage
collector to scan while it runs.  The mix's ``warmup_s`` of the same
traffic (from another seed) runs first, unmeasured, as set-up.
"""

from __future__ import annotations

import time
import traceback

import numpy as np

from ..core import Request, Window, rng, wait_until

__all__ = ["schedule", "run"]

LATE_LIMIT_S = 60.0


def schedule(seed: int, rate: float, seconds: float, pool: int):
    """``(arrivals, items)``: due times in seconds from the window's start
    and pool indices, one of each a request."""
    n = max(1, int(round(rate * seconds)))
    q = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-q)
    r = rng(seed, 2)
    gaps = r.permutation(gaps) * (seconds / gaps.sum())
    arrivals = np.concatenate(([0.0], np.cumsum(gaps)[:-1]))
    items = r.permutation(np.resize(np.arange(pool), n))
    return arrivals, items


def _serve(entry, state, arrivals, items, keep, seconds, tracer):
    """Serve one schedule; returns the arrays of the requests' times."""
    n = len(arrivals)
    start, end = np.zeros(n), np.zeros(n)
    ok, sliced = np.zeros(n, bool), np.full(n, -1)
    nbytes, pixels = np.zeros(n, np.int64), np.zeros(n, np.int64)
    kept, errors = {}, []
    due_list, item_list = arrivals.tolist(), items.tolist()
    t0 = time.perf_counter()
    for i in range(n):
        current = tracer.tick(time.perf_counter() - t0) if tracer else None
        wait_until(t0 + due_list[i])
        start[i] = time.perf_counter() - t0
        if start[i] > seconds + LATE_LIMIT_S:
            start[i:] = end[i:] = start[i]
            errors.append(f"{n - i} requests never started")
            break
        try:
            out = entry.request(state, item_list[i])
            ok[i] = True
        except Exception:  # a failed request is counted, and the run goes on
            out = None
            if len(errors) < 3:
                errors.append(traceback.format_exc())
        end[i] = time.perf_counter() - t0
        if ok[i]:
            nbytes[i], pixels[i] = entry.account(state, item_list[i], out)
            if keep[i]:
                kept[i] = out
        if current is not None:
            sliced[i] = current
    if tracer:
        tracer.close()
    return t0, start, end, ok, sliced, nbytes, pixels, kept, errors


def run(entry, state, mix: dict, seed: int, seconds: float, tracer=None, log=print) -> Window:
    rate, pool = float(mix["rate_per_s"]), int(mix["pool"])
    warm = float(mix.get("warmup_s", 0))
    if warm > 0:  # the same traffic, unmeasured, so the window starts in a steady state
        arrivals, items = schedule(seed + 1, rate, warm, pool)
        _serve(entry, state, arrivals, items, np.zeros(len(arrivals), bool), warm, None)
    arrivals, items = schedule(seed, rate, seconds, pool)
    n = len(arrivals)
    keep = np.zeros(n, bool)
    keep[rng(seed, 3).choice(n, size=min(n, int(mix["sample"])), replace=False)] = True
    t0, start, end, ok, sliced, nbytes, pixels, kept, errors = _serve(
        entry, state, arrivals, items, keep, seconds, tracer)
    requests = [Request(i, int(items[i]), float(arrivals[i]), float(start[i]), float(end[i]),
                        bool(ok[i]), {"bytes": int(nbytes[i]), "pixels": int(pixels[i])},
                        None if sliced[i] < 0 else int(sliced[i])) for i in range(n)]
    service = end - start
    late = start - np.maximum(arrivals, np.concatenate(([0.0], end[:-1])))
    tenth = max(1, n // 10)
    log(f"open loop: {n} requests at {rate}/s over {seconds} s, last ended {end[-1]:.3f} s in; "
        f"service ms p50 {1e3 * np.median(service):.3f} (first tenth "
        f"{1e3 * np.median(service[:tenth]):.3f}, last {1e3 * np.median(service[-tenth:]):.3f}) "
        f"p99 {1e3 * np.quantile(service, 0.99):.3f} max {1e3 * service.max():.3f}; "
        f"generator late ms p50 {1e3 * np.median(late):.4f} p99 {1e3 * np.quantile(late, 0.99):.4f} "
        f"max {1e3 * late.max():.3f}")
    return Window(t0, seconds, requests, kept, errors)

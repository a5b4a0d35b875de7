"""Closed loop: one client sending its next request when the last one
returned, as a batch job or a ground station does.

The pool's items are taken in turn.  The mix's ``warmup_s`` of the same
loop runs first, unmeasured, as set-up.  The loop stops sending once the
window has closed; the request running then finishes and is checked, and
the metrics read which requests, or which part of one, ended inside the
window.  Where the entry has ``account``, each served request records its
bytes and pixels.  Where the mix gives ``sample``, the results kept for
the check are that many requests, a reservoir sample drawn from the
seed; otherwise every result is kept.  The process's CPU seconds are
read at the window's start and close (``WindowUsage``).
"""

from __future__ import annotations

import time
import traceback

import numpy as np

from ..core import Request, Window, WindowUsage, rng

__all__ = ["Reservoir", "run"]


class Reservoir:
    """A uniform sample of ``size`` of the results offered, in any number,
    drawn from the seed (Algorithm R): result ``i`` takes slot
    ``floor(u[i] * (i + 1))`` when that is below ``size``, ``u`` the seed's
    uniform numbers, so the same seed and the same count keep the same
    requests."""

    BLOCK = 1 << 16

    def __init__(self, size: int, seed: int):
        self.slots = [None] * int(size)
        self._rng, self._u = rng(seed, 3), np.empty(0)

    def offer(self, i: int, out) -> None:
        if i < len(self.slots):
            self.slots[i] = (i, out)
            return
        while i >= len(self._u):
            self._u = np.concatenate((self._u, self._rng.random(self.BLOCK)))
        j = int(self._u[i] * (i + 1))
        if j < len(self.slots):
            self.slots[j] = (i, out)

    @property
    def kept(self) -> dict:
        return dict(sorted(s for s in self.slots if s is not None))


def _loop(entry, state, pool: int, seconds: float, tracer, keep, account, usage=None):
    requests, errors = [], []
    t0 = time.perf_counter()
    if usage is not None:
        usage.start()
    i = 0
    while True:
        now = time.perf_counter() - t0
        current = tracer.tick(now) if tracer else None
        if now >= seconds:
            break
        item = i % pool
        start = time.perf_counter() - t0
        try:
            out = entry.request(state, item)
            ok = True
        except Exception:  # counted as failed; the loop goes on
            out, ok = None, False
            if len(errors) < 3:
                errors.append(traceback.format_exc())
        end = time.perf_counter() - t0
        info = {}
        if ok and account is not None:
            info["bytes"], info["pixels"] = account(state, item, out)
        requests.append(Request(i, item, start, start, end, ok, info, current))
        if ok and keep is not None:
            keep(i, out)
        i += 1
    if tracer:
        tracer.close()
    return t0, requests, errors


def run(entry, state, mix: dict, seed: int, seconds: float, tracer=None, log=print) -> Window:
    if int(mix.get("clients", 1)) != 1:
        raise ValueError("closed_loop drives one client")
    pool = int(mix["pool"])
    account = getattr(entry, "account", None)
    warm = float(mix.get("warmup_s", 0))
    if warm > 0:  # the same loop, unmeasured, so the window starts in a steady state
        _loop(entry, state, pool, warm, None, None, account)
    if "sample" in mix:
        reservoir = Reservoir(int(mix["sample"]), seed)
        keep = reservoir.offer
    else:
        reservoir, kept = None, {}
        keep = kept.__setitem__
    usage = WindowUsage(seconds)
    t0, requests, errors = _loop(entry, state, pool, seconds, tracer, keep, account, usage)
    if reservoir is not None:
        kept = reservoir.kept
    took = sorted(r.service for r in requests)
    log(f"closed loop: {len(requests)} requests over {seconds} s, last ended {requests[-1].end:.3f} "
        f"s in; request ms min {1e3 * took[0]:.3f} median {1e3 * took[len(took) // 2]:.3f} "
        f"max {1e3 * took[-1]:.3f}")
    return Window(t0, seconds, requests, kept, errors, usage.stop())

"""What a driver hands back, and the tracer it calls between requests."""

from __future__ import annotations

import resource
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

__all__ = ["Request", "Window", "WindowUsage", "Tracer", "rng", "usage", "wait_until"]


def rng(seed: int, stream: int) -> np.random.Generator:
    """The run's NumPy generator for one use (``stream``) of its seed."""
    return np.random.default_rng([int(seed) % (1 << 64), int(stream)])


SPIN_S = 0.003  # the last stretch before a due time is spun, not slept


def wait_until(t: float) -> None:
    """Sleep until ``SPIN_S`` before ``t`` on the host clock, then spin: a
    sleep may overshoot by a millisecond on a virtual machine."""
    left = t - time.perf_counter()
    if left > SPIN_S:
        time.sleep(left - SPIN_S)
    while time.perf_counter() < t:
        pass


def usage() -> Dict[str, float]:
    """CPU seconds (user, sys) of this process, every thread of it, and of
    the child processes it has reaped so far."""
    own = resource.getrusage(resource.RUSAGE_SELF)
    reaped = resource.getrusage(resource.RUSAGE_CHILDREN)
    return {"user_s": own.ru_utime + reaped.ru_utime, "sys_s": own.ru_stime + reaped.ru_stime}


class WindowUsage:
    """:func:`usage` over a window: read at its start and, by a timer
    thread, at its close, ``seconds`` later, while the request cut by the
    close still runs.  A child reaped after the close, as the output's
    drain and the check's workers are, stays out."""

    def __init__(self, seconds: float):
        self.seconds = seconds

    def start(self) -> None:
        self.t0 = time.perf_counter()
        self.first = usage()
        self._timer = threading.Timer(self.seconds, self._close)
        self._timer.daemon = True
        self._timer.start()

    def _close(self) -> None:
        self.last = usage()
        self.read_at_s = time.perf_counter() - self.t0

    def stop(self) -> Dict[str, float]:
        """The window's deltas, and ``read_at_s``, when the close was read;
        waits for the timer."""
        self._timer.join()
        out = {k: self.last[k] - self.first[k] for k in self.first}
        out["read_at_s"] = self.read_at_s
        return out


@dataclass
class Request:
    index: int
    item: int
    due: float  # seconds from the window's start
    start: float
    end: float
    ok: bool
    info: Dict[str, Any] = field(default_factory=dict)
    slice: Optional[int] = None  # the profiled slice it ran in

    @property
    def latency(self) -> float:
        return self.end - self.due

    @property
    def service(self) -> float:
        return self.end - self.start


@dataclass
class Window:
    """A measured window: ``t0`` on the host clock, its length, every
    request due in it (times relative to ``t0``), the results kept for
    the check, by request index, and where the closed loop reads it, the
    process's :class:`WindowUsage` deltas."""

    t0: float
    seconds: float
    requests: List[Request]
    kept: Dict[int, Any]
    errors: List[str] = field(default_factory=list)
    usage: Optional[Dict[str, float]] = None

    @property
    def attempted(self) -> int:
        return len(self.requests)

    @property
    def failed(self) -> int:
        return sum(not r.ok for r in self.requests)


class Tracer:
    """Profiles slices of ``length`` seconds, the first starting ``start``
    seconds into the window and each next one ``length`` seconds after the
    previous ended, up to ``count``, until one holds a kernel record for
    every launch the program counted (``expected``, as for
    :meth:`trace.Reading.complete`).  ``tick`` is called between requests
    with the time into the window; it returns the index of the slice
    running, or None.  Reading a slice takes seconds of the traced run's
    window, whose latencies no metric reads."""

    def __init__(self, counters, expected, start: float, length: float, count: int = 3, log=print):
        from .trace import Slice

        self.counters, self.expected, self.log = counters, expected, log
        self.start, self.length, self.count = start, length, count
        self.k = 0
        self.current = None
        self.running: Optional[float] = None
        self.reading = self.last = None
        self.index: Optional[int] = None
        self._slice = Slice

    def tick(self, now: float) -> Optional[int]:
        if self.running is not None and now >= self.running + self.length:
            self._stop()
        if self.running is None and self.reading is None and self.k < self.count:
            if now >= self.start + self.k * 2 * self.length:
                t = time.perf_counter()
                self.current = self._slice(self.counters)
                self.current.start()
                self.running = now + (time.perf_counter() - t)
        return self.k if self.running is not None else None

    def _stop(self) -> None:
        self.current.stop()
        reading = self.last = self.current.read()
        missing = reading.complete(self.expected)
        self.log(f"trace slice {self.k}: {reading.window_s if reading.window else 0:.3f} s, "
                 f"launches {reading.launched}, device records {reading.names()}"
                 + (f"; not read: {missing}" if missing else ""))
        if not missing:
            self.reading, self.index = reading, self.k
        self.current = self.running = None
        self.k += 1

    def close(self) -> None:
        if self.running is not None:
            self._stop()

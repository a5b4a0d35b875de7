"""Profiled slices of a traced run, and what is read from them.

A slice is a stretch of the window, between two requests, under
``torch.profiler`` with the card's activity.  The launch counters of the
program are read at both ends of it: a slice whose kernel records fall
short of what the counters say were launched has lost records, and
nothing is read from it (:meth:`Reading.complete`).  A run profiles a few
slices and keeps the first complete one.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from . import stats

__all__ = ["Slice", "Reading", "short_name"]


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespace, template and
    arguments; a copy's or a memset's name without its details."""
    if name.startswith(("Memcpy", "Memset")):
        return name.split(" (")[0]
    words = name.replace("(anonymous namespace)::", "").split("(")[0].split("<")[0].split()
    return words[-1].split("::")[-1] if words else name[:60]


class Slice:
    """One profiled stretch; ``counters`` is ``{name: (module, attribute)}``."""

    def __init__(self, counters: Dict[str, Tuple[object, str]]):
        self.counters = counters
        self.prof = None
        self._range = None
        self.before: Dict[str, int] = {}
        self.launched: Dict[str, int] = {}

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.before = {k: getattr(m, a) for k, (m, a) in self.counters.items()}
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.start()
        self._range = torch.profiler.record_function("hgibench.slice")
        self._range.__enter__()

    def stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        self._range.__exit__(None, None, None)
        self.prof.stop()
        self.launched = {k: getattr(m, a) - self.before[k] for k, (m, a) in self.counters.items()}

    def read(self) -> "Reading":
        from torch.autograd import DeviceType

        device, host, window = [], [], None
        for e in self.prof.events():
            start, end = e.time_range.start / 1e6, e.time_range.end / 1e6
            if e.device_type == DeviceType.CUDA:
                if not e.name.startswith("hgibench."):  # a range's mark on the card's row
                    device.append((e.name, start, end))
            elif e.name == "hgibench.slice":
                window = (start, end)
            elif e.name.startswith("hgibench."):
                host.append((e.name[len("hgibench."):], start, end))
        self.prof = None  # the trace's memory goes with it
        return Reading(device, host, window, self.launched)


class Reading:
    """Device records ``(name, start, end)`` in seconds, the harness's host
    ranges, the slice's bounds on the profiler's clock, and the launches
    the program counted in it."""

    def __init__(self, device, host, window, launched):
        self.device = device
        self.host = host
        self.window = window
        self.launched = launched

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def records(self, names: Sequence[str]) -> List[Tuple[str, float, float]]:
        return [r for r in self.device if short_name(r[0]) in names]

    def device_seconds(self, names: Sequence[str]) -> float:
        return sum(e - s for _, s, e in self.records(names))

    def complete(self, expected: Dict[str, Tuple[Sequence[str], int]]) -> Optional[str]:
        """None when every counter's launches have their kernel records
        (``{counter: (kernel names, records a launch)}``), else what is
        missing."""
        if self.window is None:
            return "no slice range in the trace"
        if not self.device:
            return "no device record"
        for counter, (names, per_launch) in expected.items():
            if not self.launched.get(counter):
                return f"{counter}: no launch in the slice"
            want = self.launched[counter] * per_launch
            got = len(self.records(names))
            if got != want:
                return f"{counter}: {got} kernel records for {want} expected"
        return None

    def names(self) -> Dict[str, int]:
        """Device records by short name."""
        out: Dict[str, int] = {}
        for name, _, _ in self.device:
            out[short_name(name)] = out.get(short_name(name), 0) + 1
        return out

    @property
    def busy_s(self) -> float:
        return stats.union_seconds(((s, e) for _, s, e in self.device), *self.window)

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle time by
        the harness range the host was in (the innermost one at each gap's
        middle)."""
        ops: Dict[str, float] = {}
        for name, s, e in self.device:
            key = short_name(name)
            ops[key] = ops.get(key, 0.0) + (e - s)
        idle: Dict[str, float] = {}
        gaps = stats.idle_gaps(((s, e) for _, s, e in self.device), *self.window)
        for a, b in gaps:
            mid = (a + b) / 2
            inside = [(e - s, name) for name, s, e in self.host if s <= mid < e]
            key = min(inside)[1] if inside else "between requests"
            idle[key] = idle.get(key, 0.0) + (b - a)
        order = lambda d: sorted(([k, v] for k, v in d.items()), key=lambda kv: -kv[1])[:top]
        return {"device_ops": order(ops), "idle_gaps": order(idle)}

"""Host time spent in named functions of the program, in a traced run.

A frozen copy of the idea of ``rustyhgi_tpu_torch.utils.profiling.
stage_clock``: each target, an attribute of a module or class, is
replaced by a wrapper for the length of a ``with`` block.  The wrapper
synchronizes the card at the end of the call, so that the work the call
queued is charged to it, marks the call as a ``torch.profiler`` range
named by its label, and keeps the call's start and end on the host clock.
Code that looks the name up when it calls it passes through the wrapper.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Sequence, Tuple

__all__ = ["Clock"]


class Clock:
    """``Clock({label: [(owner, attribute), ...]}, sync)``; after the block,
    ``calls[label]`` lists the ``(start, end)`` of each call."""

    def __init__(self, targets: Dict[str, Sequence[Tuple[object, str]]], sync: Callable[[], None]):
        self.targets = targets
        self.sync = sync
        self.calls: Dict[str, List[Tuple[float, float]]] = {label: [] for label in targets}
        self._saved = []

    def _wrap(self, label: str, fn):
        import torch

        calls, sync = self.calls[label], self.sync

        def call(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                with torch.profiler.record_function(f"hgibench.{label}"):
                    out = fn(*args, **kwargs)
                    sync()
                return out
            finally:
                calls.append((t0, time.perf_counter()))

        return call

    def __enter__(self):
        for label, places in self.targets.items():
            for owner, attr in places:
                fn = owner.__dict__[attr] if isinstance(owner, type) else getattr(owner, attr)
                self._saved.append((owner, attr, fn))
                setattr(owner, attr, self._wrap(label, fn))
        return self

    def __exit__(self, *exc):
        for owner, attr, fn in reversed(self._saved):
            setattr(owner, attr, fn)
        self._saved.clear()
        return False

    def seconds(self, label: str, since: float = float("-inf")) -> float:
        """Host seconds of the label's calls that started at ``since`` or
        later on the host clock (the window's start leaves out warm-up)."""
        return sum(b - a for a, b in self.calls[label] if a >= since)

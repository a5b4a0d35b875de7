"""Tracing, stage timing, and distortion and size metrics.

Counterpart of ``rustyhgi_tpu/utils/profiling.py``:

* :func:`trace` captures a ``torch.profiler`` trace (host, and the card's
  kernels and copies on ``cuda``) around any codec region and writes it
  into a directory as a Chrome trace (Perfetto, ``chrome://tracing``);
* :class:`StageTimer` accumulates named stage times and derives rates,
  with the JAX class's API, report and printout; :func:`stage_clock`
  times named functions of other modules while a block runs;
* :func:`codec_metrics` and :func:`psnr`, the metric set of a roundtrip.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

__all__ = ["trace", "StageTimer", "stage_clock", "codec_metrics", "psnr"]


@contextlib.contextmanager
def trace(log_dir: Optional[str], device: str = "cuda"):
    """Capture a host (and, on ``cuda``, device) profiler trace into
    ``log_dir``, as ``trace_<pid>_<ns>.json``; ``log_dir=None`` writes no
    file.  Yields the profiler, whose ``key_averages()`` sum the time by
    operator and by kernel.  Usage::

        with trace("/tmp/hgi-trace"):
            codec.encode_plane(batch)

    ``device="cuda"`` without a card raises: it never traces the host alone
    in its place.
    """
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("trace on cuda requested but CUDA is not available")
        activities.append(ProfilerActivity.CUDA)
    if log_dir is not None:
        os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if ProfilerActivity.CUDA in activities:
            torch.cuda.synchronize()
    if log_dir is not None:
        prof.export_chrome_trace(
            os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
        )


def _sync() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


class StageTimer:
    """Accumulates named stage durations and derives throughputs.

    Unlike the JAX class, a stage holds its device time: once the process
    has run CUDA work, :meth:`stage` synchronises the card when the stage
    starts and again before it reads the clock at its end, so queued
    kernels are charged to the stage that launched them.
    """

    def __init__(self) -> None:
        self.seconds: Dict[str, float] = {}
        self.items: Dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str, items: Optional[float] = None):
        """Time a stage; ``items`` is the unit count (pixels, bytes...)."""
        _sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _sync()
            dt = time.perf_counter() - t0
            self.seconds[name] = self.seconds.get(name, 0.0) + dt
            if items is not None:
                self.items[name] = self.items.get(name, 0.0) + items

    def report(self) -> Dict[str, Dict[str, float]]:
        out: Dict[str, Dict[str, float]] = {}
        for name, sec in self.seconds.items():
            entry = {"seconds": sec}
            if name in self.items and sec > 0:
                entry["items_per_s"] = self.items[name] / sec
            out[name] = entry
        return out

    def __str__(self) -> str:
        lines = []
        for name, e in self.report().items():
            rate = (
                f"  {e['items_per_s'] / 1e6:10.1f} M/s"
                if "items_per_s" in e
                else ""
            )
            lines.append(f"{name:<24} {e['seconds'] * 1e3:9.2f} ms{rate}")
        return "\n".join(lines)


@contextlib.contextmanager
def stage_clock(targets: Dict[str, tuple]):
    """Host seconds spent in each of ``targets`` ({label: (module,
    attribute)}) while the block runs: each attribute is wrapped in a
    timer, then put back.  Code that looks the names up when it calls
    them (a module's own globals, or names imported inside a function)
    passes through the timers.  Yields ``{label: seconds}``."""
    spent = {label: 0.0 for label in targets}
    saved = {label: getattr(module, attr) for label, (module, attr) in targets.items()}

    def timed(label, fn):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                spent[label] += time.perf_counter() - t0
        return call

    for label, (module, attr) in targets.items():
        setattr(module, attr, timed(label, saved[label]))
    try:
        yield spent
    finally:
        for label, (module, attr) in targets.items():
            setattr(module, attr, saved[label])


def psnr(original: np.ndarray, decoded: np.ndarray) -> float:
    """Peak signal-to-noise ratio in dB (inf for identical planes)."""
    diff = original.astype(np.float64) - decoded.astype(np.float64)
    mse = float(np.mean(diff * diff))
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(255.0**2 / mse)


def codec_metrics(
    original: np.ndarray,
    decoded: np.ndarray,
    compressed_bytes: int,
) -> Dict[str, float]:
    """Structured distortion/size metrics for one roundtrip.

    ``sd`` follows the reference's convention (main.rs:105-111): integer
    mean of squared diffs, then sqrt.
    """
    original = np.asarray(original)
    decoded = np.asarray(decoded)
    diff = original.astype(np.int64) - decoded.astype(np.int64)
    n = original.size
    sd_int = int((diff * diff).sum()) // n if n else 0
    return {
        "uncompressed": n,
        "compressed": compressed_bytes,
        "ratio": n / compressed_bytes if compressed_bytes else float("inf"),
        "sd": float(np.sqrt(sd_int)),
        "psnr_db": psnr(original, decoded),
        "max_error": int(np.abs(diff).max()) if n else 0,
    }

"""Tracing, stage timing, and distortion and size metrics.

Counterpart of ``rustyhgi_tpu/utils/profiling.py``:

* :func:`trace` captures a ``torch.profiler`` trace (host, and the card's
  kernels and copies on ``cuda``) around any codec region and writes it
  into a directory as a Chrome trace (Perfetto, ``chrome://tracing``),
  the program's spans shown over the kernels;
* :func:`span` marks a stage of the program (the tiled loop, the codec's
  copies, launches, fetches and framing, the ``.thgi`` race and its
  coders); :func:`enable_spans` keeps the spans in a bounded ring that
  :func:`spans` reads, with the bytes each moved, :func:`carry` runs a
  job handed to a thread pool under the span that handed it over, its
  wait for a thread recorded, and
  :func:`self_ns` gives each span's self time;
* :func:`device_averages` reads a trace's kernels, copies and memsets
  on the card, without the spans' marks there;
* :func:`device_samples` times calls with CUDA events, the L2 cache
  flushed before each (the host clock on the CPU), and
  :func:`device_trace` reads one call's device time by record name, and
  the records it makes, from ``torch.profiler``; :func:`kernel_launches`
  counts the kernels among them;
* :class:`StageTimer` accumulates named stage times and derives rates,
  with the JAX class's API, report and printout; :func:`stage_clock`
  times named functions of other modules while a block runs;
* :func:`codec_metrics` and :func:`psnr`, the metric set of a roundtrip.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import sys
import threading
import time
from typing import Callable, Dict, Iterable, List, NamedTuple, Optional

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

__all__ = [
    "trace", "device_averages", "device_samples", "device_trace", "kernel_launches", "DeviceTime",
    "host_samples", "require_device", "span", "carry", "enable_spans", "disable_spans", "spans",
    "self_ns", "Span",
    "StageTimer", "stage_clock", "codec_metrics", "psnr",
]

SPAN_CAPACITY = 65536  # spans the ring keeps by default; a scene makes about 1.1k
_FLUSH_BYTES = 64 << 20  # above the H100's 50 MB L2
TRACE_ATTEMPTS = 6  # takes of a trace that dropped records

# The recorder's state.  ``_active`` is the one flag :func:`span` reads: a
# ring is kept or a trace() block runs.
_ring: Optional[collections.deque] = None
_tracing = 0
_active = False
_ids = itertools.count(1)
_open = threading.local()  # each thread's stack of open spans


def _refresh() -> None:
    global _active
    _active = _ring is not None or _tracing > 0


class Span:
    """A stage of the program: ``name`` (``layer.stage``), ``start_ns`` and
    ``end_ns`` on ``time.perf_counter_ns()``, the ``id`` of the span it
    ran in (``parent``, None for an outermost span) and of the outermost
    one (``request``: the spans of one command share it), its ``depth``
    below that, whether it ran on another thread than its request's
    outermost span (``thread``: a job :func:`carry` handed to a pool), and
    the bytes it moved (``nbytes``, None when it counts none; the code may
    set it inside the block).

    ``queued_ns`` is, for a span opened directly on a carried job's base,
    the time from :func:`carry` to the span's start, which is how long the
    job waited for a thread where the caller submits it straight after
    ``carry`` (``write_thgi`` does, to within microseconds); None for
    every other span."""

    __slots__ = ("id", "name", "parent", "request", "depth", "thread", "start_ns", "end_ns",
                 "queued_ns", "nbytes", "_range")

    def __init__(self, name: str, nbytes: Optional[int] = None):
        self.name, self.nbytes = name, nbytes
        self._range = None

    def __enter__(self) -> "Span":
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        self.id = next(_ids)
        carried = None
        if stack:
            top = stack[-1]
            self.parent, self.request = top.id, top.request
            self.depth, self.thread = top.depth + 1, top.thread
            if type(top) is _Carried:
                carried = top
        else:
            self.parent, self.request, self.depth, self.thread = None, self.id, 0, False
        stack.append(self)
        if _tracing:
            self._range = torch.profiler.record_function(f"hgi.{self.name}")
            self._range.__enter__()
        self.start_ns = time.perf_counter_ns()
        self.queued_ns = None if carried is None else self.start_ns - carried.submitted_ns
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.perf_counter_ns()
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        _open.stack.pop()
        ring = _ring
        if ring is not None:
            ring.append(self)
        return False


class _NoSpan:
    """The shared context :func:`span` returns while nothing records: it
    does nothing, and drops the bytes the code sets on it."""

    __slots__ = ()

    def __enter__(self) -> "_NoSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    @property
    def nbytes(self) -> None:
        return None

    @nbytes.setter
    def nbytes(self, value) -> None:
        pass


_NO_SPAN = _NoSpan()


def span(name: str, nbytes: Optional[int] = None):
    """A context that records the block as the :class:`Span` ``name``,
    with the bytes it moved (``nbytes``, or set on the span inside the
    block).  While no ring is kept and no :func:`trace` runs it is one
    shared context that does nothing.  Inside :func:`trace`, and only
    there, the span is also a ``torch.profiler`` range ``hgi.<name>``."""
    if not _active:
        return _NO_SPAN
    return Span(name, nbytes)


class _Carried:
    """The submitter's open span as a pool thread's base: what a span
    opened on that thread takes from its parent, and when the job was
    handed over (``submitted_ns``, on ``time.perf_counter_ns()``)."""

    __slots__ = ("id", "request", "depth", "thread", "submitted_ns")

    def __init__(self, top: Span):
        self.id, self.request, self.depth, self.thread = top.id, top.request, top.depth, True
        self.submitted_ns = time.perf_counter_ns()


def carry(fn):
    """``fn`` to hand to a thread pool: run there, its spans have the span
    open here as their parent, this command's request, and ``thread``
    True, and those opened directly on it their wait since this call
    (``Span.queued_ns``).  While no span records, or outside any span, it
    is ``fn`` itself, so the submit costs one flag check."""
    if not _active:
        return fn
    stack = getattr(_open, "stack", None)
    if not stack:
        return fn
    base = _Carried(stack[-1])

    def carried(*args, **kwargs):
        saved = getattr(_open, "stack", None)
        _open.stack = [base]
        try:
            return fn(*args, **kwargs)
        finally:
            _open.stack = saved

    return carried


def enable_spans(capacity: int = SPAN_CAPACITY) -> None:
    """Keep the finished spans of every thread in a ring of ``capacity``
    (the oldest go first); a new ring replaces the old one."""
    global _ring
    if capacity < 1:
        raise ValueError(f"capacity must be at least 1, got {capacity}")
    _ring = collections.deque(maxlen=capacity)
    _refresh()


def disable_spans() -> None:
    """Stop keeping spans and drop the ring."""
    global _ring
    _ring = None
    _refresh()


def spans(since_ns: Optional[int] = None) -> List[Span]:
    """The ring's spans in the order they ended (empty while it is off),
    those that started at ``since_ns`` or later when it is given."""
    kept = list(_ring) if _ring is not None else []
    if since_ns is None:
        return kept
    return [s for s in kept if s.start_ns >= since_ns]


def self_ns(records: Iterable[Span]) -> Dict[int, int]:
    """Each span's self time by id: its duration less the union of its
    children's intervals among ``records``, each cut to the span's own.
    Children on pool threads (:func:`carry`) overlap one another; time in
    which any child ran is not the span's own."""
    records = list(records)
    ids = {s.id for s in records}
    children: Dict[int, list] = {}
    for s in records:
        if s.parent in ids:
            children.setdefault(s.parent, []).append((s.start_ns, s.end_ns))
    out = {}
    for s in records:
        covered, reach = 0, s.start_ns
        for a, b in sorted(children.get(s.id, ())):
            a, b = max(a, reach), min(b, s.end_ns)
            if b > a:
                covered += b - a
                reach = b
        out[s.id] = s.end_ns - s.start_ns - covered
    return out


@contextlib.contextmanager
def trace(log_dir: Optional[str], device: str = "cuda"):
    """Capture a host (and, on ``cuda``, device) profiler trace into
    ``log_dir``, as ``trace_<pid>_<ns>.json``; ``log_dir=None`` writes no
    file.  Yields the profiler, whose ``key_averages()`` sum the time by
    operator and by kernel.  Usage::

        with trace("/tmp/hgi-trace"):
            codec.encode_plane(batch)

    ``device="cuda"`` without a card raises: it never traces the host alone
    in its place.  Inside the block every :func:`span` is also a range
    ``hgi.<name>``, so the trace shows the program's stages over the
    kernels.
    """
    global _tracing
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("trace on cuda requested but CUDA is not available")
        activities.append(ProfilerActivity.CUDA)
    if log_dir is not None:
        os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        _tracing += 1
        _refresh()
        try:
            yield prof
            if ProfilerActivity.CUDA in activities:
                torch.cuda.synchronize()
        finally:
            _tracing -= 1
            _refresh()
    if log_dir is not None:
        prof.export_chrome_trace(
            os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
        )


def _sync() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def device_averages(prof) -> list:
    """The card's records of a :func:`trace`, summed by name
    (``prof.key_averages()`` on the card with self time): its kernels,
    copies and memsets.  A span's range inside the trace leaves a mark on
    the card's row whose self time is the whole range; those marks are
    left out, so the sum is the work the card did."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False) and not e.key.startswith("hgi.")]


def host_samples(fn: Callable[[], object], iters: int) -> list:
    """Seconds of ``iters`` calls of ``fn`` on the host clock."""
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return ts


def require_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; "
            "pass device='cpu' to time the plain PyTorch version on the host"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {str(dev)!r}")
    return dev


def device_samples(fn: Callable[[], object], iters: int, device) -> list:
    """Seconds of ``iters`` calls of ``fn`` after one warm-up call.

    On a CUDA device each call is timed by CUDA events on the current
    stream, with the L2 cache flushed before it; on the CPU by the host
    clock.
    """
    dev = require_device(device)
    fn()
    if dev.type != "cuda":
        return host_samples(fn, iters)
    flush = torch.empty(_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    times = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 1e3)
    return times


class DeviceTime(NamedTuple):
    """One record name's share of a call in :func:`device_trace`."""

    seconds: float  # device seconds a call
    count: int  # records a call: the launches, for a kernel


def device_trace(fn: Callable[[], object], repeats: int = 7) -> Dict[str, DeviceTime]:
    """One call of ``fn`` on the card by record name (kernel, copy or
    memset): ``repeats`` calls after a warm-up under :func:`trace`, summed
    by :func:`device_averages` and divided by ``repeats``.  Empty without
    a card, or when every take dropped records.

    ``torch.profiler`` drops device records late in a process, once a
    trace has held tens of thousands of them, and at random early, a whole
    trace empty at times.  Every call launches the same work, so a trace
    in which some name's count is no multiple of ``repeats`` dropped
    records: it is taken again, ``TRACE_ATTEMPTS`` times at most.  (A drop
    that leaves every count a multiple passes.)
    """
    if not torch.cuda.is_available():
        return {}
    fn()
    torch.cuda.synchronize()
    for attempt in range(TRACE_ATTEMPTS):
        with trace(None, "cuda") as prof:
            for _ in range(repeats):
                fn()
        events = device_averages(prof)
        counts = {e.key: e.count for e in events}
        if counts and all(c % repeats == 0 for c in counts.values()):
            return {e.key: DeviceTime(e.self_device_time_total / repeats / 1e6,
                                      e.count // repeats) for e in events}
        print(f"WARNING: the trace dropped device records (counts {counts}, {repeats} calls); "
              f"take {attempt + 1}/{TRACE_ATTEMPTS}", file=sys.stderr, flush=True)
    return {}


def kernel_launches(records: Dict[str, DeviceTime]) -> Optional[int]:
    """The device kernels one call launches, from :func:`device_trace`'s
    records, copies and memsets not counted; None when there are none."""
    if not records:
        return None
    return sum(r.count for name, r in records.items()
               if "Memcpy" not in name and "Memset" not in name)


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

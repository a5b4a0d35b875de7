"""Run one cell of the benchmark once.

    python -m hgibench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, this folder and
the program, ``rustyhgi_tpu_torch``, on a machine with the CUDA cards the
cell asks for.  The run builds its inputs from the seed and warms up
(set-up), serves the cell's traffic for ``--seconds`` (the window), checks
what the program returned against the plain reference in
``hgibench/reference``, and prints one JSON line last on standard output:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` a ``breakdown``, where the closed loop
reads it ``usage`` (the process's CPU seconds, user and sys, over the
window), and last ``checks``, each number compared with its limit, which
also end standard error.

Without CUDA, or with fewer cards than the cell asks for, it exits 2 and
prints no result; with JAX or the JAX package loaded once the window has
closed, it exits 3.  It ignores ``BENCH_RUN``.  Build and kernel caches
stay inside the checkout: the program builds its kernels in ``build/``
and ``native/``, and ``TRITON_CACHE_DIR`` and ``TORCH_EXTENSIONS_DIR``
point into ``build/hgibench/``.  Scene files go under ``TMPDIR`` and are
removed at the end.

This module imports only the standard library at its top, so that the
worker processes of the check, which start from a fresh interpreter,
import nothing of the program.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

__all__ = ["main", "run_cell", "JAX_NAMES"]

JAX_NAMES = ("jax", "jaxlib", "flax", "rustyhgi_tpu")


def _log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def _caches(root: str) -> None:
    base = os.path.join(root, "build", "hgibench")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_extensions")


def jax_loaded() -> list:
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(JAX_NAMES))


def _merge(base: dict, override: dict) -> dict:
    out = dict(base)
    for k, v in (override or {}).items():
        out[k] = _merge(out.get(k, {}), v) if isinstance(v, dict) else v
    return out


class Ctx:
    """What a metric's reader reads: the window, the entry and its state,
    the set-up time, and in a traced run the host timers and the profiled
    slice kept (``reading``, None when every slice lost records)."""

    def __init__(self, cell, state, window, setup_s, clock=None, reading=None, slice_index=None):
        self.cell, self.entry, self.state, self.window = cell, cell.entry, state, window
        self.seconds, self.setup_s = window.seconds, setup_s
        self.clock, self.reading, self.slice_index = clock, reading, slice_index

    @property
    def ok(self):
        return [r for r in self.window.requests if r.ok]

    def per_request_ms(self, label: str):
        """Host ms a served request of the window spent in the timer's
        label; calls made before the window, in warm-up, are left out."""
        if self.clock is None or not self.ok:
            return None
        return 1e3 * self.clock.seconds(label, since=self.window.t0) / len(self.ok)

    def roofline(self, function: str, kernels):
        """Percent of ``function``'s roofline over the kept slice: its least
        seconds for the requests served in the slice over the device
        seconds of its kernels' records."""
        from . import roofline

        if self.reading is None:
            return None
        traced = [r for r in self.ok if r.slice == self.slice_index]
        bound = sum(self.entry.work(self.state, r)[function] for r in traced)
        return roofline.share(bound, self.reading.device_seconds(kernels))


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             overrides: dict = None, control: bool = False, t0: float = None,
             bench: dict = None) -> dict:
    """One run of a cell; returns the result line as a dict.

    ``device="cpu"`` runs the program's plain versions without a card and
    without the profiler (for the benchmark's tests); ``overrides`` merges
    into the configuration (``config``) and the mix (``mix``); ``control``
    puts the entry's control, the reference with a guarantee broken, in
    the program's place; ``bench`` stands for ``BENCHMARK.json``.
    """
    from . import spec
    from .clock import Clock
    from .core import Tracer

    t0 = T0 if t0 is None else t0
    cell = spec.load_cell(workload, bench)
    cell.config = _merge(cell.config, (overrides or {}).get("config"))
    cell.mix = _merge(cell.mix, (overrides or {}).get("mix"))
    import torch

    cuda = device != "cpu"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    entry = cell.entry
    state = entry.setup(cell.config, cell.mix, seed, device, _log)
    if control:
        entry.control(state)
    metric_modules = {m["name"]: spec.load_metric(m["name"]) for m in
                      (cell.per_layer if trace else cell.end_to_end)}
    expected = {mod.COUNTER: (mod.KERNELS, mod.PER_LAUNCH)
                for mod in metric_modules.values() if hasattr(mod, "COUNTER")}
    clock = Clock(entry.timers(state), sync) if trace else None
    tracer = None
    if trace and cuda:
        t = cell.mix["trace"]
        tracer = Tracer(entry.counters(), expected, float(t["start_s"]), float(t["length_s"]),
                        log=_log)
    if cuda:
        sync()
        torch.cuda.reset_peak_memory_stats()
    # What set-up made stays out of the collector's scans during the window.
    gc.collect()
    gc.freeze()
    if clock:
        clock.__enter__()
    try:
        window = cell.driver.run(entry, state, cell.mix, seed, seconds, tracer, _log)
    finally:
        if clock:
            clock.__exit__(None, None, None)
    gc.unfreeze()
    setup_s = window.t0 - t0
    entry.finish(state, window)
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips if cuda else 0,
           "memory_peak_bytes": int(torch.cuda.max_memory_allocated()) if cuda else 0}
    for err in window.errors:
        _log(f"request failed: {err}")
    reading = slice_index = None
    if tracer:
        reading, slice_index = tracer.reading, tracer.index
        if reading is None:
            _log("trace: no slice held every launch's records; no metric read from the trace")
    entry.release(state)
    if cuda:
        torch.cuda.empty_cache()
    checks = entry.check(state, window, seed, _log)
    if hasattr(entry, "count"):
        entry.count(state, window)
    ctx = Ctx(cell, state, window, setup_s, clock, reading, slice_index)
    metrics = {}
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    for name, mod in metric_modules.items():
        value = mod.read(ctx)
        if value is not None:
            metrics[name] = {"value": float(value), "unit": units[name]}
    correct = all(value <= limit for _, value, limit in checks)
    result = {"correct": correct, "attempted": window.attempted, "failed": window.failed,
              "metrics": metrics, "device": dev}
    if reading is not None:
        result["breakdown"] = reading.breakdown()
    shown = reading or (tracer.last if tracer else None)
    if shown is not None and shown.window is not None:  # else the last slice, which lost records
        dev["busy_s"] = shown.busy_s
        dev["window_s"] = shown.window_s
    if window.usage is not None:
        result["usage"] = window.usage
    result["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in checks}
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="hgibench.run", description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from . import spec

    _caches(spec.ROOT)
    cell = spec.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        _log(f"hgibench: the cell needs {cell.chips} CUDA card(s); this machine has {n}")
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    found = jax_loaded()
    if found:
        _log(f"hgibench: JAX or the JAX package is loaded: {', '.join(found)}")
        return 3
    for name, c in result["checks"].items():
        _log(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

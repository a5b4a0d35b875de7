"""Find an open-loop cell's knee: the highest offered rate it sustains.

    python -m hgibench.sweep --workload <cell> --seed <n> --seconds <s> \
        (--rates r1,r2,... | --fractions f1,f2,...)

One process: the cell's set-up once, then back-to-back requests for
``--seconds`` (the service time with no queue), then the cell's open loop
at each rate for ``--seconds``.  A line a rate on standard output: the
latency's median, 95th and 99th percentiles, the mean latency of the
last quarter of the requests against the first (a backlog that grows
through the window shows as a ratio well above 1), and the share of the
window the worker was busy.  The knee is the highest rate whose backlog
does not grow; the cell's mix takes four fifths of it.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="hgibench.sweep")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--rates", help="comma-separated requests a second")
    p.add_argument("--fractions", help="comma-separated shares of the measured capacity")
    args = p.parse_args(argv)

    from . import spec, stats
    from .run import _caches, _log

    _caches(spec.ROOT)
    import torch

    if not torch.cuda.is_available():
        _log("hgibench.sweep: no CUDA card")
        return 2
    cell = spec.load_cell(args.workload)
    state = cell.entry.setup(cell.config, cell.mix, args.seed, "cuda", _log)
    service, t0, i = [], time.perf_counter(), 0
    while time.perf_counter() - t0 < args.seconds:
        a = time.perf_counter()
        cell.entry.request(state, i % int(cell.mix["pool"]))
        service.append(time.perf_counter() - a)
        i += 1
    mean = sum(service) / len(service)
    print(json.dumps({"workload": args.workload, "back_to_back": len(service),
                      "service_ms_median": 1e3 * statistics.median(service),
                      "service_ms_mean": 1e3 * mean, "capacity_per_s": 1 / mean,
                      "card": torch.cuda.get_device_name(0)}), flush=True)
    rates = [float(r) for r in args.rates.split(",")] if args.rates else \
        [round(float(f) / mean, 1) for f in args.fractions.split(",")]
    for rate in rates:
        mix = dict(cell.mix, rate_per_s=rate, sample=1)
        w = cell.driver.run(cell.entry, state, mix, args.seed, args.seconds, None, _log)
        lat = [r.latency for r in w.requests if r.ok]
        q = max(1, len(lat) // 4)
        busy = sum(r.service for r in w.requests) / max(w.requests[-1].end, args.seconds)
        print(json.dumps({
            "rate_per_s": rate, "requests": len(lat), "failed": w.failed,
            "p50_ms": 1e3 * stats.percentile(lat, 50), "p95_ms": 1e3 * stats.percentile(lat, 95),
            "p99_ms": 1e3 * stats.percentile(lat, 99),
            "last_over_first_quarter": (sum(lat[-q:]) / q) / (sum(lat[:q]) / q),
            "busy_share": busy, "overran_s": max(0.0, w.requests[-1].end - args.seconds)}),
            flush=True)
    cell.entry.finish(state, w)
    return 0


if __name__ == "__main__":
    sys.exit(main())

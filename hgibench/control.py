"""The readings a cell's limits are set from, on the card, in one process.

    python -m hgibench.control --workload <cell> --seeds s1,s2,... --seconds <s>

For each seed, one run of the program and one of the control (the
reference with one of the configuration's guarantees broken, in the
program's place), both at the cell's own size and load for a short
window.  A JSON line a run: the seed, which side, ``correct`` and every
number compared with its limit.  The program's readings are the lower
ones, the control's the upper ones.  The benchmark's own runs never run
the control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="hgibench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)

    from . import spec
    from .run import _caches, run_cell

    _caches(spec.ROOT)
    import torch

    if not torch.cuda.is_available():
        print("hgibench.control: no CUDA card", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        for side in ("program", "control"):
            r = run_cell(args.workload, seed, args.seconds, False, control=side == "control",
                         t0=time.perf_counter())
            print(json.dumps({"workload": args.workload, "seed": seed, "side": side,
                              "correct": r["correct"], "attempted": r["attempted"],
                              "checks": r["checks"], "metrics": r["metrics"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Spreads of a cell's metrics over two sets of runs, for its bounds.

    python -m hgibench.spread SET_A_FILES... -- SET_B_FILES... [-- SET_C_FILES...]

Each file holds a run's standard output; its last line is the result.
For each metric: each set's median and its spread, the distance between
the first and third quartiles (``statistics.quantiles(values, n=4)``)
over the median, over all its runs; the wider of the two, five times it
(the bound it suggests, never under 1%); the mean of the two sets'
spreads each without its run farthest from the median (``tight``, which
may not pass half of a bound); and the second set's median against the
first's.  A third set, on other seeds, adds its median, its spread and
its spread without its farthest run (``trimmed_c``).
"""

from __future__ import annotations

import json
import sys
from statistics import median

from .stats import quartile_spread, trimmed_spread


def _values(paths):
    out = {}
    for path in paths:
        with open(path) as f:
            line = [ln for ln in f.read().splitlines() if ln.strip()][-1]
        for name, m in json.loads(line)["metrics"].items():
            out.setdefault(name, []).append(m["value"])
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    cuts = [i for i, arg in enumerate(argv) if arg == "--"] + [len(argv)]
    a, b = _values(argv[: cuts[0]]), _values(argv[cuts[0] + 1 : cuts[1]])
    c = _values(argv[cuts[1] + 1 :]) if len(cuts) > 2 else {}
    for name in a:
        sa, sb = quartile_spread(a[name]), quartile_spread(b[name])
        wide = max(sa, sb)
        line = {"metric": name, "median_a": median(a[name]), "median_b": median(b[name]),
                "spread_a": sa, "spread_b": sb, "bound_5x": max(0.01, 5 * wide),
                "tight": (trimmed_spread(a[name]) + trimmed_spread(b[name])) / 2,
                "b_over_a": median(b[name]) / median(a[name]), "a": a[name], "b": b[name]}
        if name in c:
            line.update(median_c=median(c[name]), spread_c=quartile_spread(c[name]),
                        trimmed_c=trimmed_spread(c[name]), c=c[name])
        print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Spreads of a cell's metrics over two sets of runs, for its bounds.

    python -m hgibench.spread SET_A_FILES... -- SET_B_FILES...

Each file holds a run's standard output; its last line is the result.
For each metric: each set's median and its spread, the distance between
the first and third quartiles (``statistics.quantiles(values, n=4)``)
over the median, over all its runs; the wider of the two, five times it
(the bound it suggests, never under 1%); the mean of the two sets'
spreads each without its run farthest from the median (``tight``, which
may not pass half of a bound); and the second set's median against the
first's.
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
    cut = argv.index("--")
    a, b = _values(argv[:cut]), _values(argv[cut + 1 :])
    for name in a:
        sa, sb = quartile_spread(a[name]), quartile_spread(b[name])
        wide = max(sa, sb)
        print(json.dumps({"metric": name, "median_a": median(a[name]), "median_b": median(b[name]),
                          "spread_a": sa, "spread_b": sb, "bound_5x": max(0.01, 5 * wide),
                          "tight": (trimmed_spread(a[name]) + trimmed_spread(b[name])) / 2,
                          "b_over_a": median(b[name]) / median(a[name]),
                          "a": a[name], "b": b[name]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Percent of the profiled slice's device-idle time that no program span
below the command's (``cli.encode_tiled``) covers: the command's own
self time and the harness's time between requests.  The whole split by
span goes to standard error."""

import json
import sys

from hgibench import spans


def read(ctx):
    split = spans.idle_by_span(ctx)
    total = sum(split.values()) if split else 0.0
    if not total:
        return None
    order = sorted(split.items(), key=lambda kv: -kv[1])
    print("idle by program span (s): " + json.dumps(order), file=sys.stderr, flush=True)
    return 100.0 * split[spans.UNNAMED] / total

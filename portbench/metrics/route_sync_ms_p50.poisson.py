"""Median host time of the route's copy to the host (the program's
`route_to_host` span: the host waits for the stream), in milliseconds; its
95th percentile and the share of submits made while a flush was open go to
standard error."""
import json
import sys

import numpy as np


def read(ctx):
    rs = [s for s in ctx.program if s.name == "route_to_host" and s.end_ns]
    if not rs:
        return None
    ms = np.asarray([(s.end_ns - s.start_ns) / 1e6 for s in rs])
    flushes = [(f.start_ns, f.end_ns or 1 << 62) for f in ctx.program if f.name == "flush"]
    during = [any(a <= s.start_ns <= b for a, b in flushes) for s in rs]
    inside = ms[np.asarray(during)] if any(during) else np.asarray([])
    print("portbench: route_to_host " + json.dumps({
        "n": len(ms), "p50_ms": float(np.median(ms)), "p95_ms": float(np.percentile(ms, 95)),
        "during_flush": int(sum(during)),
        "p50_ms_during_flush": float(np.median(inside)) if len(inside) else None,
        "p50_ms_outside": float(np.median(ms[~np.asarray(during)])) if not all(during) else None}),
        file=sys.stderr)
    return float(np.median(ms))

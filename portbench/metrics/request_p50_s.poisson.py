"""Median latency of every request due in the window, from its scheduled
send time to its image on the host (host clock); a request that never
completes counts as the longest wait allowed. A reading without a bound:
below the knee the queue amplifies the host's speed, and between runs of
one schedule the median swings by more than any bound allows (PERF.md)."""
import numpy as np

from portbench.harness.serving import DRAIN_S


def read(ctx):
    lat = ctx.window.latencies()
    if not len(lat):
        return None
    lat = np.where(np.isfinite(lat), lat, ctx.window.seconds + DRAIN_S)
    return float(np.median(lat))

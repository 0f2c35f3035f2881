"""Median wait of a request in the queue: from its due time to the start of
the flush that carries it (spans the benchmark records around
`flush_async`), in milliseconds."""
import statistics


def read(ctx):
    w = ctx.window
    waits = [w.flushes[w.flush_of[r]].start - w.due[r] for r in w.due if r in w.flush_of]
    return 1e3 * statistics.median(waits) if waits else None

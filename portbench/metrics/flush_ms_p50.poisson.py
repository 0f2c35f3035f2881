"""Median time of a flush, from its `flush_async` call to its images on the
host: the tier plan, the graph replays of each (expert, tier), the VAE
decodes and the copy to the host, in milliseconds."""
import statistics


def read(ctx):
    d = [f.end - f.start for f in ctx.window.flushes if f.end is not None]
    return 1e3 * statistics.median(d) if d else None

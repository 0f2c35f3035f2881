"""Median host time of `ServingQueue.submit` for one request (CLIP encodes of
the prompt and the negative prompt, the hypernet and the quantizer's route,
the route's copy to the host), in milliseconds."""
import statistics


def read(ctx):
    s = list(ctx.window.submit_s.values())
    return 1e3 * statistics.median(s) if s else None

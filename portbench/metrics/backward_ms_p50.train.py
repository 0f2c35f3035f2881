"""Median device time of a step's backward: CUDA events at the step's
`mark("losses")` and `mark("backward")`, in milliseconds."""
import statistics


def read(ctx):
    r = getattr(ctx, "run", None)
    ms = [s.stage_ms["backward"] for s in (r.steps if r else []) if "backward" in s.stage_ms]
    return statistics.median(ms) if ms else None

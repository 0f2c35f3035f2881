"""Median device time of the dense teacher's forward in a step: CUDA events
at the step's `mark("router")` and `mark("teacher")`, in milliseconds."""
import statistics


def read(ctx):
    r = getattr(ctx, "run", None)
    ms = [s.stage_ms["teacher"] for s in (r.steps if r else []) if "teacher" in s.stage_ms]
    return statistics.median(ms) if ms else None

"""Median host time per submit of the CLIP text encodes of the prompt and
of the negative prompt (the program's `encode_prompt` + `encode_negative`
spans), in milliseconds."""
import statistics


def read(ctx):
    by = {}
    submits = {s.id for s in ctx.program if s.name == "submit"}
    for s in ctx.program:
        if s.parent in submits and s.name in ("encode_prompt", "encode_negative") and s.end_ns:
            by[s.parent] = by.get(s.parent, 0) + s.end_ns - s.start_ns
    return statistics.median(by.values()) / 1e6 if by else None

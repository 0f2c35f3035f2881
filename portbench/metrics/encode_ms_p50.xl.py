"""Median per submit of the stream time of SDXL's two text towers: the
program's `clip_l` and `clip_bigg` spans (inside `encode_prompt`, and inside
`encode_negative` where a negative prompt is encoded), each timed by CUDA
events recorded on the stream at its start and end, summed over the spans
under one `submit`, in milliseconds."""
import statistics


def read(ctx):
    by_id = {s.id: s for s in ctx.program}

    def submit_of(s):
        while s.parent is not None and s.parent in by_id:
            s = by_id[s.parent]
            if s.name == "submit":
                return s.id
        return None

    per = {}
    for s in ctx.program:
        if s.name in ("clip_l", "clip_bigg") and s.device_ms is not None:
            root = submit_of(s)
            if root is not None:
                per[root] = per.get(root, 0.0) + s.device_ms
    return statistics.median(per.values()) if per else None

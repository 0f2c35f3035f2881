"""Idle device time of the traced slice that falls inside open `flush`
spans of the program, over the slice, in percent: the part of
`device_idle_share` that the flush thread's own host work leaves."""


def read(ctx):
    tl = ctx.timeline
    if tl is None or tl.window_s <= 0 or not tl.ops:
        return None
    flushes = sorted((s.start_ns, s.end_ns) for s in tl.program
                     if s.name == "flush" and s.end_ns is not None)
    if not flushes:
        return None
    idle = 0
    for a, b in tl.idle_intervals():
        for fa, fb in flushes:
            lo, hi = max(a, fa), min(b, fb)
            if hi > lo:
                idle += hi - lo
    return 100.0 * idle / 1e9 / tl.window_s

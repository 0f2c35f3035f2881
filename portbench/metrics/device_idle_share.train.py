"""Share of the traced slice (whole steps, torch.profiler) in which no
operation ran on the device, in percent."""


def read(ctx):
    tl = ctx.timeline
    if tl is None or tl.window_s <= 0 or not tl.ops:
        return None
    return 100.0 * (1.0 - tl.busy_s() / tl.window_s)

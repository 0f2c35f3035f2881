"""Model-FLOP utilisation of a throughput cell's traced slice: the products
of the real requests its flushes served (`readings.served_flops`) over the
slice's seconds times the H100's dense bf16 peak, in percent."""
from portbench.harness import flops
from portbench.harness.readings import served_flops


def read(ctx):
    tl = ctx.timeline
    flushes = ctx.traced_flushes()
    if tl is None or not tl.ops or not flushes or tl.window_s <= 0:
        return None
    return 100.0 * served_flops(ctx, flushes) / (tl.window_s * flops.PEAK_BF16_FLOPS)

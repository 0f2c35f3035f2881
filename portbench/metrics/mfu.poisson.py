"""Model-FLOP utilisation of the open-loop cell's flushes, the step that a
request waits for: the products of the real requests every completed flush
of the window served (`readings.served_flops`) over the flushes' own
seconds (from `flush_async` to the images on the host) times the H100's
dense bf16 peak, in percent. The gaps between flushes, set by the offered
rate, are left out."""
from portbench.harness import flops
from portbench.harness.readings import served_flops


def read(ctx):
    flushes = [f for f in ctx.window.flushes if f.end is not None]
    busy = sum(f.end - f.start for f in flushes)
    if busy <= 0:
        return None
    return 100.0 * served_flops(ctx, flushes) / (busy * flops.PEAK_BF16_FLOPS)

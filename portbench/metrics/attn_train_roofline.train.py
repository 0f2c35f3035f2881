"""Share of their roofline the attention kernels of the traced steps reach:
the least time one H100 needs for each step's attention calls (the
teacher's forwards, the student's forwards with lse rows and its backward
as one function, `flops.lse_forward_bound_s` and `backward_bound_s`, at
every site's heads), over the device time of the kernels named in KERNELS,
in percent."""
from portbench.harness import flops

KERNELS = ("gated_flash_fwd", "gated_flash_bwd")


def read(ctx):
    tl = ctx.timeline
    steps = ctx.traced_steps() if hasattr(ctx, "traced_steps") else []
    if tl is None or not steps:
        return None
    measured = tl.kernel_seconds(KERNELS)
    if measured <= 0:
        return None
    calls = flops.attention_calls(ctx.spec, ctx.layout, None, ctx.run.batch)
    per_step = sum(flops.attention_bound_s(*c) + flops.lse_forward_bound_s(*c)
                   + flops.backward_bound_s(*c) for c in calls)
    return 100.0 * per_step * len(steps) / measured

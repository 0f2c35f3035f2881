"""Model-FLOP utilisation of the traced steps: the products of a step
(`flops.stage1_step_flops`: CLIP text, VAE encode, teacher and student
forwards, the student's backward as activation gradients only, since the
U-Net is frozen) times the steps the slice holds, over the slice's seconds
times the H100's dense bf16 peak, in percent."""
from portbench.harness import flops


def read(ctx):
    tl = ctx.timeline
    steps = ctx.traced_steps() if hasattr(ctx, "traced_steps") else []
    if tl is None or not tl.ops or not steps or tl.window_s <= 0:
        return None
    per_step = flops.stage1_step_flops(ctx.config, ctx.spec, ctx.layout, ctx.run.batch)
    return 100.0 * per_step * len(steps) / (tl.window_s * flops.PEAK_BF16_FLOPS)

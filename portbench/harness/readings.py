"""Readings that the metrics of more than one cell take, each over what a
serving window or its traced slice holds (`cell.Context`)."""
from __future__ import annotations

from portbench.harness import flops
from portbench.harness.serving import flush_tiers

ATTENTION_FORWARD = ("gated_flash_fwd",)


def tier_fill(ctx):
    """Requests flushed over `last_slots_used`, summed over the window's
    flushes, in percent."""
    flushes = [f for f in ctx.window.flushes if f.end is not None and f.slots]
    slots = sum(f.slots for f in flushes)
    return 100.0 * sum(len(f.rids) for f in flushes) / slots if slots else None


def served_flops(ctx, flushes) -> float:
    """Model products of the real requests of `flushes`: CLIP text of the
    prompt and the negative prompt, the CFG pair of U-Net forwards at the
    routed expert's kept widths at every sampler step, the VAE decode;
    padded tier rows are not counted."""
    cfg, per_expert, total = ctx.config, {}, 0.0
    for f in flushes:
        for rid in f.rids:
            e = ctx.window.expert[rid]
            if e not in per_expert:
                per_expert[e] = flops.unet_forward_flops(ctx.spec, ctx.layout, ctx.codes[e], 2)
            total += ctx.steps * per_expert[e]
            total += flops.clip_text_flops(cfg["text_encoder"], 2)
            total += flops.vae_decode_flops(cfg["vae"], ctx.spec.sample_size, 1)
    return total


def attention_forward_roofline(ctx):
    """The least time one H100 needs for every attention call of the traced
    flushes (each the larger of its products at the bf16 peak and its bytes
    at HBM bandwidth, from the tier's rows, padding included, and each
    site's kept heads), over the device time of ATTENTION_FORWARD's
    kernels, in percent."""
    tl = ctx.timeline
    flushes = ctx.traced_flushes()
    if tl is None or not flushes:
        return None
    measured = tl.kernel_seconds(ATTENTION_FORWARD)
    if measured <= 0:
        return None
    bound = 0.0
    for f in flushes:
        for e, tier, _ in flush_tiers(ctx.window, f, ctx.tier_sizes):
            for call in flops.attention_calls(ctx.spec, ctx.layout, ctx.codes[e], 2 * tier):
                bound += ctx.steps * flops.attention_bound_s(*call)
    return 100.0 * bound / measured


def idle_share(ctx):
    """Share of the traced slice in which no operation ran on the device,
    in percent."""
    tl = ctx.timeline
    if tl is None or tl.window_s <= 0 or not tl.ops:
        return None
    return 100.0 * (1.0 - tl.busy_s() / tl.window_s)

"""Readings that the metrics of more than one cell take, each over what a
serving window or its traced slice holds (`cell.Context`)."""
from __future__ import annotations

from portbench.harness import family, flops
from portbench.harness.serving import flush_tiers

ATTENTION_FORWARD = ("gated_flash_fwd",)


def tier_fill(ctx):
    """Requests flushed over `last_slots_used`, summed over the window's
    flushes, in percent."""
    flushes = [f for f in ctx.window.flushes if f.end is not None and f.slots]
    slots = sum(f.slots for f in flushes)
    return 100.0 * sum(len(f.rids) for f in flushes) / slots if slots else None


def served_flops(ctx, flushes) -> float:
    """Model products of the real requests of `flushes`, each request's
    counted by the configuration's family (`request_flops` of
    `counts/<family>.py`) at the routed expert's kept widths; padded tier
    rows are not counted."""
    counts, per_expert, total = family.counts(ctx.config), {}, 0.0
    for f in flushes:
        for rid in f.rids:
            e = ctx.window.expert[rid]
            if e not in per_expert:
                per_expert[e] = counts.request_flops(ctx.config, ctx.spec, ctx.layout,
                                                     ctx.codes[e], ctx.steps)
            for term in per_expert[e]:
                total += term
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
    counts, bound = family.counts(ctx.config), 0.0
    for f in flushes:
        for e, tier, _ in flush_tiers(ctx.window, f, ctx.tier_sizes):
            for call in counts.attention_calls(ctx.spec, ctx.layout, ctx.codes[e], 2 * tier):
                bound += ctx.steps * flops.attention_bound_s(*call)
    return 100.0 * bound / measured


def idle_share(ctx):
    """Share of the traced slice in which no operation ran on the device,
    in percent."""
    tl = ctx.timeline
    if tl is None or tl.window_s <= 0 or not tl.ops:
        return None
    return 100.0 * (1.0 - tl.busy_s() / tl.window_s)

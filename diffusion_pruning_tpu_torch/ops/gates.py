"""Gate application: slices of the flat architecture vector as masks.

Same semantics and layout as the JAX package's `ops/gates.py`: gates are
`(B, width)` tensors; `channel_gate` masks a trailing channel dim.
"""
from __future__ import annotations

import torch


def match_batch(gate: torch.Tensor, batch: int) -> torch.Tensor:
    """Tile gate rows when the activation batch is a multiple of the gate
    batch — classifier-free guidance runs [uncond, cond], so rows TILE
    (`repeat`), they are not interleaved."""
    if gate.shape[0] == batch:
        return gate
    if batch % gate.shape[0] != 0:
        raise ValueError(f"batch {batch} not a multiple of gate batch {gate.shape[0]}")
    return gate.repeat(batch // gate.shape[0], *([1] * (gate.dim() - 1)))


def channel_mask(gate: torch.Tensor, c: int, batch: int) -> torch.Tensor:
    """Expand a grouped gate to a per-channel (batch, C) mask: gate unit g
    covers the contiguous channel slab [g*C/width, (g+1)*C/width), aligned
    with GroupNorm groups — each element REPEATS (`repeat_interleave`)."""
    width = gate.shape[-1]
    mask = torch.repeat_interleave(gate, c // width, dim=-1)
    return match_batch(mask, batch)


def channel_gate(x: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """Mask the trailing channel dim of x (..., C) with a (B, width) gate."""
    c = x.shape[-1]
    mask = channel_mask(gate, c, x.shape[0])
    return x * mask.reshape(mask.shape[0], *([1] * (x.dim() - 2)), c).to(x.dtype)


def head_gate(x: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """Mask attention heads. x: (B, S, h, d); gate: (B, h)."""
    g = match_batch(gate, x.shape[0])
    return x * g[:, None, :, None].to(x.dtype)


def depth_lerp(gate: torch.Tensor, identity: torch.Tensor,
               out: torch.Tensor) -> torch.Tensor:
    """Depth gate: (1-m)*identity + m*out, m per sample."""
    m = match_batch(gate.reshape(-1), out.shape[0])
    m = m.reshape(-1, *([1] * (out.dim() - 1))).to(out.dtype)
    return (1.0 - m) * identity + m * out

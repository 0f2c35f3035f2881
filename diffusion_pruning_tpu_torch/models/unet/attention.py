"""Head-gated attention and the gated transformer block.

Semantics of the JAX package's `models/unet/attention.py`: q, k and v are each
multiplied per head by the same soft gate before scaled-dot-product attention
(so soft gates scale the logits by g² and the output by g), and the GEGLU
feed-forward gates both of its halves. Attribute names follow diffusers'
`BasicTransformerBlock` state dict (`attn1.to_q`, `ff.net.0.proj`, ...).
`active_heads` and `active_inner` build a physically pruned expert's
projections: only the kept heads (of the dense head size) and GEGLU units.
"""
from __future__ import annotations

from typing import Optional

import torch.nn as nn
import torch.nn.functional as F

from diffusion_pruning_tpu_torch.ops.flash_attention import (
    gated_attention_reference,
    gated_flash_attention,
)
from diffusion_pruning_tpu_torch.ops.gates import channel_gate, match_batch


class GatedAttention(nn.Module):
    """Multi-head attention with a per-head width gate. With `use_flash`,
    attention runs through `gated_flash_attention`: the inference kernel, or
    under autograd the training forward and backward kernels, with the gate
    kept f32 and differentiable (their plain versions for CPU tensors);
    otherwise through the plain masked path. `active_heads` < heads keeps
    that many heads of the dense head size `dim // heads`: q, k and v emit
    only them and to_out takes them; the output stays `dim` wide."""

    def __init__(self, dim: int, heads: int, context_dim: Optional[int] = None,
                 use_flash: bool = False, active_heads: Optional[int] = None):
        super().__init__()
        self.head_dim = dim // heads
        self.heads = active_heads if active_heads is not None else heads
        self.use_flash = use_flash
        ctx = context_dim or dim
        inner = self.heads * self.head_dim
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_k = nn.Linear(ctx, inner, bias=False)
        self.to_v = nn.Linear(ctx, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, dim)])

    def forward(self, x, context=None, gate=None):
        b, s, _ = x.shape
        ctx = x if context is None else context
        q = self.to_q(x).view(b, s, self.heads, self.head_dim)
        k = self.to_k(ctx).view(b, ctx.shape[1], self.heads, self.head_dim)
        v = self.to_v(ctx).view(b, ctx.shape[1], self.heads, self.head_dim)
        g = None if gate is None else match_batch(gate, b)
        if self.use_flash:
            if g is not None:
                g = g.float().contiguous()
            o = gated_flash_attention(q, k, v, g)
        else:
            o = gated_attention_reference(q, k, v, g)
        return self.to_out[0](o.reshape(b, s, self.heads * self.head_dim))


class GatedGEGLU(nn.Module):
    """GEGLU with a grouped width gate on the inner dim: both the linear half
    and the GELU half are masked (soft gates enter squared); exact erf GELU."""

    def __init__(self, dim: int, inner_dim: int):
        super().__init__()
        self.proj = nn.Linear(dim, 2 * inner_dim)

    def forward(self, x, gate=None):
        h, g = self.proj(x).chunk(2, dim=-1)
        if gate is not None:
            h = channel_gate(h, gate)
            g = channel_gate(g, gate)
        return h * F.gelu(g)


class GatedFeedForward(nn.Module):
    """`active_inner` < dim·mult keeps that many GEGLU units (an expert's)."""

    def __init__(self, dim: int, mult: int = 4, active_inner: Optional[int] = None):
        super().__init__()
        inner = active_inner if active_inner is not None else dim * mult
        # diffusers layout: net.0 = GEGLU, net.1 = dropout, net.2 = out proj
        self.net = nn.ModuleList([GatedGEGLU(dim, inner), nn.Identity(), nn.Linear(inner, dim)])

    def forward(self, x, gate=None):
        return self.net[2](self.net[0](x, gate))


class GatedTransformerBlock(nn.Module):
    """Pre-LN transformer block: self-attn, cross-attn, gated GEGLU FF."""

    def __init__(self, dim: int, heads: int, context_dim: int, use_flash: bool = False,
                 active_heads1: Optional[int] = None, active_heads2: Optional[int] = None,
                 active_ff_inner: Optional[int] = None):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = GatedAttention(dim, heads, None, use_flash, active_heads1)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.attn2 = GatedAttention(dim, heads, context_dim, use_flash, active_heads2)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = GatedFeedForward(dim, active_inner=active_ff_inner)

    def forward(self, x, context, gate_attn1=None, gate_attn2=None, gate_ff=None):
        x = x + self.attn1(self.norm1(x), None, gate_attn1)
        x = x + self.attn2(self.norm2(x), context, gate_attn2)
        return x + self.ff(self.norm3(x), gate_ff)

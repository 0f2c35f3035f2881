"""Gated U-Net building blocks (NCHW inside the U-Net).

Gate placement follows the JAX package's `models/unet/blocks.py`:
  * resnet width gate: after conv1 + time-emb add, before norm2 — the gate
    groups align with norm2's GroupNorm groups;
  * transformer: per-head gates on attn1/attn2 and the grouped GEGLU gate;
  * depth gate: out = (1-m)·identity + m·block_out, with the identity given
    explicitly (for up-blocks it is the hidden state before the skip concat).
Attribute names follow diffusers (`norm1`, `conv1`, `time_emb_proj`,
`proj_in`, `transformer_blocks.0`, ...).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch.nn as nn
import torch.nn.functional as F

from diffusion_pruning_tpu_torch.models.unet.attention import GatedTransformerBlock
from diffusion_pruning_tpu_torch.ops.gates import channel_mask, depth_lerp


class GatedResnetBlock(nn.Module):
    """SD resnet block with an optional grouped width gate and depth gate."""

    def __init__(self, in_channels: int, out_channels: int, temb_channels: int,
                 groups: int = 32, eps: float = 1e-5):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, in_channels, eps=eps)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.time_emb_proj = nn.Linear(temb_channels, out_channels)
        self.norm2 = nn.GroupNorm(groups, out_channels, eps=eps)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = (nn.Conv2d(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)

    def forward(self, x, temb, gate=None, depth_gate=None, identity=None):
        """x: (B, C, H, W). identity: what a closed depth gate returns (the
        hidden part of an up-block's concat); defaults to x."""
        h = self.conv1(F.silu(self.norm1(x)))
        h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        if gate is not None:
            h = h * channel_mask(gate, h.shape[1], h.shape[0])[:, :, None, None].to(h.dtype)
        h = self.conv2(F.silu(self.norm2(h)))
        shortcut = x if self.conv_shortcut is None else self.conv_shortcut(x)
        out = shortcut + h
        if depth_gate is not None:
            out = depth_lerp(depth_gate, x if identity is None else identity, out)
        return out


class GatedTransformer2D(nn.Module):
    """Spatial transformer: GroupNorm(eps 1e-6) → linear proj_in → one
    transformer block → proj_out → +residual; the depth gate's identity is
    the input."""

    def __init__(self, channels: int, heads: int, context_dim: int, groups: int = 32,
                 use_flash: bool = False):
        super().__init__()
        self.norm = nn.GroupNorm(groups, channels, eps=1e-6)
        self.proj_in = nn.Linear(channels, channels)
        self.transformer_blocks = nn.ModuleList([
            GatedTransformerBlock(channels, heads, context_dim, use_flash)])
        self.proj_out = nn.Linear(channels, channels)

    def forward(self, x, context, gates: Optional[Tuple] = None, depth_gate=None):
        """gates: ((attn1, attn2, ff),) gate slices of the one layer (each
        possibly None), or None."""
        b, c, hh, ww = x.shape
        residual = x
        y = self.proj_in(self.norm(x).permute(0, 2, 3, 1).reshape(b, hh * ww, c))
        g1, g2, gf = gates[0] if gates is not None else (None, None, None)
        y = self.transformer_blocks[0](y, context, g1, g2, gf)
        y = self.proj_out(y).reshape(b, hh, ww, c).permute(0, 3, 1, 2)
        out = y + residual
        if depth_gate is not None:
            out = depth_lerp(depth_gate, residual, out)
        return out


class Downsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2, padding=1)

    def forward(self, x):
        return self.conv(x)


class Upsample(nn.Module):
    """nearest-2× then conv3×3 (the JAX package computes the same function as
    four parity convs, a TPU FLOP saving; the result is identical)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))

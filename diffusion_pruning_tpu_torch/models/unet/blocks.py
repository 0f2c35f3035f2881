"""Gated U-Net building blocks (logical NCHW inside the U-Net; under a fused
flag the tensors are in `torch.channels_last` strides, the layout the
fused-norm kernels read).

Gate placement follows the JAX package's `models/unet/blocks.py`:
  * resnet width gate: after conv1 + time-emb add, before norm2 — the gate
    groups align with norm2's GroupNorm groups;
  * transformer: per-head gates on attn1/attn2 and the grouped GEGLU gate;
  * depth gate: out = (1-m)·identity + m·block_out, with the identity given
    explicitly (for up-blocks it is the hidden state before the skip concat).
Attribute names follow diffusers (`norm1`, `conv1`, `time_emb_proj`,
`proj_in`, `transformer_blocks.0`, ...). The fused paths (`fused_norms`,
`fused_norm_conv`) read the same `nn.GroupNorm`/`nn.Conv2d`/`nn.Linear`
parameters, so the state dict does not depend on the flags. A physically
pruned expert's blocks take their kept widths (`hidden_channels` of a
resnet, `active_*` of a transformer) and run the same ops, fused or not, at
those widths.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch.nn as nn
import torch.nn.functional as F

from diffusion_pruning_tpu_torch.models.unet.attention import GatedTransformerBlock
from diffusion_pruning_tpu_torch.ops.gates import channel_mask, depth_lerp
from diffusion_pruning_tpu_torch.ops.group_norm import group_norm_silu
from diffusion_pruning_tpu_torch.ops.norm_conv import (
    PackedWeight,
    group_norm_linear,
    group_norm_silu_conv3x3,
)


def norm_silu_conv(x, norm: nn.GroupNorm, conv: nn.Conv2d, gate, fused_norms: bool,
                   fused_norm_conv: bool, packed: PackedWeight):
    """conv(silu(norm(gate·x))) with the grouped gate (B, width) or None:
    through the fused norm→conv op under `fused_norm_conv` (the gate folds
    into the normalisation affine), else with the one-pass GroupNorm kernel
    under `fused_norms`, else unfused."""
    if fused_norm_conv:
        gate_c = None if gate is None else channel_mask(gate, x.shape[1], x.shape[0])
        return group_norm_silu_conv3x3(x, norm.weight, norm.bias, conv.weight, conv.bias, gate_c,
                                       norm.num_groups, norm.eps, True, packed=packed)
    if gate is not None:
        x = x * channel_mask(gate, x.shape[1], x.shape[0])[:, :, None, None].to(x.dtype)
    if fused_norms:
        return conv(group_norm_silu(x, norm.weight, norm.bias, norm.num_groups, norm.eps, True))
    return conv(F.silu(norm(x)))


class GatedResnetBlock(nn.Module):
    """SD resnet block with an optional grouped width gate and depth gate.
    `hidden_channels` builds an expert's block: conv1, time_emb_proj and
    norm2 emit only the kept groups (a kept unit is one norm2 group of
    out_channels // groups channels), and conv2 maps them back to
    `out_channels`."""

    def __init__(self, in_channels: int, out_channels: int, temb_channels: int,
                 groups: int = 32, eps: float = 1e-5, fused_norms: bool = False,
                 fused_norm_conv: bool = False, hidden_channels: Optional[int] = None):
        super().__init__()
        hidden = hidden_channels or out_channels
        self.fused = (fused_norms, fused_norm_conv)
        self._packed = (PackedWeight(), PackedWeight())
        self.norm1 = nn.GroupNorm(groups, in_channels, eps=eps)
        self.conv1 = nn.Conv2d(in_channels, hidden, 3, padding=1)
        self.time_emb_proj = nn.Linear(temb_channels, hidden)
        self.norm2 = nn.GroupNorm(hidden // (out_channels // groups), hidden, eps=eps)
        self.conv2 = nn.Conv2d(hidden, out_channels, 3, padding=1)
        self.conv_shortcut = (nn.Conv2d(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)

    def forward(self, x, temb, gate=None, depth_gate=None, identity=None):
        """x: (B, C, H, W). identity: what a closed depth gate returns (the
        hidden part of an up-block's concat); defaults to x."""
        h = norm_silu_conv(x, self.norm1, self.conv1, None, *self.fused, self._packed[0])
        h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = norm_silu_conv(h, self.norm2, self.conv2, gate, *self.fused, self._packed[1])
        shortcut = x if self.conv_shortcut is None else self.conv_shortcut(x)
        out = shortcut + h
        if depth_gate is not None:
            out = depth_lerp(depth_gate, x if identity is None else identity, out)
        return out


class GatedTransformer2D(nn.Module):
    """Spatial transformer: GroupNorm(eps 1e-6) → proj_in → one transformer
    block → proj_out → +residual; the depth gate's identity is the input.
    proj_in and proj_out are linear (`use_linear_projection`, SD-2.x) or 1×1
    convs (SD-1.x, weights (C, C, 1, 1)); only the linear proj_in folds its
    norm in under `fused_norm_conv`."""

    def __init__(self, channels: int, heads: int, context_dim: int, groups: int = 32,
                 use_flash: bool = False, fused_norms: bool = False,
                 fused_norm_conv: bool = False, active_heads1: Optional[int] = None,
                 active_heads2: Optional[int] = None, active_ff_inner: Optional[int] = None,
                 use_linear_projection: bool = True):
        super().__init__()
        self.fused_norms, self.fused_norm_conv = fused_norms, fused_norm_conv
        self.use_linear_projection = use_linear_projection
        self.norm = nn.GroupNorm(groups, channels, eps=1e-6)
        proj = nn.Linear if use_linear_projection else functools.partial(nn.Conv2d,
                                                                         kernel_size=1)
        self.proj_in = proj(channels, channels)
        self.transformer_blocks = nn.ModuleList([
            GatedTransformerBlock(channels, heads, context_dim, use_flash, active_heads1,
                                  active_heads2, active_ff_inner)])
        self.proj_out = proj(channels, channels)

    def forward(self, x, context, gates: Optional[Tuple] = None, depth_gate=None):
        """gates: ((attn1, attn2, ff),) gate slices of the one layer (each
        possibly None), or None."""
        b, c, hh, ww = x.shape
        residual = x
        norm = self.norm
        if self.fused_norm_conv and self.use_linear_projection:
            # norm (no SiLU) folded into proj_in's input read
            y = group_norm_linear(x.permute(0, 2, 3, 1).reshape(b, hh * ww, c), norm.weight,
                                  norm.bias, self.proj_in.weight, self.proj_in.bias, None,
                                  norm.num_groups, norm.eps)
        else:
            y = (group_norm_silu(x, norm.weight, norm.bias, norm.num_groups, norm.eps, False)
                 if self.fused_norms else norm(x))
            if self.use_linear_projection:
                y = self.proj_in(y.permute(0, 2, 3, 1).reshape(b, hh * ww, c))
            else:
                y = self.proj_in(y).permute(0, 2, 3, 1).reshape(b, hh * ww, c)
        g1, g2, gf = gates[0] if gates is not None else (None, None, None)
        y = self.transformer_blocks[0](y, context, g1, g2, gf)
        if self.use_linear_projection:
            y = self.proj_out(y).reshape(b, hh, ww, c).permute(0, 3, 1, 2)
        else:
            y = self.proj_out(y.reshape(b, hh, ww, c).permute(0, 3, 1, 2))
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

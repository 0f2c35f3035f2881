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
`proj_in`, `transformer_blocks.{k}`, ...). The fused paths (`fused_norms`,
`fused_norm_conv`) read the same `nn.GroupNorm`/`nn.Conv2d`/`nn.Linear`
parameters, so the state dict does not depend on the flags. A physically
pruned expert's blocks take their kept widths (`hidden_channels` of a
resnet, `active_*` of a transformer) and run the same ops, fused or not, at
those widths. A resnet of a tensor-parallel U-Net (`parallel/tp.py`)
holds this rank's norm2 groups of the hidden channels and its `tp` split:
conv1's input (with norm1's affine under `fused_norm_conv`, which folds
norm1 into conv1) and the time embedding pass `copy_to_model`, and conv2's
partial product is summed over the model axis with its bias added once.
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import torch
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
from diffusion_pruning_tpu_torch.parallel.tp import (
    Split,
    copy_to_model,
    empty_partial,
    reduce_from_model,
)


def norm_silu_conv(x, norm: nn.GroupNorm, conv: nn.Conv2d, gate, fused_norms: bool,
                   fused_norm_conv: bool, packed: PackedWeight, bias: bool = True):
    """conv(silu(norm(gate·x))) with the grouped gate (B, width) or None:
    through the fused norm→conv op under `fused_norm_conv` (the gate folds
    into the normalisation affine), else with the one-pass GroupNorm kernel
    under `fused_norms`, else unfused. `bias=False` leaves out the conv's
    bias (a row-parallel partial product; the fused op gets zeros)."""
    if fused_norm_conv:
        gate_c = None if gate is None else channel_mask(gate, x.shape[1], x.shape[0])
        conv_bias = conv.bias if bias else torch.zeros_like(conv.bias, requires_grad=False)
        return group_norm_silu_conv3x3(x, norm.weight, norm.bias, conv.weight, conv_bias, gate_c,
                                       norm.num_groups, norm.eps, True, packed=packed)
    if gate is not None:
        x = x * channel_mask(gate, x.shape[1], x.shape[0])[:, :, None, None].to(x.dtype)
    if fused_norms:
        y = group_norm_silu(x, norm.weight, norm.bias, norm.num_groups, norm.eps, True)
    else:
        y = F.silu(norm(x))
    return conv(y) if bias else F.conv2d(y, conv.weight, None, conv.stride, conv.padding)


class GatedResnetBlock(nn.Module):
    """SD resnet block with an optional grouped width gate and depth gate.
    `hidden_channels` builds an expert's block: conv1, time_emb_proj and
    norm2 emit only the kept groups (a kept unit is one norm2 group of
    out_channels // groups channels), and conv2 maps them back to
    `out_channels`."""
    tp: Optional[Split] = None

    def __init__(self, in_channels: int, out_channels: int, temb_channels: int,
                 groups: int = 32, eps: float = 1e-5, fused_norms: bool = False,
                 fused_norm_conv: bool = False, hidden_channels: Optional[int] = None):
        super().__init__()
        hidden = out_channels if hidden_channels is None else hidden_channels
        self.fused = (fused_norms, fused_norm_conv)
        self._packed = (PackedWeight(), PackedWeight())
        self.norm1 = nn.GroupNorm(groups, in_channels, eps=eps)
        self.conv1 = nn.Conv2d(in_channels, hidden, 3, padding=1)
        self.time_emb_proj = nn.Linear(temb_channels, hidden)
        # a tensor-parallel rank may hold no group (hidden 0): one empty group
        self.norm2 = nn.GroupNorm(max(hidden // (out_channels // groups), 1), hidden, eps=eps)
        self.conv2 = nn.Conv2d(hidden, out_channels, 3, padding=1)
        self.conv_shortcut = (nn.Conv2d(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)

    def forward(self, x, temb, gate=None, depth_gate=None, identity=None):
        """x: (B, C, H, W). identity: what a closed depth gate returns (the
        hidden part of an up-block's concat); defaults to x."""
        if self.tp is None:
            h = norm_silu_conv(x, self.norm1, self.conv1, None, *self.fused, self._packed[0])
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
            h = norm_silu_conv(h, self.norm2, self.conv2, gate, *self.fused, self._packed[1])
        else:
            h = self._hidden_tp(x, temb, gate)
        shortcut = x if self.conv_shortcut is None else self.conv_shortcut(x)
        out = shortcut + h
        if depth_gate is not None:
            out = depth_lerp(depth_gate, x if identity is None else identity, out)
        return out

    def _hidden_tp(self, x, temb, gate):
        """The hidden path of this rank's groups, its conv2 partial summed over
        the model axis (+ conv2's bias once)."""
        tp, norm, fused_norms, fused_norm_conv = self.tp, self.norm1, *self.fused
        t = F.silu(temb)
        if fused_norm_conv:  # norm1 folds into conv1: its affine is a column input too
            x, scale, shift, t, gate = copy_to_model(tp.axis, x, norm.weight, norm.bias, t, gate)
        else:
            y = (group_norm_silu(x, norm.weight, norm.bias, norm.num_groups, norm.eps, True)
                 if fused_norms else F.silu(norm(x)))
            x, t, gate = copy_to_model(tp.axis, y, t, gate)
        shape = (x.shape[0], self.conv2.out_channels, *x.shape[2:])
        if tp.empty:
            return reduce_from_model(tp.axis, empty_partial(shape, x, t, gate),
                                     self.conv2.bias, x)
        if fused_norm_conv:
            h = group_norm_silu_conv3x3(x, scale, shift, self.conv1.weight, self.conv1.bias, None,
                                        norm.num_groups, norm.eps, True, packed=self._packed[0])
        else:
            h = self.conv1(x)
        h = h + self.time_emb_proj(t)[:, :, None, None]
        gate = None if gate is None else gate[:, tp.lo:tp.hi]
        partial = norm_silu_conv(h, self.norm2, self.conv2, gate, fused_norms, fused_norm_conv,
                                 self._packed[1], bias=False)
        return reduce_from_model(tp.axis, partial, self.conv2.bias, x)


class GatedTransformer2D(nn.Module):
    """Spatial transformer: GroupNorm(eps 1e-6) → proj_in → `num_layers`
    transformer blocks (SDXL stacks up to 10; SD-2.x has one) → proj_out →
    +residual; the depth gate's identity is the input. proj_in and proj_out
    are linear (`use_linear_projection`, SD-2.x and SDXL) or 1×1 convs
    (SD-1.x, weights (C, C, 1, 1)); only the linear proj_in folds its norm
    in under `fused_norm_conv`. `active` builds an expert's layers: per
    layer (kept attn1 heads, kept attn2 heads, kept GEGLU inner channels)."""

    def __init__(self, channels: int, heads: int, context_dim: int, groups: int = 32,
                 use_flash: bool = False, fused_norms: bool = False,
                 fused_norm_conv: bool = False,
                 active: Optional[Sequence[Tuple[Optional[int], ...]]] = None,
                 use_linear_projection: bool = True, num_layers: int = 1):
        super().__init__()
        self.fused_norms, self.fused_norm_conv = fused_norms, fused_norm_conv
        self.use_linear_projection = use_linear_projection
        self.norm = nn.GroupNorm(groups, channels, eps=1e-6)
        proj = nn.Linear if use_linear_projection else functools.partial(nn.Conv2d,
                                                                         kernel_size=1)
        self.proj_in = proj(channels, channels)
        active = active or [(None, None, None)] * num_layers
        if len(active) != num_layers:
            raise ValueError(f"{len(active)} kept widths for {num_layers} transformer layers")
        self.transformer_blocks = nn.ModuleList([
            GatedTransformerBlock(channels, heads, context_dim, use_flash, *widths)
            for widths in active])
        self.proj_out = proj(channels, channels)

    def forward(self, x, context, gates: Optional[Tuple] = None, depth_gate=None):
        """gates: one (attn1, attn2, ff) tuple of gate slices per layer (each
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
        for k, block in enumerate(self.transformer_blocks):
            y = block(y, context, *(gates[k] if gates is not None else (None, None, None)))
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

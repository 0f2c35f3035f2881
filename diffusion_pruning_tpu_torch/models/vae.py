"""The SD VAE's decoder half (`AutoencoderKL.decode`), NCHW inside.

SD-2.1: 128/256/512/512 channels, 3 resnets per decoder block, one
single-head mid attention at 512, latent dim 4, scale 0.18215, GroupNorm eps
1e-6. Attribute names follow diffusers (`post_quant_conv`,
`decoder.mid_block.attentions.0.to_q`, `decoder.up_blocks.0.upsamplers.0.conv`).
The encoder belongs to training and is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from diffusion_pruning_tpu_torch.ops.flash_attention import plain_attention


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215

    @property
    def spatial_scale(self) -> int:
        """pixels per latent cell: 2^(levels-1) (8 for the SD VAE)."""
        return 2 ** (len(self.block_out_channels) - 1)

    @classmethod
    def sd(cls) -> "VAEConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "VAEConfig":
        return cls(block_out_channels=(16, 32), layers_per_block=1, norm_num_groups=4)


class _Resnet(nn.Module):
    def __init__(self, cin: int, cout: int, groups: int):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, cin, eps=1e-6)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        self.norm2 = nn.GroupNorm(groups, cout, eps=1e-6)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        self.conv_shortcut = nn.Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        return (x if self.conv_shortcut is None else self.conv_shortcut(x)) + h


class _MidAttention(nn.Module):
    """Single-head self-attention over the H·W positions, plain torch ops."""

    def __init__(self, ch: int, groups: int):
        super().__init__()
        self.group_norm = nn.GroupNorm(groups, ch, eps=1e-6)
        self.to_q = nn.Linear(ch, ch)
        self.to_k = nn.Linear(ch, ch)
        self.to_v = nn.Linear(ch, ch)
        self.to_out = nn.ModuleList([nn.Linear(ch, ch)])

    def forward(self, x):
        b, c, hh, ww = x.shape
        y = self.group_norm(x).permute(0, 2, 3, 1).reshape(b, hh * ww, c)
        q, k, v = (f(y)[:, :, None, :] for f in (self.to_q, self.to_k, self.to_v))
        o = self.to_out[0](plain_attention(q, k, v)[:, :, 0])
        o = o.reshape(b, hh, ww, c).permute(0, 3, 1, 2)
        return x + o


class _Upsample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class _UpBlock(nn.Module):
    def __init__(self, resnets, upsample=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if upsample is not None:
            self.upsamplers = nn.ModuleList([upsample])


class _MidBlock(nn.Module):
    def __init__(self, ch: int, groups: int):
        super().__init__()
        self.resnets = nn.ModuleList([_Resnet(ch, ch, groups), _Resnet(ch, ch, groups)])
        self.attentions = nn.ModuleList([_MidAttention(ch, groups)])


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        g = cfg.norm_num_groups
        ch = cfg.block_out_channels[-1]
        self.conv_in = nn.Conv2d(cfg.latent_channels, ch, 3, padding=1)
        self.mid_block = _MidBlock(ch, g)
        rev = list(reversed(cfg.block_out_channels))
        self.up_blocks = nn.ModuleList()
        for i, out in enumerate(rev):
            resnets = []
            for _ in range(cfg.layers_per_block + 1):
                resnets.append(_Resnet(ch, out, g))
                ch = out
            self.up_blocks.append(_UpBlock(resnets, _Upsample(ch) if i < len(rev) - 1 else None))
        self.conv_norm_out = nn.GroupNorm(g, ch, eps=1e-6)
        self.conv_out = nn.Conv2d(ch, cfg.in_channels, 3, padding=1)

    def forward(self, z):
        h = self.conv_in(z)
        h = self.mid_block.resnets[0](h)
        h = self.mid_block.attentions[0](h)
        h = self.mid_block.resnets[1](h)
        for block in self.up_blocks:
            for res in block.resnets:
                h = res(h)
            if hasattr(block, "upsamplers"):
                h = block.upsamplers[0](h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class AutoencoderKL(nn.Module):
    """Decode half of the SD VAE; latents and images are NHWC."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        self.post_quant_conv = nn.Conv2d(cfg.latent_channels, cfg.latent_channels, 1)
        self.decoder = Decoder(cfg)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """(B, h, w, 4) scaled latents → (B, 8h, 8w, 3) images in about [-1, 1]."""
        dtype = self.post_quant_conv.weight.dtype
        x = (z / self.cfg.scaling_factor).to(dtype).permute(0, 3, 1, 2).contiguous()
        return self.decoder(self.post_quant_conv(x)).permute(0, 2, 3, 1)

"""Plain PyTorch reference of routed expert serving: SD-2.1 text-to-image.

What a served request produces, computed from the benchmark's own inputs and
weights with nothing of the program under test: CLIP text encoding, the
route of the request (the quantizer's eval rule on its routing noise), the
dense U-Net under the routed expert's hard code (gates applied, nothing cut),
the classifier-free-guided DDIM trajectory and the VAE decode.

The modules follow diffusers' and Hugging Face's state-dict names, so
`harness.weights.seeded_init_` gives them the same values it gives the
program's modules. The U-Net and VAE are a copy of the repository's
hand-ported diffusers modules (`tests/torch_mini_diffusers.py`) with the
APTP gates added:

* resnet width gate: after conv1 plus the time embedding, before norm2, one
  unit per norm2 group;
* attention: q, k and v multiplied per head by the head's gate;
* GEGLU: both halves masked, a unit per contiguous slab of the inner width;
* depth gate: out = (1 - m) * identity + m * block_out, the identity of an
  up-block resnet being the hidden state before the skip concat.

Everything runs in float32 with TF32 off (`float32_matmuls`). `to_fp8_` turns
a module into the precision control: every linear and convolution reads
float8 (e4m3) inputs and weights, scaled per tensor and per output channel,
and accumulates in float32.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

FP8_MAX = 448.0  # largest finite float8_e4m3fn


# ---------------------------------------------------------------- configuration

@dataclasses.dataclass(frozen=True)
class UNetSpec:
    """The U-Net of a benchmark configuration file, as served."""
    sample_size: int
    in_channels: int
    out_channels: int
    block_out_channels: Tuple[int, ...]
    layers_per_block: int
    attention_head_dim: Tuple[int, ...]   # heads per level (the diffusers naming)
    cross_attention_dim: int
    norm_num_groups: int
    norm_eps: float
    flip_sin_to_cos: bool
    freq_shift: int
    down_block_types: Tuple[str, ...]
    up_block_types: Tuple[str, ...]
    ff_gate_width: int
    ff_mult: int = 4
    max_text_len: int = 77

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4

    @property
    def num_levels(self) -> int:
        return len(self.block_out_channels)


def unet_spec(config: dict) -> UNetSpec:
    """The served U-Net of a configuration file: the published keys, the
    APTP gated block types, and the serving resolution's latent size (the
    VAE halves the side at each level but the last)."""
    g = config["aptp_gating"]
    scale = 2 ** (len(config["vae"]["block_out_channels"]) - 1)
    return UNetSpec(
        sample_size=config["serving"]["resolution"] // scale,
        in_channels=config["in_channels"], out_channels=config["out_channels"],
        block_out_channels=tuple(config["block_out_channels"]),
        layers_per_block=config["layers_per_block"],
        attention_head_dim=tuple(config["attention_head_dim"]),
        cross_attention_dim=config["cross_attention_dim"],
        norm_num_groups=config["norm_num_groups"], norm_eps=config["norm_eps"],
        flip_sin_to_cos=config["flip_sin_to_cos"], freq_shift=config["freq_shift"],
        down_block_types=tuple(g["down_block_types"]), up_block_types=tuple(g["up_block_types"]),
        ff_gate_width=g["ff_gate_width"])


# ---------------------------------------------------------------- gate layout

@dataclasses.dataclass(frozen=True)
class Site:
    kind: str      # resnet | attn1 | attn2 | ff
    start: int     # offset in the width segment of the arch vector
    width: int     # gate units


@dataclasses.dataclass(frozen=True)
class Subblock:
    name: str
    kind: str                  # resnet | transformer
    sites: Tuple[Site, ...]
    depth_index: int           # -1: no depth gate
    channels: int              # output channels
    heads: int = 0


@dataclasses.dataclass(frozen=True)
class Layout:
    subblocks: Tuple[Subblock, ...]
    num_width: int
    num_depth: int

    @property
    def vq_dim(self) -> int:
        return self.num_width + self.num_depth

    def by_name(self) -> Dict[str, Subblock]:
        return {sb.name: sb for sb in self.subblocks}


def gate_layout(spec: UNetSpec) -> Layout:
    """The flat arch vector of APTP: width logits in subblock order (per
    block its resnets, then its attentions; down blocks, the mid block, up
    blocks), then one depth logit per depth-gated subblock in that order.
    "HalfGated" blocks gate the depth of their last resnet and attention, the
    mid block none. Every block of the configurations served is gated."""
    subs: List[Subblock] = []
    cursor = [0, 0]

    def add(name, kind, widths, depth, channels, heads=0):
        sites = []
        for k, w in widths:
            sites.append(Site(k, cursor[0], w))
            cursor[0] += w
        d = -1
        if depth:
            d = cursor[1]
            cursor[1] += 1
        subs.append(Subblock(name, kind, tuple(sites), d, channels, heads))

    def resnet(name, ch, depth):
        add(name, "resnet", [("resnet", spec.norm_num_groups)], depth, ch)

    def transformer(name, ch, heads, depth):
        add(name, "transformer", [("attn1", heads), ("attn2", heads), ("ff", spec.ff_gate_width)],
            depth, ch, heads)

    L = spec.num_levels
    for i, bt in enumerate(spec.down_block_types):
        if "Gated" not in bt:
            raise ValueError(f"{bt}: the reference serves gated blocks only")
        n = spec.layers_per_block
        flags = [("HalfGated" not in bt) or j == n - 1 for j in range(n)]
        ch = spec.block_out_channels[i]
        for j in range(n):
            resnet(f"down.{i}.resnet.{j}", ch, flags[j])
        if bt.startswith("CrossAttn"):
            for j in range(n):
                transformer(f"down.{i}.attn.{j}", ch, spec.attention_head_dim[i], flags[j])
    mid = spec.block_out_channels[-1]
    resnet("mid.resnet.0", mid, False)
    resnet("mid.resnet.1", mid, False)
    transformer("mid.attn.0", mid, spec.attention_head_dim[L - 1], False)
    rev = list(reversed(spec.block_out_channels))
    for i, bt in enumerate(spec.up_block_types):
        if "Gated" not in bt:
            raise ValueError(f"{bt}: the reference serves gated blocks only")
        n = spec.layers_per_block + 1
        flags = [("HalfGated" not in bt) or j == n - 1 for j in range(n)]
        for j in range(n):
            resnet(f"up.{i}.resnet.{j}", rev[i], flags[j])
        if bt.startswith("CrossAttn"):
            for j in range(n):
                transformer(f"up.{i}.attn.{j}", rev[i], spec.attention_head_dim[L - 1 - i],
                            flags[j])
    return Layout(tuple(subs), cursor[0], cursor[1])


class Gates:
    """Slices of one (B, vq_dim) arch tensor per subblock, or nothing."""

    def __init__(self, layout: Layout, arch: Optional[torch.Tensor]):
        self.subs = layout.by_name()
        self.nw = layout.num_width
        self.arch = arch

    def of(self, name: str):
        """([width gate per site], depth gate or None), or ([], None)."""
        if self.arch is None:
            return [], None
        sb = self.subs[name]
        widths = [self.arch[:, s.start:s.start + s.width] for s in sb.sites]
        depth = self.arch[:, self.nw + sb.depth_index] if sb.depth_index >= 0 else None
        return widths, depth


def expand(gate: torch.Tensor, channels: int) -> torch.Tensor:
    """A (B, width) gate as a (B, channels) mask: unit u covers the
    contiguous slab [u·C/width, (u+1)·C/width)."""
    return torch.repeat_interleave(gate, channels // gate.shape[-1], dim=-1)


def lerp_depth(m: Optional[torch.Tensor], identity, out):
    if m is None:
        return out
    m = m.reshape(-1, *([1] * (out.dim() - 1)))
    return (1.0 - m) * identity + m * out


# ---------------------------------------------------------------- U-Net

def timestep_embedding(t, dim, flip_sin_to_cos=True, freq_shift=0.0):
    half = dim // 2
    exponent = -math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=t.device)
    exponent = exponent / (half - freq_shift)
    emb = t.float()[:, None] * exponent.exp()[None, :]
    sin, cos = emb.sin(), emb.cos()
    return torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)


class _NS(nn.Module):
    """Bare namespace module, for diffusers-style nesting."""


class Resnet(nn.Module):
    def __init__(self, cin, cout, temb_dim, groups, eps):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, cin, eps=eps)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        self.time_emb_proj = nn.Linear(temb_dim, cout)
        self.norm2 = nn.GroupNorm(groups, cout, eps=eps)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        self.conv_shortcut = nn.Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x, temb, gates=(), depth=None, identity=None):
        h = self.conv1(F.silu(self.norm1(x)))
        h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        if gates:
            h = h * expand(gates[0], h.shape[1])[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        sc = x if self.conv_shortcut is None else self.conv_shortcut(x)
        return lerp_depth(depth, x if identity is None else identity, sc + h)


class Attention(nn.Module):
    def __init__(self, dim, heads, ctx_dim=None):
        super().__init__()
        self.heads = heads
        self.to_q = nn.Linear(dim, dim, bias=False)
        self.to_k = nn.Linear(ctx_dim or dim, dim, bias=False)
        self.to_v = nn.Linear(ctx_dim or dim, dim, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(dim, dim)])

    def forward(self, x, ctx=None, gate=None):
        c = x if ctx is None else ctx
        b, s, d = x.shape
        hd = d // self.heads
        q = self.to_q(x).view(b, s, self.heads, hd)
        k = self.to_k(c).view(b, c.shape[1], self.heads, hd)
        v = self.to_v(c).view(b, c.shape[1], self.heads, hd)
        if gate is not None:
            g = gate[:, None, :, None]
            q, k, v = q * g, k * g, v * g
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * hd ** -0.5
        o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, dim=-1), v)
        return self.to_out[0](o.reshape(b, s, d))


class GEGLU(nn.Module):
    def __init__(self, dim, inner):
        super().__init__()
        self.proj = nn.Linear(dim, inner * 2)

    def forward(self, x, gate=None):
        h, g = self.proj(x).chunk(2, dim=-1)
        if gate is not None:
            m = expand(gate, h.shape[-1])[:, None, :]
            h, g = h * m, g * m
        return h * F.gelu(g)


class FeedForward(nn.Module):
    def __init__(self, dim, mult=4):
        super().__init__()
        inner = dim * mult
        self.net = nn.ModuleList([GEGLU(dim, inner), nn.Identity(), nn.Linear(inner, dim)])

    def forward(self, x, gate=None):
        return self.net[2](self.net[0](x, gate))


class TransformerBlock(nn.Module):
    def __init__(self, dim, heads, ctx_dim):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim)
        self.attn1 = Attention(dim, heads)
        self.norm2 = nn.LayerNorm(dim)
        self.attn2 = Attention(dim, heads, ctx_dim)
        self.norm3 = nn.LayerNorm(dim)
        self.ff = FeedForward(dim)

    def forward(self, x, ctx, gates):
        g1, g2, gf = gates if gates else (None, None, None)
        x = x + self.attn1(self.norm1(x), None, g1)
        x = x + self.attn2(self.norm2(x), ctx, g2)
        return x + self.ff(self.norm3(x), gf)


class Transformer2D(nn.Module):
    """The linear-projection spatial transformer of SD-2.x."""

    def __init__(self, dim, heads, ctx_dim, groups):
        super().__init__()
        self.norm = nn.GroupNorm(groups, dim, eps=1e-6)
        self.proj_in = nn.Linear(dim, dim)
        self.transformer_blocks = nn.ModuleList([TransformerBlock(dim, heads, ctx_dim)])
        self.proj_out = nn.Linear(dim, dim)

    def forward(self, x, ctx, gates=(), depth=None):
        b, c, hh, ww = x.shape
        y = self.proj_in(self.norm(x).permute(0, 2, 3, 1).reshape(b, hh * ww, c))
        y = self.transformer_blocks[0](y, ctx, gates)
        y = self.proj_out(y).reshape(b, hh, ww, c).permute(0, 3, 1, 2)
        return lerp_depth(depth, x, y + x)


class UNet(nn.Module):
    """diffusers' UNet2DConditionModel of SD-2.x with the APTP gates."""

    def __init__(self, spec: UNetSpec):
        super().__init__()
        self.spec = spec
        self.layout = gate_layout(spec)
        b0, temb, g = spec.block_out_channels[0], spec.time_embed_dim, spec.norm_num_groups
        self.conv_in = nn.Conv2d(spec.in_channels, b0, 3, padding=1)
        self.time_embedding = _NS()
        self.time_embedding.linear_1 = nn.Linear(b0, temb)
        self.time_embedding.linear_2 = nn.Linear(temb, temb)
        L = spec.num_levels
        ch, stack = b0, [b0]
        self.down_blocks = nn.ModuleList()
        for i, bt in enumerate(spec.down_block_types):
            out, cross = spec.block_out_channels[i], bt.startswith("CrossAttn")
            blk = _NS()
            blk.resnets = nn.ModuleList()
            if cross:
                blk.attentions = nn.ModuleList()
            for _ in range(spec.layers_per_block):
                blk.resnets.append(Resnet(ch, out, temb, g, spec.norm_eps))
                ch = out
                if cross:
                    blk.attentions.append(Transformer2D(out, spec.attention_head_dim[i],
                                                        spec.cross_attention_dim, g))
                stack.append(ch)
            if i < L - 1:
                ds = _NS()
                ds.conv = nn.Conv2d(ch, ch, 3, stride=2, padding=1)
                blk.downsamplers = nn.ModuleList([ds])
                stack.append(ch)
            self.down_blocks.append(blk)
        mid = spec.block_out_channels[-1]
        self.mid_block = _NS()
        self.mid_block.resnets = nn.ModuleList([Resnet(mid, mid, temb, g, spec.norm_eps),
                                                Resnet(mid, mid, temb, g, spec.norm_eps)])
        self.mid_block.attentions = nn.ModuleList([
            Transformer2D(mid, spec.attention_head_dim[L - 1], spec.cross_attention_dim, g)])
        rev = list(reversed(spec.block_out_channels))
        self.up_blocks = nn.ModuleList()
        for i, bt in enumerate(spec.up_block_types):
            out, cross = rev[i], bt.startswith("CrossAttn")
            blk = _NS()
            blk.resnets = nn.ModuleList()
            if cross:
                blk.attentions = nn.ModuleList()
            for _ in range(spec.layers_per_block + 1):
                blk.resnets.append(Resnet(ch + stack.pop(), out, temb, g, spec.norm_eps))
                ch = out
                if cross:
                    blk.attentions.append(Transformer2D(
                        out, spec.attention_head_dim[L - 1 - i], spec.cross_attention_dim, g))
            if i < L - 1:
                us = _NS()
                us.conv = nn.Conv2d(ch, ch, 3, padding=1)
                blk.upsamplers = nn.ModuleList([us])
            self.up_blocks.append(blk)
        self.conv_norm_out = nn.GroupNorm(g, ch, eps=spec.norm_eps)
        self.conv_out = nn.Conv2d(ch, spec.out_channels, 3, padding=1)

    def forward(self, sample, timesteps, ehs, arch=None, return_features=False):
        """sample (B, C, H, W); arch (B, vq_dim) gates or None (dense). With
        `return_features` also the block-distillation features, NCHW: after
        each down level ("d0", ...), after the mid block ("m") and after each
        up level ("u0", ...)."""
        spec = self.spec
        gates = Gates(self.layout, arch)
        t = timestep_embedding(timesteps, spec.block_out_channels[0], spec.flip_sin_to_cos,
                               spec.freq_shift)
        temb = self.time_embedding.linear_2(F.silu(self.time_embedding.linear_1(t)))
        h = self.conv_in(sample)
        stack, feats = [h], {}
        for i, blk in enumerate(self.down_blocks):
            cross = hasattr(blk, "attentions")
            for j, r in enumerate(blk.resnets):
                h = r(h, temb, *gates.of(f"down.{i}.resnet.{j}"))
                if cross:
                    h = blk.attentions[j](h, ehs, *gates.of(f"down.{i}.attn.{j}"))
                stack.append(h)
            if hasattr(blk, "downsamplers"):
                h = blk.downsamplers[0].conv(h)
                stack.append(h)
            feats[f"d{i}"] = h
        mid = self.mid_block
        h = mid.resnets[0](h, temb, *gates.of("mid.resnet.0"))
        h = mid.attentions[0](h, ehs, *gates.of("mid.attn.0"))
        h = mid.resnets[1](h, temb, *gates.of("mid.resnet.1"))
        feats["m"] = h
        for i, blk in enumerate(self.up_blocks):
            cross = hasattr(blk, "attentions")
            for j, r in enumerate(blk.resnets):
                identity = h
                h = r(torch.cat([h, stack.pop()], dim=1), temb, *gates.of(f"up.{i}.resnet.{j}"),
                      identity=identity)
                if cross:
                    h = blk.attentions[j](h, ehs, *gates.of(f"up.{i}.attn.{j}"))
            if hasattr(blk, "upsamplers"):
                h = blk.upsamplers[0].conv(F.interpolate(h, scale_factor=2.0, mode="nearest"))
            feats[f"u{i}"] = h
        out = self.conv_out(F.silu(self.conv_norm_out(h)))
        return (out, feats) if return_features else out


# ---------------------------------------------------------------- CLIP text

class _CLIPLayer(nn.Module):
    def __init__(self, d, inner, eps):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(d, eps=eps)
        self.self_attn = _NS()
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            setattr(self.self_attn, n, nn.Linear(d, d))
        self.layer_norm2 = nn.LayerNorm(d, eps=eps)
        self.mlp = _NS()
        self.mlp.fc1 = nn.Linear(d, inner)
        self.mlp.fc2 = nn.Linear(inner, d)


class CLIPText(nn.Module):
    """Causal pre-LN CLIP text transformer (OpenCLIP ViT-H/14's, exact GELU);
    returns the final-LN hidden states (B, S, D)."""

    def __init__(self, cfg: dict):
        super().__init__()
        d, eps = cfg["hidden_size"], cfg.get("layer_norm_eps", 1e-5)
        self.heads = cfg["num_attention_heads"]
        tm = self.text_model = _NS()
        tm.embeddings = _NS()
        tm.embeddings.token_embedding = nn.Embedding(cfg["vocab_size"], d)
        tm.embeddings.position_embedding = nn.Embedding(cfg["max_position_embeddings"], d)
        tm.encoder = _NS()
        tm.encoder.layers = nn.ModuleList([_CLIPLayer(d, cfg["intermediate_size"], eps)
                                           for _ in range(cfg["num_hidden_layers"])])
        tm.final_layer_norm = nn.LayerNorm(d, eps=eps)

    def forward(self, ids):
        tm = self.text_model
        b, s = ids.shape
        h = tm.embeddings.token_embedding(ids) + tm.embeddings.position_embedding.weight[:s]
        nh, hd = self.heads, h.shape[-1] // self.heads
        causal = torch.full((s, s), float("-inf"), device=h.device).triu(1)
        for layer in tm.encoder.layers:
            x = layer.layer_norm1(h)
            at = layer.self_attn
            q, k, v = (f(x).view(b, s, nh, hd) for f in (at.q_proj, at.k_proj, at.v_proj))
            scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * hd ** -0.5 + causal
            o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, dim=-1), v)
            h = h + at.out_proj(o.reshape(b, s, -1))
            h = h + layer.mlp.fc2(F.gelu(layer.mlp.fc1(layer.layer_norm2(h))))
        return tm.final_layer_norm(h)


# ---------------------------------------------------------------- VAE

class VAEResnet(nn.Module):
    def __init__(self, cin, cout, groups):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, cin, eps=1e-6)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        self.norm2 = nn.GroupNorm(groups, cout, eps=1e-6)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        self.conv_shortcut = nn.Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x):
        h = self.conv2(F.silu(self.norm2(self.conv1(F.silu(self.norm1(x))))))
        return (x if self.conv_shortcut is None else self.conv_shortcut(x)) + h


class VAEAttention(nn.Module):
    def __init__(self, ch, groups):
        super().__init__()
        self.group_norm = nn.GroupNorm(groups, ch, eps=1e-6)
        self.to_q = nn.Linear(ch, ch)
        self.to_k = nn.Linear(ch, ch)
        self.to_v = nn.Linear(ch, ch)
        self.to_out = nn.ModuleList([nn.Linear(ch, ch)])

    def forward(self, x):
        b, c, hh, ww = x.shape
        y = self.group_norm(x).permute(0, 2, 3, 1).reshape(b, hh * ww, c)
        q, k, v = self.to_q(y), self.to_k(y), self.to_v(y)
        p = torch.softmax(torch.einsum("bqc,bkc->bqk", q, k) * c ** -0.5, dim=-1)
        o = self.to_out[0](torch.einsum("bqk,bkc->bqc", p, v))
        return x + o.reshape(b, hh, ww, c).permute(0, 3, 1, 2)


class VAE(nn.Module):
    """diffusers' AutoencoderKL of SD (encoder and decoder)."""

    def __init__(self, cfg: dict):
        super().__init__()
        g, chs = cfg["norm_num_groups"], list(cfg["block_out_channels"])
        lat, lpb, n = cfg["latent_channels"], cfg["layers_per_block"], len(chs)
        self.scaling_factor = cfg["scaling_factor"]
        enc = self.encoder = _NS()
        enc.conv_in = nn.Conv2d(cfg.get("in_channels", 3), chs[0], 3, padding=1)
        enc.down_blocks = nn.ModuleList()
        ch = chs[0]
        for i, out in enumerate(chs):
            blk = _NS()
            blk.resnets = nn.ModuleList()
            for _ in range(lpb):
                blk.resnets.append(VAEResnet(ch, out, g))
                ch = out
            if i < n - 1:
                ds = _NS()
                ds.conv = nn.Conv2d(ch, ch, 3, stride=2, padding=0)
                blk.downsamplers = nn.ModuleList([ds])
            enc.down_blocks.append(blk)
        enc.mid_block = self._mid(ch, g)
        enc.conv_norm_out = nn.GroupNorm(g, ch, eps=1e-6)
        enc.conv_out = nn.Conv2d(ch, 2 * lat, 3, padding=1)
        self.quant_conv = nn.Conv2d(2 * lat, 2 * lat, 1)
        self.post_quant_conv = nn.Conv2d(lat, lat, 1)
        dec = self.decoder = _NS()
        dec.conv_in = nn.Conv2d(lat, chs[-1], 3, padding=1)
        dec.mid_block = self._mid(chs[-1], g)
        dec.up_blocks = nn.ModuleList()
        ch = chs[-1]
        for i, out in enumerate(reversed(chs)):
            blk = _NS()
            blk.resnets = nn.ModuleList()
            for _ in range(lpb + 1):
                blk.resnets.append(VAEResnet(ch, out, g))
                ch = out
            if i < n - 1:
                us = _NS()
                us.conv = nn.Conv2d(ch, ch, 3, padding=1)
                blk.upsamplers = nn.ModuleList([us])
            dec.up_blocks.append(blk)
        dec.conv_norm_out = nn.GroupNorm(g, ch, eps=1e-6)
        dec.conv_out = nn.Conv2d(ch, cfg.get("in_channels", 3), 3, padding=1)

    @staticmethod
    def _mid(ch, g):
        mid = _NS()
        mid.resnets = nn.ModuleList([VAEResnet(ch, ch, g), VAEResnet(ch, ch, g)])
        mid.attentions = nn.ModuleList([VAEAttention(ch, g)])
        return mid

    def encode(self, x, eps):
        """(B, 3, H, W) images in about [-1, 1] → scaled latents (B, 4, h, w):
        the diagonal Gaussian's sample mean + exp(logvar / 2)·eps."""
        e = self.encoder
        h = e.conv_in(x)
        for blk in e.down_blocks:
            for r in blk.resnets:
                h = r(h)
            if hasattr(blk, "downsamplers"):
                h = blk.downsamplers[0].conv(F.pad(h, (0, 1, 0, 1)))
        h = e.mid_block.resnets[0](h)
        h = e.mid_block.attentions[0](h)
        h = e.mid_block.resnets[1](h)
        mean, logvar = self.quant_conv(e.conv_out(F.silu(e.conv_norm_out(h)))).chunk(2, dim=1)
        return (mean + torch.exp(0.5 * logvar.clamp(-30.0, 20.0)) * eps) * self.scaling_factor

    def decode(self, z):
        """(B, 4, h, w) scaled latents → (B, 3, 8h, 8w) in about [-1, 1]."""
        d = self.decoder
        h = d.conv_in(self.post_quant_conv(z / self.scaling_factor))
        h = d.mid_block.resnets[0](h)
        h = d.mid_block.attentions[0](h)
        h = d.mid_block.resnets[1](h)
        for blk in d.up_blocks:
            for r in blk.resnets:
                h = r(h)
            if hasattr(blk, "upsamplers"):
                h = blk.upsamplers[0].conv(F.interpolate(h, scale_factor=2.0, mode="nearest"))
        return d.conv_out(F.silu(d.conv_norm_out(h)))


# ---------------------------------------------------------------- routing

def route(noise: torch.Tensor, codebook_gs: torch.Tensor, layout: Layout, temperature: float,
          base: float, depth_order: Optional[Sequence[int]]) -> torch.Tensor:
    """The quantizer's eval route of each row of routing noise (N, vq_dim):
    gumbel-sigmoid gates, then the code of highest cosine against the
    codebook snapshot `codebook_gs` (K, vq_dim), both normalised as APTP
    normalises them. The hypernet's logits are left out: the routing noise
    the benchmark sends is ±1e3 a gate, and a logit of the hypernet (a few
    units) or of the depth ranking (at most 14 in size) cannot change a
    sigmoid it drives to exactly 0 or 1."""
    nw, nd = layout.num_width, layout.num_depth
    noise = noise.float()
    yw = torch.sigmoid((noise[:, :nw] + base) / temperature)
    # a width group whose gates all close reopens its first unit
    for sb in layout.subblocks:
        for s in sb.sites:
            sl = slice(s.start, s.start + s.width)
            dead = ((yw[:, sl] >= 0.5).sum(dim=1) == 0).float()
            yw[:, s.start] = yw[:, s.start] + 0.5 * dead
    x = torch.flip(torch.cumsum(torch.full((noise.shape[0], nd), 1.0 / nd, device=noise.device),
                                dim=1), dims=(1,))
    x = torch.log(x + 1e-6) - torch.log1p(-(x - 1e-6))
    yd = torch.sigmoid((x + noise[:, nw:] + base) / temperature)
    order = [i % nd for i in (depth_order if depth_order is not None else range(nd))]
    inv = np.empty(nd, dtype=np.int64)
    inv[np.asarray(order)] = np.arange(nd)
    gates = torch.cat([yw, yd[:, torch.as_tensor(inv, device=noise.device)]], dim=1)

    template = torch.ones(layout.vq_dim, device=noise.device)
    soft = torch.zeros(layout.vq_dim, dtype=torch.bool, device=noise.device)
    depth_col = torch.zeros(layout.vq_dim, dtype=torch.long, device=noise.device)
    for sb in layout.subblocks:
        for s in sb.sites:
            template[s.start:s.start + s.width] = 1.0 / math.sqrt(s.width)
        if sb.depth_index >= 0:
            lo, last = sb.sites[0].start, sb.sites[-1]
            soft[lo:last.start + last.width] = True
            depth_col[lo:last.start + last.width] = nw + sb.depth_index

    def normalise(g):
        out = torch.where(soft, g * g[:, depth_col], (g >= 0.5).float()) * template
        return out / torch.linalg.norm(out, dim=-1, keepdim=True)

    return torch.argmax(normalise(gates) @ normalise(codebook_gs.float()).T, dim=-1)


# ---------------------------------------------------------------- sampling

def alphas_cumprod(sched: dict) -> np.ndarray:
    betas = np.linspace(sched["beta_start"] ** 0.5, sched["beta_end"] ** 0.5,
                        sched["num_train_timesteps"], dtype=np.float64) ** 2
    return np.cumprod(1.0 - betas).astype(np.float32)


def ddim_timesteps(steps: int, train_steps: int, offset: int) -> List[int]:
    """Leading spacing with `steps_offset` (SD's DDIM)."""
    ratio = train_steps // steps
    return [int(t) for t in ((np.arange(steps) * ratio).round().astype(np.int64) + offset)[::-1]]


@torch.no_grad()
def ddim_cfg(unet: UNet, ehs: torch.Tensor, arch: torch.Tensor, latents: torch.Tensor,
             sched: dict, steps: int, guidance: float) -> torch.Tensor:
    """η = 0 DDIM with classifier-free guidance; `ehs` holds the negative
    rows, then the prompt rows; latents (B, C, h, w)."""
    ac = alphas_cumprod(sched)
    ratio = sched["num_train_timesteps"] // steps
    x = latents.float()
    arch2 = torch.cat([arch, arch])
    for t in ddim_timesteps(steps, sched["num_train_timesteps"], sched["steps_offset"]):
        tb = torch.full((2 * x.shape[0],), t, dtype=torch.long, device=x.device)
        uncond, cond = unet(torch.cat([x, x]), tb, ehs, arch2).chunk(2)
        out = uncond + guidance * (cond - uncond)
        a = float(ac[t])
        sa, so = a ** 0.5, (1.0 - a) ** 0.5
        if sched["prediction_type"] == "epsilon":
            eps, x0 = out, (x - so * out) / sa
        else:
            x0, eps = sa * x - so * out, sa * out + so * x
        a_prev = float(ac[t - ratio]) if t - ratio >= 0 else float(ac[0])
        x = a_prev ** 0.5 * x0 + (1.0 - a_prev) ** 0.5 * eps
    return x


@torch.no_grad()
def serve(unet: UNet, clip: CLIPText, vae: VAE, ids: torch.Tensor, neg_ids: torch.Tensor,
          codes: torch.Tensor, latents: torch.Tensor, config: dict) -> torch.Tensor:
    """Images (N, H, W, 3) in [0, 1] of N prompts: ids (N, 77), one negative
    prompt (1, 77), each row's hard code (N, vq_dim), initial latents
    (N, h, w, C) as the program takes them (NHWC)."""
    s = config["serving"]
    n = ids.shape[0]
    pe = clip(ids)
    ne = clip(neg_ids).expand(n, -1, -1)
    x = ddim_cfg(unet, torch.cat([ne, pe]), codes.float(), latents.permute(0, 3, 1, 2),
                 config["scheduler"], s["num_inference_steps"], s["guidance_scale"])
    images = vae.decode(x).permute(0, 2, 3, 1)
    return torch.clamp(images / 2 + 0.5, 0.0, 1.0)


# ---------------------------------------------------------------- precision

@contextlib.contextmanager
def float32_matmuls():
    """Float32 products and convolutions without TF32, for the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def fake_fp8(x: torch.Tensor, channel_dim: Optional[int] = None) -> torch.Tensor:
    """x rounded through float8 e4m3 with a scale that maps its largest
    magnitude (per tensor, or per index of `channel_dim`) to 448."""
    if channel_dim is None:
        amax = x.abs().amax()
    else:
        dims = [d for d in range(x.dim()) if d != channel_dim]
        amax = x.abs().amax(dim=dims, keepdim=True)
    scale = amax.clamp_min(1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


@torch.no_grad()
def to_fp8_(module: nn.Module) -> nn.Module:
    """The precision control: every nn.Linear and nn.Conv2d of `module`
    takes weights rounded through float8 per output channel and inputs
    rounded through float8 per tensor."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            m.weight.copy_(fake_fp8(m.weight, 0))
            m.register_forward_pre_hook(lambda mod, args: (fake_fp8(args[0]),) + args[1:])
    return module

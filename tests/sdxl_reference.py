"""Plain PyTorch reference of routed SDXL serving, in float32 (not a test
module).

Stable Diffusion XL base 1.0 as diffusers and Hugging Face compute it, with
the APTP gates of the SD-2.x reference, written from the published model
code with nothing of the port imported:

* the U-Net (`UNet2DConditionModel` of `unet/config.json`): levels of 320,
  640 and 1280 channels, no attention at level 0, `transformer_layers_per_
  block` transformer layers stacked in each `Transformer2D` (1, 2 and 10;
  the mid block takes the last level's count, the up blocks the reversed
  counts), and the "text_time" added condition: bigG's pooled, projected
  text embedding and the sinusoidal features of six size and crop ids,
  through `add_embedding` (linear, SiLU, linear) into the time embedding;
* the APTP gates: a resnet width gate after conv1 plus the time embedding,
  one unit per norm2 group; per stacked layer, q, k and v multiplied per
  head by the head's gate (attn1 and attn2) and both GEGLU halves masked a
  unit per contiguous slab of the inner width; one depth gate per
  `Transformer2D` (the whole stack) and per resnet, out = (1 - m) *
  identity + m * block_out, the identity of an up-block resnet being the
  hidden state before the skip concat;
* the text towers: CLIP ViT-L/14 (quick GELU) on the ids re-padded with
  EOS, as SDXL's first tokenizer pads, and OpenCLIP ViT-bigG/14 (exact
  GELU) on the ids as given; each gives its penultimate hidden states (HF's
  `hidden_states[-2]`, no final LN), concatenated to 768 + 1280 = 2048
  wide; bigG's final-LN state at the EOS position (the argmax of the ids)
  through `text_projection` is the pooled embedding;
* classifier-free-guided DDIM (eta 0, "leading" spacing with
  `steps_offset`) and the VAE decode.

Departures from diffusers, each deliberate:

* DDIM stands in for the published Euler scheduler (the port serves DDIM);
* the negative prompt is empty and `force_zeros_for_empty_prompt` holds, so
  its states and pooled embedding are zeros (its time ids are the prompt's);
* the gates are APTP's, which diffusers does not have; under an all-ones
  code (or none) the U-Net is diffusers' own;
* the VAE runs in the module's dtype (float32 here); the published
  `force_upcast` changes nothing in float32.

Module and parameter names follow diffusers' and Hugging Face's state
dicts, so a state dict of the same names loads as it is.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

CLIP_EOS = 49407


# ---------------------------------------------------------------- configuration

@dataclasses.dataclass(frozen=True)
class SDXLSpec:
    """The gated SDXL U-Net's shape."""
    sample_size: int = 128
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280)
    layers_per_block: int = 2
    attention_head_dim: Tuple[int, ...] = (5, 10, 20)      # heads per level (diffusers naming)
    transformer_layers_per_block: Tuple[int, ...] = (1, 2, 10)
    cross_attention_dim: int = 2048
    norm_num_groups: int = 32
    norm_eps: float = 1e-5
    flip_sin_to_cos: bool = True
    freq_shift: int = 0
    down_block_types: Tuple[str, ...] = ("DownBlock2DHalfGated", "CrossAttnDownBlock2DHalfGated",
                                         "CrossAttnDownBlock2DHalfGated")
    up_block_types: Tuple[str, ...] = ("CrossAttnUpBlock2DHalfGated",
                                       "CrossAttnUpBlock2DHalfGated", "UpBlock2DHalfGated")
    ff_gate_width: int = 32
    addition_time_embed_dim: int = 256
    projection_class_embeddings_input_dim: int = 2816
    ff_mult: int = 4
    max_text_len: int = 77

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4

    @property
    def num_levels(self) -> int:
        return len(self.block_out_channels)


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
    sites: Tuple[Site, ...]    # a transformer's: (attn1, attn2, ff) per stacked layer
    depth_index: int           # -1: no depth gate
    channels: int              # output channels
    heads: int = 0
    layers: int = 0            # stacked transformer layers


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


def gate_layout(spec: SDXLSpec) -> Layout:
    """APTP's flat arch vector: width logits in subblock order (per block its
    resnets, then its attentions; down blocks, the mid block, up blocks; a
    transformer's sites layer by layer), then one depth logit per
    depth-gated subblock in that order. "HalfGated" blocks gate the depth
    of their last resnet and attention, the mid block none."""
    subs: List[Subblock] = []
    cursor = [0, 0]

    def add(name, kind, widths, depth, channels, heads=0, layers=0):
        sites = []
        for k, w in widths:
            sites.append(Site(k, cursor[0], w))
            cursor[0] += w
        d = -1
        if depth:
            d = cursor[1]
            cursor[1] += 1
        subs.append(Subblock(name, kind, tuple(sites), d, channels, heads, layers))

    def resnet(name, ch, depth):
        add(name, "resnet", [("resnet", spec.norm_num_groups)], depth, ch)

    def transformer(name, ch, heads, layers, depth):
        add(name, "transformer",
            [(k, w) for _ in range(layers)
             for k, w in (("attn1", heads), ("attn2", heads), ("ff", spec.ff_gate_width))],
            depth, ch, heads, layers)

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
                transformer(f"down.{i}.attn.{j}", ch, spec.attention_head_dim[i],
                            spec.transformer_layers_per_block[i], flags[j])
    mid = spec.block_out_channels[-1]
    resnet("mid.resnet.0", mid, False)
    resnet("mid.resnet.1", mid, False)
    transformer("mid.attn.0", mid, spec.attention_head_dim[L - 1],
                spec.transformer_layers_per_block[L - 1], False)
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
                            spec.transformer_layers_per_block[L - 1 - i], flags[j])
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


class TimestepEmbedding(nn.Module):
    def __init__(self, din, dout):
        super().__init__()
        self.linear_1 = nn.Linear(din, dout)
        self.linear_2 = nn.Linear(dout, dout)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


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
    """diffusers' BasicTransformerBlock: self-attention, cross-attention,
    GEGLU feed-forward, each pre-LN with a residual."""

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
    """The linear-projection spatial transformer with `layers` stacked
    transformer blocks."""

    def __init__(self, dim, heads, ctx_dim, groups, layers):
        super().__init__()
        self.norm = nn.GroupNorm(groups, dim, eps=1e-6)
        self.proj_in = nn.Linear(dim, dim)
        self.transformer_blocks = nn.ModuleList([TransformerBlock(dim, heads, ctx_dim)
                                                 for _ in range(layers)])
        self.proj_out = nn.Linear(dim, dim)

    def forward(self, x, ctx, gates=(), depth=None):
        b, c, hh, ww = x.shape
        y = self.proj_in(self.norm(x).permute(0, 2, 3, 1).reshape(b, hh * ww, c))
        for k, block in enumerate(self.transformer_blocks):
            y = block(y, ctx, tuple(gates[3 * k:3 * k + 3]))
        y = self.proj_out(y).reshape(b, hh, ww, c).permute(0, 3, 1, 2)
        return lerp_depth(depth, x, y + x)


class UNet(nn.Module):
    """diffusers' UNet2DConditionModel of SDXL with the APTP gates."""

    def __init__(self, spec: SDXLSpec):
        super().__init__()
        self.spec = spec
        self.layout = gate_layout(spec)
        b0, temb, g = spec.block_out_channels[0], spec.time_embed_dim, spec.norm_num_groups
        layers = spec.transformer_layers_per_block
        self.conv_in = nn.Conv2d(spec.in_channels, b0, 3, padding=1)
        self.time_embedding = TimestepEmbedding(b0, temb)
        self.add_embedding = TimestepEmbedding(spec.projection_class_embeddings_input_dim, temb)
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
                                                        spec.cross_attention_dim, g, layers[i]))
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
            Transformer2D(mid, spec.attention_head_dim[L - 1], spec.cross_attention_dim, g,
                          layers[L - 1])])
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
                        out, spec.attention_head_dim[L - 1 - i], spec.cross_attention_dim, g,
                        layers[L - 1 - i]))
            if i < L - 1:
                us = _NS()
                us.conv = nn.Conv2d(ch, ch, 3, padding=1)
                blk.upsamplers = nn.ModuleList([us])
            self.up_blocks.append(blk)
        self.conv_norm_out = nn.GroupNorm(g, ch, eps=spec.norm_eps)
        self.conv_out = nn.Conv2d(ch, spec.out_channels, 3, padding=1)

    def forward(self, sample, timesteps, ehs, text_embeds, time_ids, arch=None):
        """sample (B, C, H, W); ehs (B, 77, 2048); text_embeds (B, 1280) the
        pooled embedding; time_ids (B, 6); arch (B, vq_dim) gates or None
        (dense)."""
        spec = self.spec
        gates = Gates(self.layout, arch)
        t = timestep_embedding(timesteps, spec.block_out_channels[0], spec.flip_sin_to_cos,
                               spec.freq_shift)
        temb = self.time_embedding(t)
        tid = timestep_embedding(time_ids.reshape(-1), spec.addition_time_embed_dim,
                                 spec.flip_sin_to_cos, spec.freq_shift)
        added = torch.cat([text_embeds.float(), tid.reshape(time_ids.shape[0], -1)], dim=-1)
        temb = temb + self.add_embedding(added)
        h = self.conv_in(sample)
        stack = [h]
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
        mid = self.mid_block
        h = mid.resnets[0](h, temb, *gates.of("mid.resnet.0"))
        h = mid.attentions[0](h, ehs, *gates.of("mid.attn.0"))
        h = mid.resnets[1](h, temb, *gates.of("mid.resnet.1"))
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
        return self.conv_out(F.silu(self.conv_norm_out(h)))


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
    """HF's CLIPTextModel (with `projection_dim`: CLIPTextModelWithProjection):
    causal pre-LN transformer, `hidden_act` gelu or quick_gelu."""

    def __init__(self, cfg: dict):
        super().__init__()
        d, eps = cfg["hidden_size"], cfg.get("layer_norm_eps", 1e-5)
        self.heads = cfg["num_attention_heads"]
        self.quick = cfg["hidden_act"] == "quick_gelu"
        tm = self.text_model = _NS()
        tm.embeddings = _NS()
        tm.embeddings.token_embedding = nn.Embedding(cfg["vocab_size"], d)
        tm.embeddings.position_embedding = nn.Embedding(cfg["max_position_embeddings"], d)
        tm.encoder = _NS()
        tm.encoder.layers = nn.ModuleList([_CLIPLayer(d, cfg["intermediate_size"], eps)
                                           for _ in range(cfg["num_hidden_layers"])])
        tm.final_layer_norm = nn.LayerNorm(d, eps=eps)
        if cfg.get("projection_dim"):
            self.text_projection = nn.Linear(d, cfg["projection_dim"], bias=False)

    def hidden_states(self, ids) -> List[torch.Tensor]:
        """HF's `hidden_states`: the embeddings, then the stream after each
        layer."""
        tm = self.text_model
        b, s = ids.shape
        h = tm.embeddings.token_embedding(ids) + tm.embeddings.position_embedding.weight[:s]
        nh, hd = self.heads, h.shape[-1] // self.heads
        causal = torch.full((s, s), float("-inf"), device=h.device).triu(1)
        out = [h]
        for layer in tm.encoder.layers:
            x = layer.layer_norm1(h)
            at = layer.self_attn
            q, k, v = (f(x).view(b, s, nh, hd) for f in (at.q_proj, at.k_proj, at.v_proj))
            scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * hd ** -0.5 + causal
            o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, dim=-1), v)
            h = h + at.out_proj(o.reshape(b, s, -1))
            m = layer.mlp.fc1(layer.layer_norm2(h))
            m = m * torch.sigmoid(1.702 * m) if self.quick else F.gelu(m)
            h = h + layer.mlp.fc2(m)
            out.append(h)
        return out

    def pooled(self, ids, last: torch.Tensor) -> torch.Tensor:
        """The final-LN state at each row's EOS (the argmax of the ids)
        through `text_projection`."""
        h = self.text_model.final_layer_norm(last)
        return self.text_projection(h[torch.arange(h.shape[0], device=h.device),
                                      ids.argmax(dim=-1)])


def eos_padded(ids: torch.Tensor) -> torch.Tensor:
    """Every position from the first EOS on set to EOS."""
    after = torch.cumsum((ids == CLIP_EOS).long(), dim=1) > 0
    return torch.where(after, torch.full_like(ids, CLIP_EOS), ids)


def encode(clip_l: CLIPText, clip_g: CLIPText, ids: torch.Tensor):
    """SDXL's prompt conditioning of ids (N, 77) padded with 0 after EOS:
    (states (N, 77, 2048), pooled (N, 1280))."""
    states_l = clip_l.hidden_states(eos_padded(ids))[-2]
    hs_g = clip_g.hidden_states(ids)
    return torch.cat([states_l, hs_g[-2]], dim=-1), clip_g.pooled(ids, hs_g[-1])


def time_ids(resolution: int, n: int, device) -> torch.Tensor:
    """(original size, crop top-left, target size), all at the resolution."""
    r = float(resolution)
    return torch.tensor([[r, r, 0.0, 0.0, r, r]], device=device).expand(n, 6)


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
    """diffusers' AutoencoderKL (encoder and decoder; `decode` is used)."""

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


# ---------------------------------------------------------------- sampling

def alphas_cumprod(sched: dict) -> np.ndarray:
    betas = np.linspace(sched["beta_start"] ** 0.5, sched["beta_end"] ** 0.5,
                        sched["num_train_timesteps"], dtype=np.float64) ** 2
    return np.cumprod(1.0 - betas).astype(np.float32)


def ddim_timesteps(steps: int, train_steps: int, offset: int) -> List[int]:
    """Leading spacing with `steps_offset`."""
    ratio = train_steps // steps
    return [int(t) for t in ((np.arange(steps) * ratio).round().astype(np.int64) + offset)[::-1]]


@torch.no_grad()
def ddim_cfg(unet: UNet, ehs, pooled, tids, arch: Optional[torch.Tensor],
             latents: torch.Tensor, sched: dict, steps: int, guidance: float) -> torch.Tensor:
    """eta = 0 DDIM with classifier-free guidance; `ehs`, `pooled` and `tids`
    hold the negative rows, then the prompt rows; latents (B, C, h, w)."""
    ac = alphas_cumprod(sched)
    ratio = sched["num_train_timesteps"] // steps
    x = latents.float()
    arch2 = None if arch is None else torch.cat([arch, arch])
    for t in ddim_timesteps(steps, sched["num_train_timesteps"], sched["steps_offset"]):
        tb = torch.full((2 * x.shape[0],), t, dtype=torch.long, device=x.device)
        uncond, cond = unet(torch.cat([x, x]), tb, ehs, pooled, tids, arch2).chunk(2)
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
def serve(unet: UNet, clip_l: CLIPText, clip_g: CLIPText, vae: VAE, ids: torch.Tensor,
          codes: Optional[torch.Tensor], latents: torch.Tensor, sched: dict, steps: int,
          guidance: float, resolution: int) -> torch.Tensor:
    """Images (N, H, W, 3) in [0, 1] of N prompts: ids (N, 77) padded with 0,
    the empty negative prompt as zeros, each row's hard code (N, vq_dim) or
    None (dense), initial latents (N, h, w, C) (NHWC)."""
    n = ids.shape[0]
    states, pooled = encode(clip_l, clip_g, ids)
    tids = time_ids(resolution, 2 * n, ids.device)
    ehs = torch.cat([torch.zeros_like(states), states])
    pooled2 = torch.cat([torch.zeros_like(pooled), pooled])
    x = ddim_cfg(unet, ehs, pooled2, tids, None if codes is None else codes.float(),
                 latents.permute(0, 3, 1, 2), sched, steps, guidance)
    images = vae.decode(x).permute(0, 2, 3, 1)
    return torch.clamp(images / 2 + 0.5, 0.0, 1.0)


@contextlib.contextmanager
def float32_matmuls():
    """Float32 products and convolutions without TF32, for the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved

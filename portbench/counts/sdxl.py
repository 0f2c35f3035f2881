"""Operations of the SDXL U-Net family (`reference/sdxl.py`), counted from
its shapes with the primitives of `harness/flops.py`: each `Transformer2D`
holds `transformer_layers_per_block` layers, each with its own kept heads
and GEGLU units; the U-Net adds `add_embedding`; the text conditioning is
CLIP ViT-L/14 to its penultimate layer (11 of 12 layers run) and
OpenCLIP ViT-bigG/14 (all 32, and `text_projection`), of the prompt alone:
the empty negative prompt is zeros and runs no encoder. Imports nothing of
the port."""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from portbench.harness.flops import (clip_text_flops, conv, is_dropped, kept, linear,
                                     vae_decode_flops)


def _levels(spec):
    """(subblock name -> spatial side, resnet name -> input channels)."""
    s, L = spec.sample_size, spec.num_levels
    side, cin = {}, {}
    ch, skips = spec.block_out_channels[0], [spec.block_out_channels[0]]
    for i in range(L):
        out = spec.block_out_channels[i]
        for j in range(spec.layers_per_block):
            side[f"down.{i}.resnet.{j}"] = side[f"down.{i}.attn.{j}"] = s >> i
            cin[f"down.{i}.resnet.{j}"] = ch
            ch = out
            skips.append(ch)
        if i < L - 1:
            skips.append(ch)
    for n in ("mid.resnet.0", "mid.resnet.1", "mid.attn.0"):
        side[n] = s >> (L - 1)
        cin[n] = ch
    rev = list(reversed(spec.block_out_channels))
    for i in range(L):
        for j in range(spec.layers_per_block + 1):
            side[f"up.{i}.resnet.{j}"] = side[f"up.{i}.attn.{j}"] = s >> (L - 1 - i)
            cin[f"up.{i}.resnet.{j}"] = ch + skips.pop()
            ch = rev[i]
    return side, cin


def _layers(sb):
    """A transformer subblock's sites as (attn1, attn2, ff) per stacked layer."""
    return [sb.sites[k:k + 3] for k in range(0, len(sb.sites), 3)]


def unet_forward_flops(spec, layout, code: Optional[torch.Tensor], batch: int) -> float:
    """One U-Net forward over `batch` rows at the widths `code` keeps
    (None: the dense U-Net)."""
    side, cin = _levels(spec)
    temb, b0, L = spec.time_embed_dim, spec.block_out_channels[0], spec.num_levels
    s = spec.sample_size
    total = conv(3, spec.in_channels, b0, s * s) + conv(3, b0, spec.out_channels, s * s)
    total += linear(1, b0, temb) + linear(1, temb, temb)
    total += linear(1, spec.projection_class_embeddings_input_dim, temb) + linear(1, temb, temb)
    for i in range(L - 1):  # downsamplers (stride 2) and upsamplers (after nearest 2×)
        c = spec.block_out_channels[i]
        total += conv(3, c, c, (s >> (i + 1)) ** 2)
        cu = spec.block_out_channels[L - 1 - i]
        total += conv(3, cu, cu, (s >> (L - 2 - i)) ** 2)
    for sb in layout.subblocks:
        if is_dropped(code, layout, sb):
            continue
        hw = side[sb.name] ** 2
        c = sb.channels
        if sb.kind == "resnet":
            hidden = kept(code, sb.sites[0]) * (c // sb.sites[0].width)
            total += conv(3, cin[sb.name], hidden, hw) + linear(1, temb, hidden)
            total += conv(3, hidden, c, hw)
            if cin[sb.name] != c:
                total += conv(1, cin[sb.name], c, hw)
            continue
        head, ctx = c // sb.heads, spec.max_text_len
        total += 2 * linear(hw, c, c)                                   # proj_in, proj_out
        for a1, a2, ff_site in _layers(sb):
            i1, i2 = kept(code, a1) * head, kept(code, a2) * head
            ff = kept(code, ff_site) * (spec.ff_mult * c // ff_site.width)
            total += 3 * linear(hw, c, i1) + 4.0 * hw * hw * i1 + linear(hw, i1, c)
            total += linear(hw, c, i2) + 2 * linear(ctx, spec.cross_attention_dim, i2)
            total += 4.0 * hw * ctx * i2 + linear(hw, i2, c)
            total += linear(hw, c, 2 * ff) + linear(hw, ff, c)
    return batch * total


def attention_calls(spec, layout, code: Optional[torch.Tensor], batch: int
                    ) -> List[Tuple[int, int, int, int]]:
    """(B, heads, S_q, S_kv) of every attention call of one U-Net forward
    over `batch` rows at the heads `code` keeps: each stacked layer's self
    and cross call; a site with no head kept makes no call."""
    side, _ = _levels(spec)
    calls = []
    for sb in layout.subblocks:
        if sb.kind != "transformer" or is_dropped(code, layout, sb):
            continue
        hw = side[sb.name] ** 2
        for a1, a2, _ in _layers(sb):
            for site, s_kv in ((a1, hw), (a2, spec.max_text_len)):
                h = kept(code, site)
                if h:
                    calls.append((batch, h, hw, s_kv))
    return calls


def text_flops(config: Dict, rows: int) -> float:
    """SDXL's text conditioning of `rows` prompts: CLIP-L's first 11 layers,
    bigG's 32 and its projection of the pooled feature."""
    clip_l = dict(config["text_encoder"])
    clip_l["num_hidden_layers"] -= 1
    g = config["text_encoder_2"]
    return (clip_text_flops(clip_l, rows) + clip_text_flops(g, rows)
            + linear(rows, g["hidden_size"], g["projection_dim"]))


def request_flops(config: Dict, spec, layout, code: Optional[torch.Tensor], steps: int
                  ) -> Tuple[float, ...]:
    """Model products of one served request, as the terms
    `readings.served_flops` adds in turn: the CFG pair of U-Net forwards at
    the widths `code` keeps at each of `steps` sampler steps, the text
    conditioning of the prompt (an empty negative prompt runs no encoder,
    another is encoded too), the VAE decode."""
    prompts = 1 if config["serving"]["negative_prompt"] == "" else 2
    return (steps * unet_forward_flops(spec, layout, code, 2), text_flops(config, prompts),
            vae_decode_flops(config["vae"], spec.sample_size, 1))


def stage1_step_flops(config: Dict, spec, layout, batch: int) -> float:
    raise ValueError("the model family 'sdxl' has no stage-1 cell (STAGE1 is None)")

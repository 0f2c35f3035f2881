"""Operations of the SD-2.x U-Net family (`reference/sd.py`), counted from
its shapes with the primitives of `harness/flops.py`: one transformer layer
at each attention site, one CLIP text encoder. Imports nothing of the
port."""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from portbench.harness.flops import (attention_flops, clip_text_flops, conv, is_dropped, kept,
                                     linear, vae_decode_flops, vae_encode_flops)


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


def unet_forward_flops(spec, layout, code: Optional[torch.Tensor], batch: int) -> float:
    """One U-Net forward over `batch` rows at the widths `code` keeps
    (None: the dense U-Net)."""
    side, cin = _levels(spec)
    temb, b0, L = spec.time_embed_dim, spec.block_out_channels[0], spec.num_levels
    s = spec.sample_size
    total = conv(3, spec.in_channels, b0, s * s) + conv(3, b0, spec.out_channels, s * s)
    total += linear(1, b0, temb) + linear(1, temb, temb)
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
        else:
            head = c // sb.heads
            i1 = kept(code, sb.sites[0]) * head
            i2 = kept(code, sb.sites[1]) * head
            ff = kept(code, sb.sites[2]) * (spec.ff_mult * c // sb.sites[2].width)
            ctx = spec.max_text_len
            total += 2 * linear(hw, c, c)                                   # proj_in, proj_out
            total += 3 * linear(hw, c, i1) + 4.0 * hw * hw * i1 + linear(hw, i1, c)
            total += linear(hw, c, i2) + 2 * linear(ctx, spec.cross_attention_dim, i2)
            total += 4.0 * hw * ctx * i2 + linear(hw, i2, c)
            total += linear(hw, c, 2 * ff) + linear(hw, ff, c)
    return batch * total


def attention_calls(spec, layout, code: Optional[torch.Tensor], batch: int
                    ) -> List[Tuple[int, int, int, int]]:
    """(B, heads, S_q, S_kv) of every attention call of one U-Net forward
    over `batch` rows at the heads `code` keeps; a site with no head kept
    makes no call."""
    side, _ = _levels(spec)
    calls = []
    for sb in layout.subblocks:
        if sb.kind != "transformer" or is_dropped(code, layout, sb):
            continue
        hw = side[sb.name] ** 2
        for site, s_kv in ((sb.sites[0], hw), (sb.sites[1], spec.max_text_len)):
            h = kept(code, site)
            if h:
                calls.append((batch, h, hw, s_kv))
    return calls



def request_flops(config: Dict, spec, layout, code: Optional[torch.Tensor], steps: int
                  ) -> Tuple[float, ...]:
    """Model products of one served request, as the terms
    `readings.served_flops` adds in turn: the CFG pair of U-Net forwards at
    the widths `code` keeps at each of `steps` sampler steps, CLIP text of
    the prompt and the negative prompt, the VAE decode."""
    return (steps * unet_forward_flops(spec, layout, code, 2),
            clip_text_flops(config["text_encoder"], 2),
            vae_decode_flops(config["vae"], spec.sample_size, 1))


def stage1_step_flops(config: Dict, spec, layout, batch: int) -> float:
    """Model products of one stage-1 step over `batch` rows: CLIP text, the
    VAE encode, the dense teacher forward, the gated student forward at full
    width, and the student's backward counted as activation gradients only
    (the U-Net is frozen): the forward's products again, plus two more
    products per attention call (dQ, dK, dV and dP against QKᵀ and PV)."""
    fwd = unet_forward_flops(spec, layout, None, batch)
    attn = sum(attention_flops(*c) for c in attention_calls(spec, layout, None, batch))
    res = config["serving"]["resolution"]
    return (clip_text_flops(config["text_encoder"], batch)
            + vae_encode_flops(config["vae"], res, batch) + 3 * fwd + attn)

"""Operations and bytes of the served models, counted from shapes.

Every product counts 2 operations a multiply-add: linears, convolutions and
the attention products QKᵀ and PV. Normalisations, activations and other
elementwise work are not counted, as in a model-FLOP utilisation. An expert
U-Net is counted at the widths its hard code keeps, with a subblock whose
depth gate is closed left out, which is what the expert computes.

Peaks: one NVIDIA H100 SXM, dense bf16 tensor cores and HBM3 bandwidth.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
HEAD_DIM = 64


def conv(k: int, cin: int, cout: int, hw: int) -> float:
    return 2.0 * k * k * cin * cout * hw


def linear(rows: int, din: int, dout: int) -> float:
    return 2.0 * rows * din * dout


def attention_flops(b: int, h: int, s_q: int, s_kv: int, d: int = HEAD_DIM) -> float:
    """QKᵀ and PV."""
    return 4.0 * b * h * s_q * s_kv * d


def attention_bytes(b: int, h: int, s_q: int, s_kv: int, elem: int = 2,
                    d: int = HEAD_DIM) -> float:
    """q, k and v read once and o written once."""
    return float(b * h * d * elem * (2 * s_q + 2 * s_kv))


def attention_bound_s(b: int, h: int, s_q: int, s_kv: int) -> float:
    """The least time one H100 could take for the call: operations at the
    bf16 peak or bytes at the HBM bandwidth, whichever is longer."""
    return max(attention_flops(b, h, s_q, s_kv) / PEAK_BF16_FLOPS,
               attention_bytes(b, h, s_q, s_kv) / PEAK_BYTES_PER_S)


def kept(code: Optional[torch.Tensor], site) -> int:
    """Gate units of `site` a hard code keeps (all of them without a code)."""
    if code is None:
        return site.width
    return int(code[site.start:site.start + site.width].sum().item())


def is_dropped(code: Optional[torch.Tensor], layout, sb) -> bool:
    return code is not None and sb.depth_index >= 0 and \
        float(code[layout.num_width + sb.depth_index]) < 0.5


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


def clip_text_flops(cfg: Dict, rows: int) -> float:
    """The CLIP text transformer over `rows` prompts of its full length."""
    d, inner, s = cfg["hidden_size"], cfg["intermediate_size"], cfg["max_position_embeddings"]
    per_layer = 4 * linear(s, d, d) + 4.0 * s * s * d + linear(s, d, inner) + linear(s, inner, d)
    return rows * cfg["num_hidden_layers"] * per_layer


def vae_decode_flops(cfg: Dict, latent_side: int, rows: int) -> float:
    """The VAE decoder (post_quant_conv onwards) at `latent_side`²
    latents."""
    chs = list(cfg["block_out_channels"])
    lat, lpb = cfg["latent_channels"], cfg["layers_per_block"]
    hw = latent_side ** 2
    ch = chs[-1]
    total = conv(1, lat, lat, hw) + conv(3, lat, ch, hw)
    total += 4 * conv(3, ch, ch, hw)                                   # two mid resnets
    total += 4 * linear(hw, ch, ch) + 4.0 * hw * hw * ch              # mid attention
    side = latent_side
    for i, out in enumerate(reversed(chs)):
        for _ in range(lpb + 1):
            total += conv(3, ch, out, side * side) + conv(3, out, out, side * side)
            if ch != out:
                total += conv(1, ch, out, side * side)
            ch = out
        if i < len(chs) - 1:
            side *= 2
            total += conv(3, ch, ch, side * side)
    total += conv(3, ch, cfg.get("in_channels", 3), side * side)
    return rows * total


def vae_encode_flops(cfg: Dict, side: int, rows: int) -> float:
    """The VAE encoder and quant_conv at `side`² pixels."""
    chs = list(cfg["block_out_channels"])
    lat, lpb = cfg["latent_channels"], cfg["layers_per_block"]
    ch = chs[0]
    total = conv(3, cfg.get("in_channels", 3), ch, side * side)
    for i, out in enumerate(chs):
        for _ in range(lpb):
            total += conv(3, ch, out, side * side) + conv(3, out, out, side * side)
            if ch != out:
                total += conv(1, ch, out, side * side)
            ch = out
        if i < len(chs) - 1:
            side //= 2
            total += conv(3, ch, ch, side * side)
    hw = side * side
    total += 4 * conv(3, ch, ch, hw) + 4 * linear(hw, ch, ch) + 4.0 * hw * hw * ch
    total += conv(3, ch, 2 * lat, hw) + conv(1, 2 * lat, 2 * lat, hw)
    return rows * total


def lse_forward_bound_s(b: int, h: int, s_q: int, s_kv: int, d: int = HEAD_DIM) -> float:
    """The training forward (with the log-sum-exp rows): QKᵀ and PV; q, k,
    v in, o and the f32 lse out."""
    ops = attention_flops(b, h, s_q, s_kv, d)
    nbytes = b * h * (2.0 * d * (2 * s_q + 2 * s_kv) + 4 * s_q)
    return max(ops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S)


def backward_bound_s(b: int, h: int, s_q: int, s_kv: int, d: int = HEAD_DIM) -> float:
    """The attention backward as one function: five products of S_q × S_kv
    × d (QKᵀ again, dO·Vᵀ, Pᵀ·dO, dS·K, dSᵀ·Q); q, k, v, o, dO and lse in,
    dq, dk and dv out, each once."""
    ops = 5 * 2.0 * b * h * s_q * s_kv * d
    nbytes = b * h * (2.0 * d * (4 * s_q + 4 * s_kv) + 4 * s_q)
    return max(ops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S)


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

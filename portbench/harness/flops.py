"""Operations and bytes of the served models, counted from shapes: the
H100's peaks, the primitives (convolution, linear, attention and its
bounds), a hard code's kept units, and the CLIP text and VAE counts. The
walk over a U-Net of one model family is `portbench/counts/<family>.py`.

Every product counts 2 operations a multiply-add: linears, convolutions and
the attention products QKᵀ and PV. Normalisations, activations and other
elementwise work are not counted, as in a model-FLOP utilisation. An expert
U-Net is counted at the widths its hard code keeps, with a subblock whose
depth gate is closed left out, which is what the expert computes.

Peaks: one NVIDIA H100 SXM, dense bf16 tensor cores and HBM3 bandwidth.
"""
from __future__ import annotations

from typing import Dict, Optional

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

"""Weight carry from the JAX package's flax parameter trees to the port's
state dicts — the inverse of the JAX package's diffusers/transformers →
flax converters. Used to drive both packages with the same weights.

Layout rules: dense kernel (in, out) → `Linear.weight` (out, in); conv
kernel HWIO → OIHW; norm `scale` → `weight`; embedding tables unchanged.
"""
from __future__ import annotations

import re
from typing import Dict, Iterator, Tuple

import numpy as np
import torch
import torch.nn as nn

from diffusion_pruning_tpu_torch.models.hypernet import HyperStructure
from diffusion_pruning_tpu_torch.models.quantizer import StructureQuantizer
from diffusion_pruning_tpu_torch.models.text_encoders import CLIPTextEncoder, MPNetEncoder
from diffusion_pruning_tpu_torch.models.unet.unet import GatedUNet
from diffusion_pruning_tpu_torch.models.vae import AutoencoderKL

_UNET_RULES = (
    (r"^(down|up)_blocks_(\d+)_([a-z]+?)_(\d+)", r"\1_blocks.\2.\3.\4"),
    (r"^mid_block_([a-z]+?)_(\d+)", r"mid_block.\1.\2"),
    (r"^time_embedding_(linear_\d)", r"time_embedding.\1"),
    (r"transformer_blocks_(\d+)", r"transformer_blocks.\1"),
    (r"\.to_out_0\.", ".to_out.0."),
    (r"\.ff\.act\.proj\.", ".ff.net.0.proj."),
    (r"\.ff\.out\.", ".ff.net.2."),
)

_VAE_RULES = (  # applied to the flax decoder subtree
    (r"^post_quant_conv\.", "@post_quant_conv."),
    (r"^mid_resnet_(\d+)", r"mid_block.resnets.\1"),
    (r"^mid_attn\.to_out_0\.", "mid_block.attentions.0.to_out.0."),
    (r"^mid_attn\.", "mid_block.attentions.0."),
    (r"^up_(\d+)_resnet_(\d+)", r"up_blocks.\1.resnets.\2"),
    (r"^up_(\d+)_upsample\.", r"up_blocks.\1.upsamplers.0.conv."),
)

_CLIP_RULES = (
    (r"^layers_(\d+)_ln1\.", r"encoder.layers.\1.layer_norm1."),
    (r"^layers_(\d+)_ln2\.", r"encoder.layers.\1.layer_norm2."),
    (r"^layers_(\d+)_(q|k|v)\.", r"encoder.layers.\1.self_attn.\2_proj."),
    (r"^layers_(\d+)_out\.", r"encoder.layers.\1.self_attn.out_proj."),
    (r"^layers_(\d+)_(fc1|fc2)\.", r"encoder.layers.\1.mlp.\2."),
    (r"^(token_embedding)\.", r"embeddings.\1."),
    (r"^position_embedding$", "embeddings.position_embedding.embedding"),
    (r"^", "text_model."),
)

_MPNET_RULES = (
    (r"^layers_(\d+)_(q|k|v)\.", r"encoder.layer.\1.attention.attn.\2."),
    (r"^layers_(\d+)_out\.", r"encoder.layer.\1.attention.attn.o."),
    (r"^layers_(\d+)_ln1\.", r"encoder.layer.\1.attention.LayerNorm."),
    (r"^layers_(\d+)_fc1\.", r"encoder.layer.\1.intermediate.dense."),
    (r"^layers_(\d+)_fc2\.", r"encoder.layer.\1.output.dense."),
    (r"^layers_(\d+)_ln2\.", r"encoder.layer.\1.output.LayerNorm."),
    (r"^(word_embeddings|position_embeddings)\.", r"embeddings.\1."),
    (r"^embeddings_ln\.", "embeddings.LayerNorm."),
    (r"^relative_attention_bias$", "encoder.relative_attention_bias.embedding"),
)

_HYPERNET_RULES = ((r"^head_(\d+)_(kernel|bias)$", r"mh_fc.\1.\2"),)

_QUANTIZER_RULES = ((r"^embedding$", "embedding.embedding"),)


def _flatten(tree, prefix: str = "") -> Iterator[Tuple[str, np.ndarray]]:
    if isinstance(tree, dict) or hasattr(tree, "items"):
        for k, v in tree.items():
            yield from _flatten(v, f"{prefix}.{k}" if prefix else str(k))
    else:
        yield prefix, np.asarray(tree, dtype=np.float32)


def _leaf(key: str, value: np.ndarray) -> Tuple[str, np.ndarray]:
    if key.endswith(".kernel"):
        if value.ndim == 4:  # HWIO -> OIHW
            value = value.transpose(3, 2, 0, 1)
        elif value.ndim == 2:  # (in, out) -> (out, in)
            value = value.T
        return key[: -len(".kernel")] + ".weight", value
    for flax_name in (".scale", ".embedding"):
        if key.endswith(flax_name):
            return key[: -len(flax_name)] + ".weight", value
    return key, value


def _rules_for(model: nn.Module):
    table = ((GatedUNet, _UNET_RULES, ""), (AutoencoderKL, _VAE_RULES, "decoder."),
             (CLIPTextEncoder, _CLIP_RULES, ""), (MPNetEncoder, _MPNET_RULES, ""),
             (HyperStructure, _HYPERNET_RULES, ""), (StructureQuantizer, _QUANTIZER_RULES, ""))
    for cls, rules, prefix in table:
        if isinstance(model, cls):
            return rules, prefix
    raise TypeError(f"no weight carry for {type(model).__name__}")


def params_from_jax(tree, model: nn.Module) -> Dict[str, torch.Tensor]:
    """Flax parameter tree (numpy leaves) → a state dict for `model`.

    tree: the flax `params` of the matching JAX module — for the VAE the
    whole AutoencoderKL tree (its decoder half is taken), for the quantizer
    `{"embedding": ..., "embedding_gs": ...}` (params and state merged).
    Raises unless the keys match `model.state_dict()` exactly."""
    rules, prefix = _rules_for(model)
    if prefix == "decoder.":
        tree = tree["decoder"]
    out = {}
    for key, value in _flatten(tree):
        for pattern, repl in rules:
            key = re.sub(pattern, repl, key)
        key, value = _leaf(key, value)
        key = key[1:] if key.startswith("@") else prefix + key
        out[key] = torch.from_numpy(np.array(value, dtype=np.float32, order="C"))
    want = set(model.state_dict())
    if set(out) != want:
        raise KeyError(f"weight carry mismatch for {type(model).__name__}: "
                       f"missing {sorted(want - set(out))[:8]}, "
                       f"unexpected {sorted(set(out) - want)[:8]}")
    return out

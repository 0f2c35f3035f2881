"""Magnitude-pruning baseline: an arch vector from the dense U-Net's weights.

The port's copy of the JAX package's `models/unet/magnitude.py`. It ranks the
structural units the APTP gates control (a resnet's norm groups, attention
heads, GEGLU groups) by the L2 norm of their weight slices, normalised by the
slice's size, globally across the network, and keeps the top fraction; every
depth gate stays on. The result is a standard arch vector for
`make_expert_plan` / `slice_expert_params`, so the baselines share the
experts' materialisation. Scores are read from the port's diffusers-named
state dict (conv weights (out, in, k, k), linear weights (out, in)): each
unit's sum of squares in float64 on the weights' device, the ranking on the
host with numpy.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from diffusion_pruning_tpu_torch.core.structure import StructureSpec
from diffusion_pruning_tpu_torch.models.unet.pruned import module_name


def _unit_sq(t: torch.Tensor, width: int, dim: int) -> torch.Tensor:
    """Σ of squares of each of `width` equal slices of `t` along `dim`, in
    float64 on the tensor's device."""
    t = t.detach().double().movedim(dim, 0)
    return t.reshape(width, -1).square().sum(1)


def unit_scores_resnet(sd: Dict[str, torch.Tensor], prefix: str, width: int) -> np.ndarray:
    """One score per norm group of the hidden channels: conv1's outputs,
    time_emb_proj's outputs and conv2's inputs of the group."""
    conv1 = sd[f"{prefix}.conv1.weight"]           # (out, in, k, k)
    conv2 = sd[f"{prefix}.conv2.weight"]           # (out2, out, k, k)
    temb = sd[f"{prefix}.time_emb_proj.weight"]    # (out, temb)
    unit = conv1.shape[0] // width
    sq = _unit_sq(conv1, width, 0) + _unit_sq(temb, width, 0) + _unit_sq(conv2, width, 1)
    return (sq.sqrt() / np.sqrt(unit * (conv1.shape[1] + conv2.shape[0] + temb.shape[1]))
            ).cpu().numpy()


def unit_scores_attn(sd: Dict[str, torch.Tensor], prefix: str, heads: int) -> np.ndarray:
    """One score per head: its q, k and v output rows and to_out's input columns."""
    q, k, v = (sd[f"{prefix}.{n}.weight"] for n in ("to_q", "to_k", "to_v"))  # (inner, in)
    o = sd[f"{prefix}.to_out.0.weight"]                                      # (dim, inner)
    hd = q.shape[0] // heads
    sq = sum(_unit_sq(w, heads, 0) for w in (q, k, v)) + _unit_sq(o, heads, 1)
    return (sq.sqrt() / np.sqrt(hd * (q.shape[1] + k.shape[1] + v.shape[1] + o.shape[0]))
            ).cpu().numpy()


def unit_scores_ff(sd: Dict[str, torch.Tensor], prefix: str, width: int) -> np.ndarray:
    """One score per GEGLU group: both halves' rows of the input projection
    and the output projection's columns."""
    proj = sd[f"{prefix}.net.0.proj.weight"]   # (2·inner, C)
    out = sd[f"{prefix}.net.2.weight"]         # (C, inner)
    unit = out.shape[1] // width
    sq = _unit_sq(proj, 2 * width, 0).reshape(2, width).sum(0) + _unit_sq(out, width, 1)
    return (sq.sqrt() / np.sqrt(unit * (2 * proj.shape[1] + out.shape[0]))).cpu().numpy()


def magnitude_arch_vector(spec: StructureSpec, dense_state_dict: Dict[str, torch.Tensor],
                          target_ratio: float, random: bool = False, seed: int = 0) -> np.ndarray:
    """(1, vq_dim) f32: the global top round(target_ratio · num_width) units
    at 0.9, at least one unit a site (its best), every depth gate 0.9.
    random=True scores with `np.random.RandomState(seed).rand`, site by site
    (the original code's random importance), as the JAX package does."""
    rng = np.random.RandomState(seed)
    scores = np.zeros(spec.num_width)
    for sb in spec.subblocks:
        prefix = module_name(sb.name)
        for site in sb.sites:
            if random:
                s = rng.rand(site.width)
            elif site.kind == "resnet":
                s = unit_scores_resnet(dense_state_dict, prefix, site.width)
            elif site.kind in ("attn1", "attn2"):
                s = unit_scores_attn(dense_state_dict,
                                     f"{prefix}.transformer_blocks.0.{site.kind}", site.width)
            else:
                s = unit_scores_ff(dense_state_dict, f"{prefix}.transformer_blocks.0.ff",
                                   site.width)
            scores[site.start: site.start + site.width] = s

    n_keep = int(round(target_ratio * spec.num_width))
    arch = np.zeros(spec.vq_dim, dtype=np.float32)
    arch[np.argsort(-scores)[:n_keep]] = 0.9
    for sb in spec.subblocks:  # the quantizer's non_zero_width invariant
        for site in sb.sites:
            sl = slice(site.start, site.start + site.width)
            if not (arch[sl] >= 0.5).any():
                arch[site.start + int(np.argmax(scores[sl]))] = 0.9
    arch[spec.num_width:] = 0.9
    return arch[None, :]

"""HyperStructure: prompt embedding → architecture-vector logits.

One linear head per width group plus one head for all depth logits (the
APTP `mh_fc` module list, kept per head so checkpoints stay per group); the
forward concatenates the heads into one (input_dim × vq_dim) GEMM instead of
~70 small ones. Options, as in the JAX package:

  weight_norm        each head's weight row i is w_i / (‖w_i‖ + 1e-12) · g_i
                     (`mh_fc.{i}.g`, initialised to ones)
  linear_bias        heads with a bias (default) or without
  single_arch_param  no heads: one learned (1, vq_dim) vector `arch`, the
                     uni-architecture baseline, returned for any input (the
                     caller broadcasts it over the batch)
"""
from __future__ import annotations

import torch
import torch.nn as nn

from diffusion_pruning_tpu_torch.core.structure import StructureSpec


class _Head(nn.Linear):
    """A linear head with an optional weight-norm gain `g` (out_features,)."""

    def __init__(self, input_dim: int, width: int, weight_norm: bool, bias: bool):
        super().__init__(input_dim, width, bias=bias)
        self.g = nn.Parameter(torch.ones(width)) if weight_norm else None

    def effective_weight(self) -> torch.Tensor:
        if self.g is None:
            return self.weight
        norm = torch.linalg.vector_norm(self.weight, dim=1, keepdim=True)
        return self.weight / (norm + 1e-12) * self.g[:, None]


class HyperStructure(nn.Module):
    def __init__(self, spec: StructureSpec, input_dim: int = 768, weight_norm: bool = False,
                 linear_bias: bool = True, single_arch_param: bool = False):
        super().__init__()
        self.spec = spec
        self.input_dim = input_dim
        self.weight_norm = weight_norm
        self.linear_bias = linear_bias
        self.single_arch_param = single_arch_param
        if single_arch_param:
            self.arch = nn.Parameter(torch.randn(1, spec.vq_dim))
        else:
            widths = list(spec.width_list) + [spec.num_depth]
            self.mh_fc = nn.ModuleList([_Head(input_dim, w, weight_norm, linear_bias)
                                        for w in widths])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, input_dim) prompt embeddings → (B, vq_dim) logits, or the
        (1, vq_dim) `arch` under `single_arch_param`."""
        if self.single_arch_param:
            return self.arch
        weight = torch.cat([fc.effective_weight() for fc in self.mh_fc], dim=0)  # (vq, in)
        bias = torch.cat([fc.bias for fc in self.mh_fc]) if self.linear_bias else None
        return nn.functional.linear(x.to(weight.dtype), weight, bias)


def random_arch_vector(spec: StructureSpec, target_ratio: float,
                       generator: torch.Generator) -> torch.Tensor:
    """The random-pruning baseline's (1, vq_dim) arch vector: each width group
    keeps ⌊ratio·width⌋ units at 0.9, drawn by a permutation from
    `generator`; every depth gate is 0.9. (The JAX package draws the
    permutations from a PRNG key, whose bits torch cannot reproduce; the
    invariants are the same.)"""
    cols = []
    for w in spec.width_list:
        col = torch.zeros(w)
        col[torch.randperm(w, generator=generator)[:int(target_ratio * w)]] = 0.9
        cols.append(col)
    cols.append(torch.full((spec.num_depth,), 0.9))
    return torch.cat(cols)[None, :]

"""HyperStructure: prompt embedding → architecture-vector logits.

One linear head per width group plus one head for all depth logits (the
APTP `mh_fc` module list, kept per head so checkpoints stay per group); the
forward concatenates the heads into one (input_dim × vq_dim) GEMM instead of
~70 small ones.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from diffusion_pruning_tpu_torch.core.structure import StructureSpec


class HyperStructure(nn.Module):
    def __init__(self, spec: StructureSpec, input_dim: int = 768):
        super().__init__()
        self.spec = spec
        widths = list(spec.width_list) + [spec.num_depth]
        self.mh_fc = nn.ModuleList([nn.Linear(input_dim, w) for w in widths])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, input_dim) prompt embeddings → (B, vq_dim) logits."""
        weight = torch.cat([fc.weight for fc in self.mh_fc], dim=0)  # (vq_dim, in)
        bias = torch.cat([fc.bias for fc in self.mh_fc])
        return nn.functional.linear(x.to(weight.dtype), weight, bias)

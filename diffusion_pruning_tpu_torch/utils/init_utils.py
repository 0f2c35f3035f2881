"""Random weights from a seed, for smoke runs and benchmarks (never for
training): fan-in-scaled normals for matrices, conv kernels and embedding
tables, ones for norm scales, zeros for biases — the JAX package's
`random_params_like` convention. Norm scales must be 1: a zero scale turns
every normalised path off and the U-Net collapses to its skip connections.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn

_NORMS = (nn.LayerNorm, nn.GroupNorm)


@torch.no_grad()
def random_init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Overwrite every parameter of `module` in place; the normals are drawn
    on the generator's device. Returns the module."""
    for mod in module.modules():
        for name, p in mod.named_parameters(recurse=False):
            if isinstance(mod, _NORMS) and name == "weight":
                p.fill_(1.0)
            elif p.dim() <= 1:
                p.zero_()
            else:
                # torch keeps (out, in, ...) weights, whose fan-in is everything
                # after dim 0; an embedding table (num, dim) uses num, like flax
                fan_in = p.shape[0] if isinstance(mod, nn.Embedding) else p[0].numel()
                r = torch.randn(p.shape, generator=generator, device=generator.device,
                                dtype=torch.float32)
                p.copy_(r / math.sqrt(max(fan_in, 1)))
    return module

"""Gate estimators: gumbel noise and the hard-concrete threshold.

Randomness comes from an explicit `torch.Generator`. The original APTP code's
fixed-seed evaluation mode — a fresh `torch.Generator().manual_seed(0)` — is
`fixed_generator()`.
"""
from __future__ import annotations

from typing import Optional

import torch

_EPS = 1e-20


def fixed_generator() -> torch.Generator:
    """The generator of deterministic (eval-time) gumbel noise."""
    return torch.Generator().manual_seed(0)


def sample_gumbel(shape, generator: Optional[torch.Generator] = None,
                  dtype=torch.float32) -> torch.Tensor:
    """Standard Gumbel(0,1) noise on the CPU: -log(-log(U + eps) + eps)."""
    u = torch.rand(shape, generator=generator, dtype=dtype)
    return -torch.log(-torch.log(u + _EPS) + _EPS)


def hard_concrete(x: torch.Tensor) -> torch.Tensor:
    """Threshold at 0.5 with a straight-through gradient estimator."""
    h = (x >= 0.5).to(x.dtype)
    return x + (h - x).detach()


def importance_gumbel_sigmoid(logits: torch.Tensor, noise: torch.Tensor,
                              temperature: float, offset: float = 0.0) -> torch.Tensor:
    """Ordered ("importance") gate sample used for depth gates:
    softmax -> cumsum -> flip -> inverse sigmoid gives decreasing
    pre-activations, then gumbel-sigmoid with the given noise."""
    x = torch.softmax(logits, dim=1)
    x = torch.cumsum(x, dim=1)
    x = torch.flip(x, dims=(1,))
    eps = 1e-6
    x = torch.log(x + eps) - torch.log1p(-(x - eps))
    return torch.sigmoid((x + noise + offset) / temperature)

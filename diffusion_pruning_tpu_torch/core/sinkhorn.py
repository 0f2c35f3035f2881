"""Sinkhorn optimal-transport assignment of prompts to the architecture
codebook, on one process: Q (K, B) alternately normalised over rows
(prototype mass 1/K) and columns (sample mass 1/B)."""
from __future__ import annotations

import torch


def sinkhorn(scores: torch.Tensor, epsilon: float = 0.05, iterations: int = 3) -> torch.Tensor:
    """Balanced soft assignment (B, K) from a (B, K) score matrix; each row
    sums to 1. The global max is subtracted before the exponential: the
    shift cancels in the normalisations and keeps exp finite at small
    epsilon."""
    q = torch.exp((scores - scores.max()) / epsilon).T  # (K, B)
    k, b = q.shape
    q = q / q.sum()
    tiny = torch.finfo(q.dtype).tiny
    for _ in range(iterations):
        q = q / q.sum(dim=1, keepdim=True).clamp_min(tiny) / k
        q = q / q.sum(dim=0, keepdim=True).clamp_min(tiny) / b
    return (q * b).T


def sinkhorn_assign(scores: torch.Tensor, epsilon: float = 0.05,
                    iterations: int = 3) -> torch.Tensor:
    """Hard codebook indices (B,) from the Sinkhorn assignment."""
    return torch.argmax(sinkhorn(scores, epsilon, iterations), dim=-1)

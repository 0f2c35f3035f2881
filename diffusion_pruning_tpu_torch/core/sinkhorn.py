"""Sinkhorn optimal-transport assignment of prompts to the architecture
codebook: Q (K, B) alternately normalised over rows (prototype mass 1/K)
and columns (sample mass 1/B).

With a data mesh (`parallel/mesh.py`) the batch is the global one: each rank
holds its B_local columns, the max, the total mass and the row sums are
reduced over the ranks (the original code's `dist.all_reduce`, the JAX
package's `lax.pmax`/`psum`), and B = B_local × world. Each rank's
assignment then equals the rows of the one-process assignment over the
concatenated scores."""
from __future__ import annotations

from typing import Optional

import torch

from diffusion_pruning_tpu_torch.parallel.mesh import DataMesh, pmax, psum


def sinkhorn(scores: torch.Tensor, epsilon: float = 0.05, iterations: int = 3,
             mesh: Optional[DataMesh] = None) -> torch.Tensor:
    """Balanced soft assignment (B, K) from a (B, K) score matrix; each row
    sums to 1. The global max is subtracted before the exponential: the
    shift cancels in the normalisations and keeps exp finite at small
    epsilon."""
    smax = scores.max() if mesh is None else pmax(mesh, scores.max())
    q = torch.exp((scores - smax) / epsilon).T  # (K, B_local)
    k, b = q.shape
    if mesh is None:
        q = q / q.sum()
    else:
        b *= mesh.world_size
        q = q / psum(mesh, q.sum())
    tiny = torch.finfo(q.dtype).tiny
    for _ in range(iterations):
        row = q.sum(dim=1, keepdim=True)
        if mesh is not None:
            row = psum(mesh, row)
        q = q / row.clamp_min(tiny) / k
        q = q / q.sum(dim=0, keepdim=True).clamp_min(tiny) / b
    return (q * b).T


def sinkhorn_assign(scores: torch.Tensor, epsilon: float = 0.05, iterations: int = 3,
                    mesh: Optional[DataMesh] = None) -> torch.Tensor:
    """Hard codebook indices (B_local,) from the Sinkhorn assignment."""
    return torch.argmax(sinkhorn(scores, epsilon, iterations, mesh), dim=-1)

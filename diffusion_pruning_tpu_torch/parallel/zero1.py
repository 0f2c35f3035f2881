"""ZeRO-1: the optimizer's moments sharded over the data mesh.

The JAX package's `parallel/zero1.py`: after the gradients are averaged over
the ranks (so they are replicated), the parameters and gradients are
flattened to one vector, zero-padded to a multiple of the world size, and
each rank takes its row of the (world, P / world) view; the elementwise
optimizer (AdamW) updates only that row, its moments live at the row's shape
for the whole run, and the updated rows are gathered back to the full
vector. The masters stay replicated: only the moments are sharded, which
frees (world − 1)/world of them on each rank (about 7 GB of f32 moments for
the SD-2.1 U-Net).

The optimizer must be elementwise: a clip by the global norm is applied to
the full gradients before they are sharded (`training/finetuner.py`).
`training.finetuner.Zero1AdamW` is the optimizer built on these.
"""
from __future__ import annotations

from typing import List, Sequence, Union

import torch

from diffusion_pruning_tpu_torch.parallel.mesh import DataMesh, all_gather


def flat_size(tensors: Sequence[torch.Tensor]) -> int:
    return int(sum(t.numel() for t in tensors))


def shard_len(tensors_or_size: Union[int, Sequence[torch.Tensor]], world: int) -> int:
    """Elements of one rank's row: ⌈P / world⌉ of the P flat elements."""
    n = (tensors_or_size if isinstance(tensors_or_size, int)
         else flat_size(tensors_or_size))
    return (n + world - 1) // world


def local_shard(mesh: DataMesh, tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """This rank's row of the flattened, zero-padded tensors (a new f32 or
    same-dtype vector of `shard_len` elements)."""
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    return row(mesh, flat)


def row(mesh: DataMesh, flat: torch.Tensor) -> torch.Tensor:
    """This rank's row of one flat vector, zero-padded to world rows."""
    n = shard_len(flat.numel(), mesh.world_size)
    lo = mesh.rank * n
    part = flat[lo:lo + n]
    if part.numel() < n:
        part = torch.cat([part, part.new_zeros(n - part.numel())])
    return part.clone()


def gather_shards(mesh: DataMesh, shard: torch.Tensor, total: int) -> torch.Tensor:
    """Every rank's row gathered back to the unpadded flat vector."""
    return all_gather(mesh, shard)[:total]


def unflatten(flat: torch.Tensor, like: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """`flat` cut into views shaped as the tensors of `like`."""
    return [p.view_as(t) for p, t in zip(flat.split([t.numel() for t in like]), like)]

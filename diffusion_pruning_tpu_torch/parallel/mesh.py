"""The data mesh: ranks over one axis, each holding a replica of the
trainables and its rows of the global batch, and the collectives the steps
run over it.

The JAX package's `parallel/mesh.py` is a 1-D `Mesh` over devices with the
batch sharded `P(DATA_AXIS)` and `lax.psum`/`pmean`/`pmax`/`all_gather`/
`axis_index` inside a shard_map'd step. Here a rank is a process
(`utils/launch.init_distributed`), `DataMesh` names its place, and the same
collectives are `torch.distributed` calls on the mesh's group.

Routes: NCCL takes every collective on CUDA tensors. Gloo implements only
`broadcast` and `all_reduce` for CUDA tensors (PyTorch's backend table), so
`all_gather` there is an `all_reduce` of a zero buffer in which this rank
filled its slot: exact, since every other term of each sum is zero (a
gathered -0.0 reads +0.0). On CPU tensors gloo's own all_gather runs.

A `DataMesh` of one process with no group (`data_mesh()` when no group was
formed) runs every collective as the identity.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

DATA_AXIS = "data"
BUCKET_BYTES = 64 << 20  # the largest flat buffer one all_reduce of a tensor list takes


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """This process's place on the data axis."""
    rank: int
    world_size: int
    device: torch.device
    backend: Optional[str] = None   # None: one process, no group
    group: Any = None               # None: the default group

    @property
    def distributed(self) -> bool:
        return self.backend is not None

    @property
    def is_main(self) -> bool:
        return self.rank == 0


def data_mesh(device: Optional[Union[str, torch.device]] = None) -> DataMesh:
    """The mesh of the process group `init_distributed` formed (every rank),
    or of this process alone when it formed none. `device`: this rank's
    device, the one `init_distributed` returned (default: the current card
    under NCCL, else the CPU)."""
    if not dist.is_initialized():
        return DataMesh(0, 1, torch.device(device or "cpu"))
    backend = dist.get_backend()
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device()) if backend == "nccl" else "cpu"
    return DataMesh(dist.get_rank(), dist.get_world_size(), torch.device(device), backend)


def axis_index(mesh: DataMesh) -> int:
    return mesh.rank


def _all_reduce_(mesh: DataMesh, t: torch.Tensor, op) -> torch.Tensor:
    if mesh.distributed:
        dist.all_reduce(t, op=op, group=mesh.group)
    return t


def psum(mesh: DataMesh, x: torch.Tensor) -> torch.Tensor:
    """Σ over the ranks (a new tensor; differentiable as a constant)."""
    return _all_reduce_(mesh, x.detach().clone(), dist.ReduceOp.SUM)


def pmax(mesh: DataMesh, x: torch.Tensor) -> torch.Tensor:
    return _all_reduce_(mesh, x.detach().clone(), dist.ReduceOp.MAX)


def _buckets(tensors: Sequence[torch.Tensor]):
    """Consecutive runs of tensors of one dtype and device, each run's bytes
    at most BUCKET_BYTES (or one tensor)."""
    run: List[torch.Tensor] = []
    size = 0
    for t in tensors:
        nbytes = t.numel() * t.element_size()
        if run and (t.dtype != run[0].dtype or t.device != run[0].device
                    or size + nbytes > BUCKET_BYTES):
            yield run
            run, size = [], 0
        run.append(t)
        size += nbytes
    if run:
        yield run


@torch.no_grad()
def psum_(mesh: DataMesh, tensors: Sequence[torch.Tensor]) -> None:
    """Σ over the ranks of each tensor, in place, in flat buckets."""
    if not mesh.distributed:
        return
    for run in _buckets(tensors):
        if len(run) == 1:
            dist.all_reduce(run[0], group=mesh.group)
            continue
        flat = torch.cat([t.reshape(-1) for t in run])
        dist.all_reduce(flat, group=mesh.group)
        torch._foreach_copy_(run, [p.view_as(t) for p, t in
                                   zip(flat.split([t.numel() for t in run]), run)])


@torch.no_grad()
def pmean_(mesh: DataMesh, tensors: Sequence[torch.Tensor]) -> None:
    """The ranks' mean of each tensor, in place: Σ, then ÷ world size."""
    if not mesh.distributed:
        return
    psum_(mesh, tensors)
    torch._foreach_div_(list(tensors), float(mesh.world_size))


def pmean_dict(mesh: DataMesh, values: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The ranks' mean of each scalar tensor, as one all_reduce."""
    if not mesh.distributed or not values:
        return values
    keys = list(values)
    stacked = torch.stack([values[k].detach().float() for k in keys])
    dist.all_reduce(stacked, group=mesh.group)
    stacked.div_(mesh.world_size)
    return {k: stacked[i] for i, k in enumerate(keys)}


def all_gather(mesh: DataMesh, x: torch.Tensor) -> torch.Tensor:
    """The ranks' x concatenated along dim 0, rank by rank (no gradient)."""
    x = x.detach().contiguous()
    if not mesh.distributed:
        return x.clone()
    n = mesh.world_size
    if x.is_cuda and mesh.backend == "gloo":
        dtype = x.dtype
        wide = x.float() if dtype in (torch.bool, torch.float16, torch.bfloat16) else x
        buf = torch.zeros((n,) + tuple(wide.shape), dtype=wide.dtype, device=x.device)
        buf[mesh.rank] = wide
        dist.all_reduce(buf, group=mesh.group)
        return buf.to(dtype).reshape((n * x.shape[0],) + tuple(x.shape[1:]))
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    if mesh.backend == "nccl":
        dist.all_gather_into_tensor(out, x, group=mesh.group)
    else:
        dist.all_gather(list(out.chunk(n)), x, group=mesh.group)
    return out


def broadcast_(mesh: DataMesh, tensors: Sequence[torch.Tensor], src: int = 0) -> None:
    """Every rank's tensors set to rank `src`'s, in place."""
    if not mesh.distributed:
        return
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t, src, group=mesh.group)


def broadcast_object(mesh: DataMesh, obj, src: int = 0):
    """Rank `src`'s picklable object on every rank."""
    if not mesh.distributed:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src, group=mesh.group,
                               device=mesh.device if mesh.backend == "nccl" else None)
    return box[0]


def barrier(mesh: Optional[DataMesh]) -> None:
    """Wait until every rank reaches this point (a no-op for one process)."""
    if mesh is not None and mesh.distributed:
        # an all_reduce rather than dist.barrier: NCCL's barrier guesses a device
        dist.all_reduce(torch.zeros(1, device=mesh.device), group=mesh.group)


def replicate(mesh: DataMesh, obj: Union[nn.Module, Sequence[torch.Tensor],
                                         Dict[str, torch.Tensor]]):
    """Rank 0's values on every rank: a module's parameters and buffers, or
    each tensor of a list or dict, overwritten in place (the JAX package's
    `replicate`). Returns `obj`."""
    if isinstance(obj, nn.Module):
        tensors = list(obj.parameters()) + list(obj.buffers())
    elif isinstance(obj, dict):
        tensors = list(obj.values())
    else:
        tensors = list(obj)
    broadcast_(mesh, tensors)
    return obj


def _numeric(x) -> bool:
    dtype = x.dtype if hasattr(x, "dtype") else np.asarray(x).dtype
    if isinstance(dtype, torch.dtype):
        return True
    return bool(np.issubdtype(dtype, np.number) or dtype == np.bool_)


def rank_slice(mesh: DataMesh, n: int) -> slice:
    """This rank's rows [r·B, (r+1)·B) of a global batch of n, B = n / world
    size, as `P(DATA_AXIS)` places them."""
    if n % mesh.world_size:
        raise ValueError(f"{n} rows do not split over {mesh.world_size} ranks")
    per = n // mesh.world_size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def shard_batch(mesh: Optional[DataMesh], batch: Dict[str, Any]) -> Dict[str, Any]:
    """This rank's rows of a global batch (`rank_slice` of each column).
    Non-numeric columns (the loader's `captions`) are dropped, as the JAX
    package drops them. Numpy columns stay numpy, tensors stay tensors."""
    if mesh is None:
        mesh = DataMesh(0, 1, torch.device("cpu"))
    return {k: v[rank_slice(mesh, v.shape[0])] for k, v in batch.items() if _numeric(v)}

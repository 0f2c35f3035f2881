"""Process-group start-up from a launcher's environment.

The original APTP code runs data-parallel under `torchrun` / `accelerate
launch` (DDP over NCCL); the JAX package forms its mesh from
JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID. The port reads
torchrun's variables:

  WORLD_SIZE, RANK              the run's processes and this one's index
  LOCAL_WORLD_SIZE, LOCAL_RANK  the processes on this host and this one's index
  MASTER_ADDR, MASTER_PORT      the rendezvous (rank 0 serves it)

  torchrun --nproc_per_node 2 -m diffusion_pruning_tpu_torch.cli.prune ...

Without WORLD_SIZE, or with WORLD_SIZE=1 and no MASTER_ADDR, the process runs
alone and forms no group. When the environment asks for a group, a failure
to form it raises: a run that silently fell back to one process would train
a different algorithm (stage 1's Sinkhorn and contrastive loss span the
global batch).

Backend: NCCL when every local rank has a card of its own
(LOCAL_WORLD_SIZE <= the cards on the host); gloo on the CPU, and when ranks
share a card (NCCL refuses two ranks on one device). Each rank runs on
`cuda:{LOCAL_RANK % cards}` unless the caller asks for the CPU.
"""
from __future__ import annotations

import datetime
import logging
import os
from typing import Optional, Union

import numpy as np
import torch
import torch.distributed as dist

logger = logging.getLogger("diffusion_pruning_tpu_torch")

DEFAULT_TIMEOUT_S = 1800.0


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return None if value in (None, "") else int(value)


def wants_group() -> bool:
    """Whether the environment asks for a process group: WORLD_SIZE > 1, or
    WORLD_SIZE = 1 with MASTER_ADDR (torchrun with one process)."""
    world = _env_int("WORLD_SIZE")
    return world is not None and (world > 1 or bool(os.environ.get("MASTER_ADDR")))


def init_distributed(device: Optional[Union[str, torch.device]] = None,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Form the process group the environment asks for (none for a single
    process) and return this process's device. `device=None` means this
    rank's CUDA card and raises when there is none; `"cpu"` runs the rank on
    the CPU under gloo. `timeout_s` bounds the rendezvous and every
    collective. A call after the group formed returns this rank's device."""
    from diffusion_pruning_tpu_torch.utils.device import resolve_device

    cpu = device is not None and torch.device(device).type == "cpu"
    if not wants_group() and not dist.is_initialized():
        return resolve_device(device)
    world = _env_int("WORLD_SIZE") or 1
    if cpu:
        dev, backend = torch.device("cpu"), "gloo"
    else:
        if device is not None and torch.device(device).type != "cuda":
            raise ValueError(f"a rank runs on a CUDA card or the CPU, not {device}")
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' to run the "
                               "ranks on the CPU")
        cards = torch.cuda.device_count()
        local_rank = _env_int("LOCAL_RANK") or 0
        local_world = _env_int("LOCAL_WORLD_SIZE") or world
        dev = torch.device("cuda", local_rank % cards)
        backend = "nccl" if local_world <= cards else "gloo"
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return dev
    rank = _env_int("RANK")
    addr, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
    if rank is None or not addr or not port:
        raise RuntimeError(f"WORLD_SIZE={world} asks for a process group, but RANK, MASTER_ADDR "
                           "or MASTER_PORT is missing")
    # no try: a group the environment asks for and that does not form ends the run
    dist.init_process_group(backend, init_method=f"tcp://{addr}:{port}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
    logger.info("distributed: rank %d of %d on %s (%s)", rank, world, dev, backend)
    return dev


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main_process() -> bool:
    """Rank 0, or the only process: the one that writes the run's files."""
    return rank() == 0


def process_slice(n: int) -> slice:
    """This process's contiguous share of n items: ⌈n / world⌉ each, the
    last rank taking what is left (the JAX package's split)."""
    per = (n + world_size() - 1) // world_size()
    lo = rank() * per
    return slice(lo, min(lo + per, n))


def rank_seed(seed: int, rank_index: int) -> int:
    """The seed of rank `rank_index`'s own stream of draws: derived from
    (seed, rank) through numpy's SeedSequence, so it never equals `seed`,
    whose stream every rank shares (the codebook's gumbel noise)."""
    ss = np.random.SeedSequence(entropy=seed, spawn_key=(rank_index,))
    return int(ss.generate_state(1, dtype=np.uint64)[0] >> 1)

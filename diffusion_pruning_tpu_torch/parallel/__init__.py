"""Data parallelism: the data mesh and its collectives (`mesh.py`) and
ZeRO-1's sharded optimizer state (`zero1.py`); tensor parallelism on a 2-D
data × model mesh (`tp.py`)."""
from diffusion_pruning_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    DataMesh,
    data_mesh,
    replicate,
    shard_batch,
)

__all__ = ["DATA_AXIS", "DataMesh", "data_mesh", "replicate", "shard_batch"]

from diffusion_pruning_tpu_torch.metrics.metrics import (
    clip_score,
    cmmd,
    frechet_distance,
    gaussian_stats,
    mmd_rbf,
)

__all__ = ["clip_score", "cmmd", "frechet_distance", "gaussian_stats", "mmd_rbf"]

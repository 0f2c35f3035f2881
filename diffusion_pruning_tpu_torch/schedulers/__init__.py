from diffusion_pruning_tpu_torch.schedulers.ddim import DDIMSampler
from diffusion_pruning_tpu_torch.schedulers.ddpm import DiffusionSchedule

__all__ = ["DDIMSampler", "DiffusionSchedule"]

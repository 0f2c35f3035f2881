from diffusion_pruning_tpu_torch.schedulers.ddim import DDIMSampler
from diffusion_pruning_tpu_torch.schedulers.ddpm import DiffusionSchedule
from diffusion_pruning_tpu_torch.schedulers.dpm import DPMSolverPPSampler
from diffusion_pruning_tpu_torch.schedulers.pndm import PNDMSampler

__all__ = ["DDIMSampler", "DiffusionSchedule", "DPMSolverPPSampler", "PNDMSampler"]

"""DDIM sampler (η=0) as a Python loop over the denoising trajectory.

SD defaults: leading timestep spacing with steps_offset=1,
set_alpha_to_one=False (the final step uses ᾱ[0]), no sample clipping.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

import numpy as np
import torch

from diffusion_pruning_tpu_torch.schedulers.ddpm import DiffusionSchedule


@dataclasses.dataclass(frozen=True)
class DDIMSampler:
    schedule: DiffusionSchedule
    steps_offset: int = 1

    def timesteps(self, num_inference_steps: int) -> np.ndarray:
        T = self.schedule.num_train_timesteps
        ratio = T // num_inference_steps
        ts = (np.arange(num_inference_steps) * ratio).round().astype(np.int64)
        ts += self.steps_offset
        return ts[::-1].copy()

    @torch.no_grad()
    def sample(self, model_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
               latents: torch.Tensor, num_inference_steps: int = 50) -> torch.Tensor:
        """model_fn(latents, t_batch) -> model output (ε or v, per schedule);
        CFG combination happens inside model_fn."""
        return self.run(model_fn, latents, self.timesteps(num_inference_steps).tolist(),
                        num_inference_steps)

    @torch.no_grad()
    def run(self, model_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
            latents: torch.Tensor, timesteps: Sequence[int],
            num_inference_steps: int) -> torch.Tensor:
        """The DDIM updates at `timesteps`, a run of consecutive entries of
        `self.timesteps(num_inference_steps)` (a whole trajectory or a chunk
        of one)."""
        sched = self.schedule
        ratio = sched.num_train_timesteps // num_inference_steps
        ac = sched.alphas_cumprod
        x = latents
        for t in timesteps:
            t_b = torch.full((x.shape[0],), t, dtype=torch.long, device=x.device)
            out = model_fn(x, t_b)
            # f32 update, as the JAX package's f32 coefficients promote it
            eps, x0 = sched.to_epsilon_and_x0(out.float(), x.float(), t)
            t_prev = t - ratio
            ac_prev = float(ac[t_prev]) if t_prev >= 0 else float(ac[0])
            x_prev = math.sqrt(ac_prev) * x0 + math.sqrt(1.0 - ac_prev) * eps
            x = x_prev.to(latents.dtype)
        return x

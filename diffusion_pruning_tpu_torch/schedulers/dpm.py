"""DPM-Solver++(2M) sampler (Lu et al. 2022, arXiv 2211.01095): multistep,
second order, data-prediction parametrisation, midpoint variant.

The port's copy of the JAX package's `schedulers/dpm.py`, as a Python loop.
Timesteps are the DDIM plan (leading spacing, steps_offset=1, the final
target ᾱ[0]). With λ = log(α/σ), s0 the current point, t the target and
h = λ_t − λ_s0:

    first order (step 0, and the last step with lower_order_final):
        x_t = (σ_t/σ_s0)·x − α_t·(e^{−h} − 1)·x0(s0)
    2M: with h_prev = λ_s0 − λ_s1 and D1 = (h/h_prev)·(x0_s0 − x0_s1)
        x_t = (σ_t/σ_s0)·x − α_t·(e^{−h} − 1)·(x0_s0 + D1/2)
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from diffusion_pruning_tpu_torch.schedulers.ddpm import DiffusionSchedule


def _lam(ac: float) -> float:
    """λ = log(α/σ) = ½(log ᾱ − log(1 − ᾱ))."""
    return 0.5 * (math.log(ac) - math.log1p(-ac))


@dataclasses.dataclass(frozen=True)
class DPMSolverPPSampler:
    schedule: DiffusionSchedule
    steps_offset: int = 1
    lower_order_final: bool = True

    def timesteps(self, num_inference_steps: int) -> np.ndarray:
        T = self.schedule.num_train_timesteps
        ratio = T // num_inference_steps
        ts = (np.arange(num_inference_steps) * ratio).round().astype(np.int64)
        ts += self.steps_offset
        return ts[::-1].copy()

    @torch.no_grad()
    def sample(self, model_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
               latents: torch.Tensor, num_inference_steps: int = 20) -> torch.Tensor:
        """model_fn(latents, t_batch) -> model output (ε or v, per schedule);
        CFG combination happens inside model_fn."""
        sched = self.schedule
        n = num_inference_steps
        ratio = sched.num_train_timesteps // n
        ac = sched.alphas_cumprod
        x = latents
        x0_prev = h_prev = None
        for i, t in enumerate(self.timesteps(n).tolist()):
            t_b = torch.full((x.shape[0],), t, dtype=torch.long, device=x.device)
            out = model_fn(x, t_b)
            _, x0 = sched.to_epsilon_and_x0(out.float(), x.float(), t)
            ac_s0 = float(ac[t])
            ac_t = float(ac[t - ratio]) if t - ratio >= 0 else float(ac[0])
            h = _lam(ac_t) - _lam(ac_s0)
            alpha_t = math.sqrt(ac_t)
            em = math.expm1(-h)
            x_new = (math.sqrt(1.0 - ac_t) / math.sqrt(1.0 - ac_s0)) * x.float() \
                - alpha_t * em * x0
            if i > 0 and not (self.lower_order_final and i == n - 1):
                # h_prev is 0 only at n = num_train_timesteps (the first h), where
                # the JAX sampler divides by 1 instead
                d1 = (h / (h_prev or 1.0)) * (x0 - x0_prev)
                x_new = x_new - 0.5 * alpha_t * em * d1
            x0_prev, h_prev = x0, h
            x = x_new.to(latents.dtype)
        return x

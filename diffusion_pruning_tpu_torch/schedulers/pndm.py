"""PNDM/PLMS sampler, the skip_prk_steps variant Stable Diffusion uses.

The port's copy of the JAX package's `schedulers/pndm.py`, as a Python loop
over the trajectory. Timestep plan (leading spacing, steps_offset=1): the
second timestep is visited twice. The first step stashes the sample; on the
repeat the last model output and the new one are averaged, and the sampler
restarts from the stash with the transfer t + ratio → t (the diffusers PLMS
warm-up). Later steps combine the last 1-4 raw model outputs (ε or v) with
the Adams-Bashforth weights; for v-prediction the v → ε conversion follows
the combination, as in diffusers.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from diffusion_pruning_tpu_torch.schedulers.ddpm import DiffusionSchedule

# linear-multistep weights of the last 1-4 outputs, newest first, and their divisor
_LMS = ((1.0,), (3.0, -1.0), (23.0, -16.0, 5.0), (55.0, -59.0, 37.0, -9.0))
_LMS_DIV = (1.0, 2.0, 12.0, 24.0)


@dataclasses.dataclass(frozen=True)
class PNDMSampler:
    schedule: DiffusionSchedule
    steps_offset: int = 1

    def timesteps(self, num_inference_steps: int) -> np.ndarray:
        T = self.schedule.num_train_timesteps
        ratio = T // num_inference_steps
        base = (np.arange(num_inference_steps) * ratio).round().astype(np.int64)
        base += self.steps_offset
        # [..., t_{n-2}, t_{n-1}] -> reversed with t_{n-2} duplicated
        ts = np.concatenate([base[:-1], base[-2:-1], base[-1:]])[::-1]
        return ts.copy()

    def _prev_sample(self, x: torch.Tensor, t: int, t_prev: int, mo: torch.Tensor):
        """The PNDM transfer (Liu et al. 2022, eq. 11) from t to t_prev of the
        combined model output `mo` (ε or v) at sample x, all f32."""
        ac = self.schedule.alphas_cumprod
        a_t = float(ac[t])
        a_prev = float(ac[t_prev]) if t_prev >= 0 else float(ac[0])
        if self.schedule.prediction_type == "v_prediction":
            eps = math.sqrt(a_t) * mo + math.sqrt(1.0 - a_t) * x
        else:
            eps = mo
        denom = a_t * math.sqrt(1.0 - a_prev) + math.sqrt(a_t * a_prev * (1.0 - a_t))
        return math.sqrt(a_prev / a_t) * x - ((a_prev - a_t) / denom) * eps

    @torch.no_grad()
    def sample(self, model_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
               latents: torch.Tensor, num_inference_steps: int = 25) -> torch.Tensor:
        """model_fn(latents, t_batch) -> model output (ε or v, per schedule);
        CFG combination happens inside model_fn."""
        ratio = self.schedule.num_train_timesteps // num_inference_steps
        history = []  # raw f32 model outputs, newest last; the repeat's is not kept
        x = stash = latents
        for i, t in enumerate(self.timesteps(num_inference_steps).tolist()):
            t_b = torch.full((x.shape[0],), t, dtype=torch.long, device=x.device)
            out = model_fn(x, t_b).float()
            if i == 1:  # the repeated second timestep
                mo = (history[-1] + out) / 2.0
                x_base, t_step, t_prev = stash, t + ratio, t
            else:
                history = (history + [out])[-4:]
                weights = _LMS[len(history) - 1]
                mo = sum(w * e for w, e in zip(weights, reversed(history)))
                mo = mo / _LMS_DIV[len(history) - 1]
                x_base, t_step, t_prev = x, t, t - ratio
            x = self._prev_sample(x_base.float(), t_step, t_prev, mo).to(latents.dtype)
        return x

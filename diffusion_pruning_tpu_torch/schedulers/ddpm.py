"""DDPM noise schedule math: the scaled-linear β schedule of SD-2.1 and the
conversion of a model output (ε or v) into (ε, x₀) predictions."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"
    prediction_type: str = "v_prediction"

    @property
    def betas(self) -> np.ndarray:
        if self.beta_schedule == "scaled_linear":
            return np.linspace(self.beta_start ** 0.5, self.beta_end ** 0.5,
                               self.num_train_timesteps, dtype=np.float64) ** 2
        if self.beta_schedule == "linear":
            return np.linspace(self.beta_start, self.beta_end,
                               self.num_train_timesteps, dtype=np.float64)
        raise ValueError(self.beta_schedule)

    @property
    def alphas_cumprod(self) -> np.ndarray:
        """float32, as the JAX package keeps it."""
        return np.cumprod(1.0 - self.betas).astype(np.float32)

    def to_epsilon_and_x0(self, model_out: torch.Tensor, sample: torch.Tensor, timestep: int):
        """Convert the model output (ε or v) at one timestep shared by the
        batch to (ε, x₀) predictions. The coefficients stay host floats: a
        per-step copy of the ᾱ table to the device would wait for the stream."""
        ac = float(self.alphas_cumprod[timestep])
        sa, so = ac ** 0.5, (1.0 - ac) ** 0.5
        if self.prediction_type == "epsilon":
            eps = model_out
            x0 = (sample - so * eps) / sa
        elif self.prediction_type == "v_prediction":
            x0 = sa * sample - so * model_out
            eps = sa * model_out + so * sample
        else:
            raise ValueError(self.prediction_type)
        return eps, x0

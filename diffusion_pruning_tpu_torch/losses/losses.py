"""Stage-1 training losses: resource, contrastive, min-SNR weights and the
weighted denoising MSE. Plain torch ops, differentiable where training needs
them; everything is computed in f32."""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch


def resource_loss(ratio: torch.Tensor, p: float, loss_type: str = "log") -> torch.Tensor:
    """Penalty on the mean resource ratio against the keep fraction p:
    |log(ratio / p)| (log), |ratio − p| (mae) or (ratio − p)² (mse)."""
    if loss_type == "log":
        return torch.abs(torch.log(ratio) - math.log(p))
    if loss_type == "mae":
        return torch.abs(ratio - p)
    if loss_type == "mse":
        return (ratio - p) ** 2
    raise ValueError(f"unknown resource loss type {loss_type!r}")


def contrastive_loss(prompt_embeddings: torch.Tensor, arch_vectors: torch.Tensor,
                     prompt_temperature: float = 0.03, arch_temperature: float = 0.03):
    """BCE between the softmaxed self-similarity matrices of the normalised
    architecture vectors and prompt embeddings; the prompt side carries no
    gradient. Returns (loss, arch similarity matrix)."""
    a = arch_vectors / torch.linalg.norm(arch_vectors, dim=1, keepdim=True)
    t = prompt_embeddings / torch.linalg.norm(prompt_embeddings, dim=1, keepdim=True)
    a_sim = torch.softmax((a @ a.T) / arch_temperature, dim=-1)
    t_sim = torch.softmax((t @ t.T) / prompt_temperature, dim=-1).detach()
    eps = 1e-7
    a_c = a_sim.clamp(eps, 1.0 - eps)
    bce = -(t_sim * torch.log(a_c) + (1.0 - t_sim) * torch.log(1.0 - a_c))
    return bce.mean(), a_sim


def snr_weights(alphas_cumprod: Sequence[float], timesteps: torch.Tensor,
                snr_gamma: Optional[float],
                prediction_type: str = "v_prediction") -> torch.Tensor:
    """Min-SNR-γ loss weights min(SNR, γ) / SNR per sample; for v-prediction
    the SNR is incremented by one first. alphas_cumprod: the f32 ᾱ table."""
    ac = torch.as_tensor(alphas_cumprod, dtype=torch.float32,
                         device=timesteps.device)[timesteps]
    snr = ac / (1.0 - ac)
    if snr_gamma is None:
        return torch.ones_like(snr)
    if prediction_type == "v_prediction":
        snr = snr + 1.0
    return torch.clamp(snr, max=snr_gamma) / snr


def diffusion_loss(model_pred: torch.Tensor, target: torch.Tensor,
                   weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-sample-weighted mean squared error, in f32."""
    err = (model_pred.float() - target.float()) ** 2
    per_sample = err.mean(dim=tuple(range(1, err.dim())))
    if weights is not None:
        per_sample = per_sample * weights
    return per_sample.mean()

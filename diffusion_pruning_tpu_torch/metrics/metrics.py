"""Evaluation metrics on precomputed features: FID, CLIP-score, CMMD.

The port's own copy of the JAX package's `metrics/metrics.py` (which
imports no JAX either), so that the evaluation chain runs from the port's
package alone. Features come in as numpy arrays from whatever tower made
them (the port's CLIP towers, a TorchScript InceptionV3) and the arithmetic
is numpy/scipy in float64:

  * FID: Fréchet distance between Gaussian feature statistics, with
    `scipy.linalg.sqrtm` (called as SciPy 1.18 takes it, without `disp`)
    and, where its result is not finite, the same product again with `eps`
    on both diagonals;
  * CLIP-score: the mean cosine of aligned (image, text) pairs times CLIP's
    logit scale (100);
  * CMMD: MMD² with an RBF kernel (σ = 10, the biased V-statistic) between
    CLIP ViT-L/14-336 image embeddings, times 1000.
"""
from __future__ import annotations

import numpy as np


def gaussian_stats(features: np.ndarray):
    """(mean, covariance) of a (N >= 2, D) feature matrix."""
    if features.ndim != 2 or features.shape[0] < 2:
        raise ValueError(
            f"FID statistics need a (N>=2, D) feature matrix, got shape "
            f"{features.shape} — the Fréchet distance is undefined for a "
            f"single sample (np.cov degenerates to a scalar)")
    mu = features.mean(axis=0)
    sigma = np.cov(features, rowvar=False)
    return mu, sigma


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """FID between two feature Gaussians."""
    from scipy import linalg
    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2
    # no `disp=False` as in the JAX package: SciPy 1.18 removed the argument
    # (it only silenced a warning), and the H100 installation has that SciPy
    covmean = linalg.sqrtm(sigma1 @ sigma2)
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset) @ (sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean))


def clip_score(image_features: np.ndarray, text_features: np.ndarray,
               logit_scale: float = 100.0) -> float:
    """Mean cosine similarity × logit scale over aligned (image, text) pairs."""
    img = image_features / np.linalg.norm(image_features, axis=1, keepdims=True)
    txt = text_features / np.linalg.norm(text_features, axis=1, keepdims=True)
    return float(logit_scale * (img * txt).sum(axis=1).mean())


def mmd_rbf(x: np.ndarray, y: np.ndarray, sigma: float = 10.0) -> float:
    """MMD² with an RBF kernel, gamma = 1/(2σ²), the biased V-statistic."""
    gamma = 1.0 / (2.0 * sigma ** 2)
    x_sq = (x * x).sum(axis=1)
    y_sq = (y * y).sum(axis=1)
    k_xx = np.exp(-gamma * (x_sq[:, None] - 2 * x @ x.T + x_sq[None, :]))
    k_yy = np.exp(-gamma * (y_sq[:, None] - 2 * y @ y.T + y_sq[None, :]))
    k_xy = np.exp(-gamma * (x_sq[:, None] - 2 * x @ y.T + y_sq[None, :]))
    return float(k_xx.mean() + k_yy.mean() - 2 * k_xy.mean())


def cmmd(ref_embeddings: np.ndarray, gen_embeddings: np.ndarray,
         sigma: float = 10.0, scale: float = 1000.0) -> float:
    """`scale` × MMD² of the two embedding sets, in float64."""
    return scale * mmd_rbf(ref_embeddings.astype(np.float64),
                           gen_embeddings.astype(np.float64), sigma)

"""Latent caching: encode the frozen VAE's latent moments once and train
from them.

The VAE is frozen in both stages, so an image's latent distribution is
fixed: its (mean, logvar) are cached once (center crop, no flip) and each
step draws z = mean + exp(logvar / 2)·ε from them
(`training/pruner.encode_latents`). Horizontal flips are kept by flipping
the latents (the VAE is convolutional: flip(encode(x)) ≈ encode(flip(x))).

The shard format is the JAX package's `data/latent_cache.py`: one `.npz` a
shard, `mean` and `logvar` (N, h, w, 4) in float16 and `caption` (object
array), so either package reads the other's cache.
"""
from __future__ import annotations

import os
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np
import torch


def build_latent_cache(
    pipeline_batches: Iterator[Dict[str, np.ndarray]],
    encode_moments: Callable[[torch.Tensor], tuple],
    out_dir: str,
    shard_size: int = 2048,
) -> List[str]:
    """encode_moments(pixels) → (mean, logvar), pixels a host f32 tensor
    (B, H, W, 3) and the moments tensors on any device (the caller moves the
    pixels to its device: `AutoencoderKL.encode_moments` under
    `torch.inference_mode`). The batches must be deterministic (a
    `train=False` pipeline). Returns the shard paths."""
    os.makedirs(out_dir, exist_ok=True)
    shards: List[str] = []
    means: List[np.ndarray] = []
    logvars: List[np.ndarray] = []
    caps: List[List[str]] = []
    count = 0

    def flush():
        nonlocal means, logvars, caps
        if not means:
            return
        path = os.path.join(out_dir, f"latents_{len(shards):05d}.npz")
        np.savez(path, mean=np.concatenate(means), logvar=np.concatenate(logvars),
                 caption=np.asarray([c for chunk in caps for c in chunk], dtype=object))
        shards.append(path)
        means, logvars, caps = [], [], []

    for batch in pipeline_batches:
        m, lv = encode_moments(torch.from_numpy(np.asarray(batch["pixel_values"])))
        # bf16 and f32 values are exact in f32: one rounding to f16, as numpy's
        means.append(m.float().cpu().numpy().astype(np.float16))
        logvars.append(lv.float().cpu().numpy().astype(np.float16))
        caps.append(list(batch["captions"]))
        count += len(batch["captions"])
        if count >= shard_size:
            flush()
            count = 0
    flush()
    return shards


class LatentPipeline:
    """Batches of cached latent moments (with optional flip augmentation):
    {'latent_mean', 'latent_logvar' (f32), 'captions'}, plus the tokenizers'
    keys when given. Draws as the JAX package's: the order and the flips
    from `RandomState(seed + epoch)`."""

    def __init__(self, cache_dir: str, batch_size: int, train: bool = True,
                 random_flip: bool = True, seed: int = 0,
                 tokenize_clip: Optional[Callable] = None,
                 tokenize_mpnet: Optional[Callable] = None):
        paths = sorted(os.path.join(cache_dir, f) for f in os.listdir(cache_dir)
                       if f.startswith("latents_") and f.endswith(".npz"))
        if not paths:
            raise FileNotFoundError(f"no latent shards in {cache_dir}")
        means, logvars, caps = [], [], []
        for p in paths:
            # the shards hold an object array of captions: only files this
            # program (or the JAX package's cache builder) wrote are read
            with np.load(p, allow_pickle=True) as z:
                means.append(z["mean"])
                logvars.append(z["logvar"])
                caps.extend(z["caption"].tolist())
        self.mean = np.concatenate(means)
        self.logvar = np.concatenate(logvars)
        self.captions = caps
        self.batch_size = batch_size
        self.train = train
        self.random_flip = random_flip
        self.seed = seed
        self.tokenize_clip = tokenize_clip
        self.tokenize_mpnet = tokenize_mpnet

    def __len__(self):
        return len(self.captions) // self.batch_size

    def epoch(self, epoch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        idx = np.arange(len(self.captions))
        rng = np.random.RandomState(self.seed + epoch)
        if self.train:
            rng.shuffle(idx)
        for b in range(len(self)):
            sl = idx[b * self.batch_size:(b + 1) * self.batch_size]
            m = self.mean[sl].astype(np.float32)
            lv = self.logvar[sl].astype(np.float32)
            if self.train and self.random_flip:
                flips = rng.rand(len(sl)) < 0.5
                m[flips] = m[flips, :, ::-1, :]
                lv[flips] = lv[flips, :, ::-1, :]
            caps = [self.captions[i] for i in sl]
            out: Dict[str, np.ndarray] = {
                "latent_mean": m, "latent_logvar": lv,
                "captions": np.asarray(caps, dtype=object),
            }
            if self.tokenize_clip is not None:
                out["input_ids"] = self.tokenize_clip(caps)
            if self.tokenize_mpnet is not None:
                out.update(self.tokenize_mpnet(caps))
            yield out

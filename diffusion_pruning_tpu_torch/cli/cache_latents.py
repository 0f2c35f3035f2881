"""Latent-cache entry point: encode a dataset's images into the VAE's latent
moments once, on one CUDA card.

  python -m diffusion_pruning_tpu_torch.cli.cache_latents \
      --base_config_path configs/pruning/sd-2-1_coco2014.yaml \
      --pretrained_model_name_or_path /path/to/stable-diffusion-2-1 \
      --cache_dir latents/coco

The counterpart of the JAX package's `scripts/other/cache_latents.py`: the
VAE from `<sd_root>/vae` in bf16 (the tiny random one without
`<sd_root>/unet`), a deterministic pipeline (no shuffle, center crop, no
flip, 32 images a batch) over each split of the dataset folder, and
`data/latent_cache.py`'s shards (mean and logvar in f16, captions) under
`--cache_dir/{split}` (default `latent_cache/`), which
`data.latent_cache.LatentPipeline` of either package reads back.
`--device cpu` runs on the CPU; without it there must be a card.
"""
from __future__ import annotations

import os
from typing import Dict, List

import torch

CACHE_BATCH = 32


def main(argv=None) -> Dict[str, List[str]]:
    """Cache every split; returns {split: shard paths}."""
    from diffusion_pruning_tpu_torch.data import get_dataset
    from diffusion_pruning_tpu_torch.data.latent_cache import build_latent_cache
    from diffusion_pruning_tpu_torch.data.loader import DataPipeline
    from diffusion_pruning_tpu_torch.training.factory import build_vae, unet_config_from_yaml
    from diffusion_pruning_tpu_torch.utils.arg_utils import parse_args
    from diffusion_pruning_tpu_torch.utils.config import load_config
    from diffusion_pruning_tpu_torch.utils.device import resolve_device

    args = parse_args(argv)
    cfg = load_config(args.base_config_path)
    cfg.update_flat(vars(args))
    device = resolve_device(None if args.device == "cuda" else args.device)
    sd_root = args.pretrained_model_name_or_path
    tiny = not os.path.exists(os.path.join(sd_root or "", "unet"))
    ucfg = unet_config_from_yaml(cfg, tiny=tiny)
    vae = build_vae(sd_root, tiny=tiny, device=device, dtype=torch.bfloat16)

    @torch.inference_mode()
    def encode(pixels):
        return vae.encode_moments(pixels.to(device))

    resolution = ucfg.sample_size * vae.cfg.spatial_scale
    out_root = args.cache_dir or "latent_cache"
    out = {}
    for split, cols in get_dataset(cfg.data).items():
        pipe = DataPipeline(cols, batch_size=CACHE_BATCH, resolution=resolution, train=False,
                            center_crop=True, random_flip=False, seed=args.seed)
        out[split] = build_latent_cache(pipe.epoch(0), encode, os.path.join(out_root, split))
        print(f"{split}: {len(out[split])} shards → {os.path.join(out_root, split)}")
    return out


if __name__ == "__main__":
    main()

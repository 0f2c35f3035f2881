"""CMMD between generated images and reference images or embeddings, on one
CUDA card.

  python -m diffusion_pruning_tpu_torch.cli.cmmd GEN_DIR REF_DIR_OR_NPY \
      --clip_model /path/to/clip-vit-large-patch14-336

The counterpart of the JAX package's `scripts/metrics/cmmd.py --backend
jax`: the CLIP ViT-L/14-336 vision tower of a local folder
(`metrics/towers.py`, in bf16 on the card) embeds every `.npy`, `.png` and
`.jpg` of each directory (16 at a time), each embedding scaled to unit
length; a reference ending in `.npy` is taken as precomputed embeddings.
CMMD (`metrics.cmmd`) is the RBF MMD² at `--sigma` times `--scale`.
The tower's config is the folder's `config.json` `vision_config` where it
has one (as `transformers`' `CLIPModel`, the JAX script's default backend,
reads it), else ViT-L/14-336 (a vision-only folder of bare weights).
`--backend torch` (transformers' `CLIPModel`) is not available here.
`--device cpu` runs on the CPU; without it there must be a card.
"""
from __future__ import annotations

import argparse
import os
from typing import Optional

EMBED_BATCH = 16


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="CMMD of generated images")
    p.add_argument("gen_dir")
    p.add_argument("ref")
    p.add_argument("--clip_model", required=True)
    p.add_argument("--sigma", type=float, default=10.0)
    p.add_argument("--scale", type=float, default=1000.0)
    p.add_argument("--save_ref_embeddings", default=None)
    p.add_argument("--backend", choices=("torch", "jax"), default="jax",
                   help="'jax': the package's own ViT-L/14-336 tower; 'torch' "
                        "(transformers' CLIPModel) is not available in the port")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu'")
    return p.parse_args(argv)


def embed_dir(path: str, towers, batch_size: int = EMBED_BATCH):
    """Unit-length image embeddings of a directory's images (sorted), or
    the array of a `.npy` file."""
    import numpy as np

    from diffusion_pruning_tpu_torch.metrics.towers import image_files, load_images
    if path.endswith(".npy"):
        return np.load(path)
    files = image_files(path)
    return np.concatenate([towers.embed_images(load_images(path, files[i:i + batch_size]),
                                               unit=True)
                           for i in range(0, len(files), batch_size)])


def folder_vision_config(folder: str):
    """The `CLIPVisionConfig` of a folder's `config.json` `vision_config`,
    else ViT-L/14-336."""
    import json

    from diffusion_pruning_tpu_torch.metrics.towers import read_clip_config
    from diffusion_pruning_tpu_torch.models.clip_vision import CLIPVisionConfig
    path = os.path.join(folder, "config.json")
    if os.path.exists(path):
        with open(path) as f:
            if json.load(f).get("vision_config"):
                return read_clip_config(folder)[1]
    return CLIPVisionConfig.vit_l14_336()


def main(argv=None, vision_cfg: Optional[object] = None) -> dict:
    """Print and return CMMD with both embedding sets. `vision_cfg` is the
    tower's `CLIPVisionConfig` (default: `folder_vision_config`)."""
    import numpy as np

    from diffusion_pruning_tpu_torch.cli.clip_score import check_backend
    from diffusion_pruning_tpu_torch.metrics import cmmd
    from diffusion_pruning_tpu_torch.metrics.towers import load_clip_towers
    from diffusion_pruning_tpu_torch.utils.device import resolve_device

    args = parse_args(argv)
    check_backend(args.backend)
    device = resolve_device(None if args.device == "cuda" else args.device)
    towers = load_clip_towers(args.clip_model, device, text=False,
                              vision_cfg=vision_cfg or folder_vision_config(args.clip_model))
    ref = embed_dir(args.ref, towers)
    gen = embed_dir(args.gen_dir, towers)
    if args.save_ref_embeddings:
        os.makedirs(os.path.dirname(os.path.abspath(args.save_ref_embeddings)), exist_ok=True)
        np.save(args.save_ref_embeddings, ref)
    value = cmmd(ref, gen, args.sigma, args.scale)
    print(f"CMMD: {value:.4f}")
    return {"cmmd": value, "ref": ref, "gen": gen}


if __name__ == "__main__":
    main()

"""CLIP-score between generated `.npy` images and their prompts, on one
CUDA card.

  python -m diffusion_pruning_tpu_torch.cli.clip_score GEN_DIR \
      --captions captions.json --clip_model /path/to/clip-vit-base-patch32

The counterpart of the JAX package's `scripts/metrics/clip_score.py
--backend jax`: the CLIP vision and text towers of a local folder
(`metrics/towers.py`) on the card, the images' and the captions' projected
embeddings, and their mean cosine times the folder's logit scale
(`metrics.clip_score`). Captions are a JSON list aligned with the sorted
`.npy` files. The JAX script's default backend, `transformers`' `CLIPModel`
on the CPU, is not available here (`--backend torch` raises). `--device cpu`
runs on the CPU; without it there must be a card.
"""
from __future__ import annotations

import argparse
import json
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="CLIP-score of generated images")
    p.add_argument("gen_dir")
    p.add_argument("--captions", required=True, help="json list aligned with sorted .npy files")
    p.add_argument("--clip_model", required=True)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--backend", choices=("torch", "jax"), default="jax",
                   help="'jax': the package's own CLIP towers (the JAX script's "
                        "accelerator path); 'torch' (transformers' CLIPModel) is not "
                        "available in the port")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu'")
    return p.parse_args(argv)


def check_backend(backend: str) -> None:
    if backend != "jax":
        raise NotImplementedError("--backend torch (transformers' CLIPModel) is not available "
                                  "in the port: its own towers are --backend jax's counterpart")


def main(argv=None) -> dict:
    """Print and return the score with the embeddings it came from."""
    import numpy as np

    from diffusion_pruning_tpu_torch.metrics import clip_score
    from diffusion_pruning_tpu_torch.metrics.towers import load_clip_towers, load_images
    from diffusion_pruning_tpu_torch.utils.device import resolve_device

    args = parse_args(argv)
    check_backend(args.backend)
    device = resolve_device(None if args.device == "cuda" else args.device)
    towers = load_clip_towers(args.clip_model, device)
    with open(args.captions) as f:
        captions = json.load(f)
    files = sorted(f for f in os.listdir(args.gen_dir) if f.endswith(".npy"))
    if len(files) != len(captions):
        raise ValueError(f"{len(files)} images in {args.gen_dir} but {len(captions)} captions")
    bs = args.batch_size
    img, txt = [], []
    for i in range(0, len(files), bs):
        img.append(towers.embed_images(load_images(args.gen_dir, files[i:i + bs])))
        txt.append(towers.embed_texts(captions[i:i + bs]))
    img, txt = np.concatenate(img), np.concatenate(txt)
    score = clip_score(img, txt, logit_scale=towers.logit_scale)
    print(f"CLIP-score: {score:.4f}")
    return {"score": score, "image_features": img, "text_features": txt}


if __name__ == "__main__":
    main()

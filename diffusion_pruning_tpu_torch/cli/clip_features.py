"""CLIP text features of a caption list, one `.npy` a caption, on one CUDA
card.

  python -m diffusion_pruning_tpu_torch.cli.clip_features \
      --captions captions.json --out_dir text_features \
      --clip_model /path/to/clip-vit-base-patch32

The counterpart of the JAX package's `scripts/metrics/clip_features.py`,
with the port's CLIP text tower (`metrics/towers.py`) in place of
`transformers`' `CLIPModel`: each caption's projected text feature (f32) as
`{i:06d}.npy` under `--out_dir`. `--device cpu` runs on the CPU; without it
there must be a card.
"""
from __future__ import annotations

import argparse
import json
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="CLIP text features, one .npy a caption")
    p.add_argument("--captions", required=True, help="json list of captions")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--clip_model", required=True, help="local CLIP folder")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu'")
    return p.parse_args(argv)


def main(argv=None) -> int:
    """Write the features; returns the number of captions."""
    import numpy as np

    from diffusion_pruning_tpu_torch.metrics.towers import load_clip_towers
    from diffusion_pruning_tpu_torch.utils.device import resolve_device

    args = parse_args(argv)
    device = resolve_device(None if args.device == "cuda" else args.device)
    towers = load_clip_towers(args.clip_model, device)
    with open(args.captions) as f:
        captions = json.load(f)
    os.makedirs(args.out_dir, exist_ok=True)
    for i in range(0, len(captions), args.batch_size):
        feats = towers.embed_texts(captions[i:i + args.batch_size])
        for j, feat in enumerate(feats):
            np.save(os.path.join(args.out_dir, f"{i + j:06d}.npy"), feat)
    print(f"{len(captions)} text features → {args.out_dir}")
    return len(captions)


if __name__ == "__main__":
    main()

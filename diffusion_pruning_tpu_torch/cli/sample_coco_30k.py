"""Build the COCO-30k FID reference set.

  python -m diffusion_pruning_tpu_torch.cli.sample_coco_30k \
      --data_dir /path/to/coco --out_dir coco30k

The port's copy of the JAX package's `scripts/metrics/sample_coco_30k.py`
(numpy and Pillow only): the val split's captions deduplicated by image
(the first caption of each), `--n` of them drawn without replacement by
`RandomState(--seed)`, each image resized bilinearly to `--resolution`² and
saved as `{j:06d}.npy` (uint8), with the kept annotations in
`annotations_30k.json`; unreadable images are skipped. Runs on the host.
"""
from __future__ import annotations

import argparse
import json
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Sample the COCO-30k FID reference set")
    p.add_argument("--data_dir", required=True)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--year", type=int, default=2014)
    p.add_argument("--n", type=int, default=30000)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--resolution", type=int, default=256)
    return p.parse_args(argv)


def main(argv=None) -> list:
    """Returns the kept annotations."""
    import numpy as np
    from PIL import Image

    args = parse_args(argv)
    ann_file = os.path.join(args.data_dir, "annotations", f"captions_val{args.year}.json")
    with open(ann_file) as f:
        ann = json.load(f)
    seen, rows = set(), []
    for a in ann["annotations"]:
        if a["image_id"] not in seen:
            seen.add(a["image_id"])
            rows.append(a)
    rng = np.random.RandomState(args.seed)
    idx = rng.choice(len(rows), size=min(args.n, len(rows)), replace=False)
    sample = [rows[i] for i in idx]

    img_dir = os.path.join(args.data_dir, "images", f"val{args.year}")
    os.makedirs(args.out_dir, exist_ok=True)
    kept = []
    for j, a in enumerate(sample):
        name = (f"COCO_val{args.year}_{a['image_id']:012d}.jpg"
                if args.year == 2014 else f"{a['image_id']:012d}.jpg")
        try:
            img = Image.open(os.path.join(img_dir, name)).convert("RGB").resize(
                (args.resolution, args.resolution), Image.BILINEAR)
        except OSError:
            continue
        np.save(os.path.join(args.out_dir, f"{j:06d}.npy"), np.asarray(img, dtype=np.uint8))
        kept.append(a)
    with open(os.path.join(args.out_dir, "annotations_30k.json"), "w") as f:
        json.dump({"annotations": kept}, f)
    print(f"{len(kept)} images → {args.out_dir}")
    return kept


if __name__ == "__main__":
    main()

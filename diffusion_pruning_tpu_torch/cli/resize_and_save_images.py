"""Resize a directory of images to uint8 `.npy` files: the reference side of
FID and CMMD.

  python -m diffusion_pruning_tpu_torch.cli.resize_and_save_images SRC OUT \
      [--resolution 256]

The port's copy of the JAX package's `scripts/metrics/resize_and_save_images.py`
(numpy and Pillow only): every `.jpg`, `.jpeg` and `.png` of `SRC`, sorted,
as RGB resized bilinearly to `--resolution`², saved as `<stem>.npy`; files
Pillow cannot read are skipped. Runs on the host.
"""
from __future__ import annotations

import argparse
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Resize images to uint8 .npy files")
    p.add_argument("src_dir")
    p.add_argument("out_dir")
    p.add_argument("--resolution", type=int, default=256)
    return p.parse_args(argv)


def main(argv=None) -> int:
    """Returns the number of images written."""
    import numpy as np
    from PIL import Image

    args = parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    n = 0
    for name in sorted(os.listdir(args.src_dir)):
        if not name.lower().endswith((".jpg", ".jpeg", ".png")):
            continue
        try:
            img = Image.open(os.path.join(args.src_dir, name)).convert("RGB")
        except OSError:
            continue
        img = img.resize((args.resolution, args.resolution), Image.BILINEAR)
        np.save(os.path.join(args.out_dir, os.path.splitext(name)[0] + ".npy"),
                np.asarray(img, dtype=np.uint8))
        n += 1
    print(f"{n} images → {args.out_dir}")
    return n


if __name__ == "__main__":
    main()

"""FID between generated `.npy` images and reference statistics, on one CUDA
card.

  python -m diffusion_pruning_tpu_torch.cli.fid GEN_DIR --ref_stats ref.npz \
      --inception /path/to/inception.pt

The counterpart of the JAX package's `scripts/metrics/fid.py` without its
clean-fid attempt (the package is on neither machine): the feature
extractor is a local TorchScript file that maps N×3×H×W float images in
0-255 to (N, D) features (an InceptionV3 traced from a local torchvision
install keeps clean-fid's reference statistics comparable), loaded onto the
card with `torch.jit.load(map_location=...)` and run 32 images at a time
over each directory's sorted `.npy` files (uint8 H×W×3). The reference is a
`.npz` with `mu` and `sigma`, or a directory of `.npy` images; the distance
is `metrics.frechet_distance` in float64. `--device cpu` runs on the CPU;
without it there must be a card.
"""
from __future__ import annotations

import argparse
import os

FID_BATCH = 32


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="FID of generated images")
    p.add_argument("gen_dir")
    p.add_argument("--ref_stats", required=True,
                   help=".npz with mu/sigma, or an image dir to compute from")
    p.add_argument("--inception", default=None,
                   help="local InceptionV3 TorchScript file (N×3×H×W in 0-255 → (N, D))")
    p.add_argument("--dataset_name", default="custom",
                   help="accepted for command-line compatibility (clean-fid's); no effect")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu'")
    return p.parse_args(argv)


def inception_features(image_dir: str, model, device, batch_size: int = FID_BATCH):
    """(N, D) f32 features of a directory's sorted `.npy` images; `model` is
    a loaded extractor or the path of its TorchScript file."""
    import numpy as np
    import torch

    if isinstance(model, str):
        model = torch.jit.load(model, map_location=device).eval()
    files = sorted(f for f in os.listdir(image_dir) if f.endswith(".npy"))
    feats = []
    with torch.inference_mode():
        for i in range(0, len(files), batch_size):
            imgs = np.stack([np.load(os.path.join(image_dir, f))
                             for f in files[i:i + batch_size]])
            x = torch.from_numpy(imgs).to(device).permute(0, 3, 1, 2).float()
            feats.append(model(x).float().cpu().numpy())
    return np.concatenate(feats)


def main(argv=None) -> dict:
    """Print and return FID with the generated images' features."""
    import numpy as np
    import torch

    from diffusion_pruning_tpu_torch.metrics import frechet_distance, gaussian_stats
    from diffusion_pruning_tpu_torch.utils.device import resolve_device

    args = parse_args(argv)
    if not args.inception:
        raise ValueError("--inception is required: a local TorchScript feature extractor "
                         "(clean-fid is not used by the port)")
    device = resolve_device(None if args.device == "cuda" else args.device)
    model = torch.jit.load(args.inception, map_location=device).eval()
    gen = inception_features(args.gen_dir, model, device)
    mu_g, sig_g = gaussian_stats(gen)
    if args.ref_stats.endswith(".npz"):
        ref = np.load(args.ref_stats)
        mu_r, sig_r = ref["mu"], ref["sigma"]
    else:
        mu_r, sig_r = gaussian_stats(inception_features(args.ref_stats, model, device))
    value = frechet_distance(mu_g, sig_g, mu_r, sig_r)
    print(f"FID: {value:.4f}")
    return {"fid": value, "features": gen}


if __name__ == "__main__":
    main()

"""Depth-gate ablation: how much each depth-gated subblock changes the
U-Net's output, on one CUDA card.

  python -m diffusion_pruning_tpu_torch.cli.depth_analysis \
      --base_config_path configs/pruning/sd-2-1_coco2014.yaml \
      --pretrained_model_name_or_path /path/to/stable-diffusion-2-1

The counterpart of the JAX package's `scripts/other/depth_analysis.py`: the
dense U-Net (f32) at an all-ones arch vector, then once per depth gate with
that gate alone at 0; each ablation's output MSE against the dense output
is printed beside the subblock's name (higher: more important). The inputs
are two latents and two text-state tensors of standard normals and the
timesteps 100 and 600, drawn from `torch.Generator(device).manual_seed(--seed)`;
`depth_ablation` takes them as arguments. `--device cpu` runs on the CPU;
without it there must be a card.
"""
from __future__ import annotations

import os
from typing import List, Tuple

import torch


@torch.inference_mode()
def depth_ablation(unet, x: torch.Tensor, t: torch.Tensor, ehs: torch.Tensor
                   ) -> List[Tuple[str, float]]:
    """(subblock name, MSE against the all-ones output) per depth gate, in
    depth-index order, for latents `x` (B, h, w, C), timesteps `t` (B,) and
    text states `ehs` (B, S, D)."""
    spec = unet.spec
    b = x.shape[0]
    ones = torch.ones(b, spec.vq_dim, device=x.device)
    dense = unet(x, t, ehs, arch=ones).float()
    names = [sb.name for sb in spec.subblocks if sb.depth_index >= 0]
    out = []
    for d in range(spec.num_depth):
        arch = ones.clone()
        arch[:, spec.num_width + d] = 0.0
        mse = float(((unet(x, t, ehs, arch=arch).float() - dense) ** 2).mean())
        out.append((names[d], mse))
    return out


def main(argv=None) -> List[Tuple[str, float]]:
    """Print the ablation; returns its (name, MSE) rows."""
    from diffusion_pruning_tpu_torch.training.factory import build_unet, unet_config_from_yaml
    from diffusion_pruning_tpu_torch.utils.arg_utils import parse_args
    from diffusion_pruning_tpu_torch.utils.config import load_config
    from diffusion_pruning_tpu_torch.utils.device import resolve_device

    args = parse_args(argv)
    cfg = load_config(args.base_config_path)
    device = resolve_device(None if args.device == "cuda" else args.device)
    sd_root = args.pretrained_model_name_or_path
    tiny = not os.path.exists(os.path.join(sd_root or "", "unet"))
    ucfg = unet_config_from_yaml(cfg, tiny=tiny)
    unet = build_unet(ucfg, sd_root, device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    b = 2
    s = ucfg.sample_size
    x = torch.randn((b, s, s, ucfg.in_channels), generator=gen, device=device)
    t = torch.tensor([100, 600], device=device)
    ehs = torch.randn((b, ucfg.max_text_len, ucfg.cross_attention_dim), generator=gen,
                      device=device)
    rows = depth_ablation(unet, x, t, ehs)
    print("depth-gate ablation: output MSE vs dense (higher = more important)")
    for d, (name, mse) in enumerate(rows):
        print(f"  depth {d:2d} ({name:>18s}): {mse:.6f}")
    return rows


if __name__ == "__main__":
    main()

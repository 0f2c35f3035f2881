"""Offline MACs report for every codebook expert of a stage-1 run.

  python -m diffusion_pruning_tpu_torch.cli.calculate_pruning_ratio \
      --base_config_path configs/pruning/sd-2-1_coco2014.yaml \
      --pruning_ckpt_dir runs/<stage-1 run>

The counterpart of the JAX package's `scripts/other/calculate_pruning_ratio.py`,
printing the same lines: the dense U-Net's total and prunable MACs, then per
row of the newest `quantizer_embeddings.pt` its MACs ratio
(`expert_macs_ratio`), its dropped subblocks and its mean kept width share,
all from the structure spec (no forward pass, no device). The spec is the
tiny U-Net's without `<pretrained_model_name_or_path>/unet`.
"""
from __future__ import annotations

import os
from typing import List


def report(spec, embeddings) -> List[str]:
    """The report's lines for a (K, vq_dim) array of arch vectors."""
    import numpy as np

    from diffusion_pruning_tpu_torch.models.unet.pruned import expert_macs_ratio, make_expert_plan

    lines = [f"dense total MACs: {spec.total_macs / 1e9:.2f} G "
             f"(prunable {spec.prunable_macs / 1e9:.2f} G)"]
    for i, arch in enumerate(np.asarray(embeddings)):
        plan = make_expert_plan(spec, arch)
        ratio = expert_macs_ratio(spec, plan)
        dropped = sum(sb.dropped for sb in plan.subblocks)
        width_keep = float(np.mean([(arch[s.start:s.start + s.width] >= 0.5).mean()
                                    for sb in spec.subblocks for s in sb.sites]))
        lines.append(f"expert {i}: MACs ratio {ratio:.3f}  dropped subblocks {dropped}/"
                     f"{spec.num_depth}  mean width keep {width_keep:.3f}")
    return lines


def main(argv=None) -> List[str]:
    """Print the report; returns its lines."""
    import numpy as np

    from diffusion_pruning_tpu_torch.core.structure import build_structure
    from diffusion_pruning_tpu_torch.training.factory import unet_config_from_yaml
    from diffusion_pruning_tpu_torch.utils.arg_utils import parse_args
    from diffusion_pruning_tpu_torch.utils.checkpoint import (
        latest_checkpoint_dir,
        load_torch_artifact,
    )
    from diffusion_pruning_tpu_torch.utils.config import load_config

    args = parse_args(argv)
    if not args.pruning_ckpt_dir:
        raise ValueError("--pruning_ckpt_dir is required")
    cfg = load_config(args.base_config_path)
    tiny = not os.path.exists(os.path.join(args.pretrained_model_name_or_path or "", "unet"))
    spec = build_structure(unet_config_from_yaml(cfg, tiny=tiny))
    latest = latest_checkpoint_dir(args.pruning_ckpt_dir)
    emb = load_torch_artifact(os.path.join(latest or args.pruning_ckpt_dir,
                                           "quantizer_embeddings.pt"))
    lines = report(spec, np.asarray(emb.float()))
    for line in lines:
        print(line)
    return lines


if __name__ == "__main__":
    main()

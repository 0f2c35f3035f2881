"""Baseline FID image generation (dense SD, magnitude, random, structural),
on one CUDA card.

  python -m diffusion_pruning_tpu_torch.cli.generate_images \
      --base_config_path configs/baselines/img_generation/sd-2-1_cc3m_magnitude.yaml \
      --pretrained_model_name_or_path /path/to/stable-diffusion-2-1 \
      --pruning_type magnitude

The counterpart of the JAX package's `scripts/baselines/generate_images.py`:
`--pruning_type` picks the U-Net as `cli/finetune_baseline.py` picks the
student (`no-pruning` the dense U-Net; `magnitude` the globally
magnitude-ranked units at the resource loss's `pruning_target`; `random`
from `--seed`; `structural` `--finetuning_ckpt_dir`/arch_vector.pt), a
pruned one holding the stage-2 masters of `--finetuning_ckpt_dir` where it
is given; then the validation captions (at most `data.max_generated_samples`;
synthetic ones where the dataset folder is missing) through
`cli/generate_fid_images.py`'s pipeline and writer into
`<logging_dir>/fid_images_baseline_<type>/`. `--device cpu` runs on the CPU;
without it there must be a card.
"""
from __future__ import annotations

import os

PRUNING_TYPES = ("no-pruning", "magnitude", "random", "structural")


def main(argv=None) -> str:
    """Generate the baseline's images; returns their folder."""
    from diffusion_pruning_tpu_torch.cli.finetune_baseline import pick_arch
    from diffusion_pruning_tpu_torch.cli.generate_fid_images import (
        expert_captions,
        generation_pipeline,
        write_images,
    )
    from diffusion_pruning_tpu_torch.utils.arg_utils import parse_args
    from diffusion_pruning_tpu_torch.utils.config import load_config
    from diffusion_pruning_tpu_torch.utils.device import resolve_device

    args = parse_args(argv)
    pruning_type = args.pruning_type or "no-pruning"
    if pruning_type not in PRUNING_TYPES:
        raise ValueError(f"--pruning_type must be one of {PRUNING_TYPES}, got {pruning_type!r}")
    cfg = load_config(args.base_config_path)
    cfg.update_flat(vars(args))
    device = resolve_device(None if args.device == "cuda" else args.device)
    weights = args.finetuning_ckpt_dir if pruning_type != "no-pruning" else None
    pipe, tok = generation_pipeline(args, cfg, device, weights_dir=weights,
                                    pick_arch=pick_arch(args, cfg, pruning_type))
    caps = expert_captions(cfg, None, None)
    out_dir = os.path.join(cfg.training.logging.get("logging_dir", "runs"),
                           f"fid_images_baseline_{pruning_type}")
    write_images(pipe, tok, caps, out_dir,
                 cfg.data.dataloader.get("image_generation_batch_size", 4),
                 cfg.training.get("num_inference_steps", 25), args.seed)
    print(out_dir)
    return out_dir


if __name__ == "__main__":
    main()

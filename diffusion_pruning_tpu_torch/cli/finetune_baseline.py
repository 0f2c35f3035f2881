"""Baseline fine-tuning entry point: one YAML config and flags, and
`--pruning_type` picks the student, on one CUDA card.

  python -m diffusion_pruning_tpu_torch.cli.finetune_baseline \
      --base_config_path configs/finetuning/sd-2-1_coco2014.yaml \
      --pretrained_model_name_or_path /path/to/stable-diffusion-2-1 \
      --pruning_type magnitude

The counterpart of the JAX package's `scripts/baselines/finetune_baseline.py`:

  no-pruning   the dense U-Net as the student (plain SD fine-tuning)
  magnitude    the globally magnitude-ranked gate units at the resource
               loss's `pruning_target` (`models/unet/magnitude.py`)
  random       ⌊target · width⌋ random units a group
               (`models/hypernet.random_arch_vector`, from `--seed`)
  structural   the arch vector of a fine-tuning run,
               `--finetuning_ckpt_dir`/arch_vector.pt
  single-arch  the uni-architecture vector, `--pruning_ckpt_dir`/arch_vector.pt

Each runs through the same student, teacher and loop as `cli/finetune.py`
(run directory `<logging_dir>/<config>/baseline-<type>`), whose rules for
devices, launch and unported options hold here too. Under torchrun it runs
data parallel only, without ZeRO-1 or tensor parallelism, as the JAX entry
point does (`optim.zero1` and `optim.tensor_parallel` > 1 raise).
"""
from __future__ import annotations

import os

import torch

PRUNING_TYPES = ("no-pruning", "magnitude", "random", "structural", "single-arch")


def pick_arch(args, cfg, pruning_type: str):
    """The baseline's arch vector from the dense U-Net (None: dense)."""
    from diffusion_pruning_tpu_torch.models.hypernet import random_arch_vector
    from diffusion_pruning_tpu_torch.models.unet.magnitude import magnitude_arch_vector
    from diffusion_pruning_tpu_torch.utils.checkpoint import load_torch_artifact

    target = cfg.training.losses.resource_loss.get("pruning_target", 0.6)

    def pick(dense):
        if pruning_type == "no-pruning":
            return None
        if pruning_type == "magnitude":
            return magnitude_arch_vector(dense.spec, dense.state_dict(), target, seed=args.seed)
        if pruning_type == "random":
            return random_arch_vector(dense.spec, target,
                                      torch.Generator().manual_seed(args.seed)).numpy()
        folder = args.finetuning_ckpt_dir if pruning_type == "structural" else args.pruning_ckpt_dir
        if not folder:
            raise ValueError(f"--pruning_type {pruning_type} needs "
                             + ("--finetuning_ckpt_dir" if pruning_type == "structural"
                                else "--pruning_ckpt_dir"))
        return load_torch_artifact(os.path.join(folder, "arch_vector.pt")).float().numpy()

    return pick


def main(argv=None):
    """Fine-tune the `--pruning_type` baseline; returns the finished `FineTuneLoop`."""
    from diffusion_pruning_tpu_torch.cli.finetune import data_parallel, fine_tune
    from diffusion_pruning_tpu_torch.cli.prune import start_run
    from diffusion_pruning_tpu_torch.utils.arg_utils import parse_args
    from diffusion_pruning_tpu_torch.utils.config import load_config

    args = parse_args(argv)
    pruning_type = args.pruning_type or "no-pruning"
    cfg = load_config(args.base_config_path)
    cfg.update_flat(vars(args))
    device, mesh, zero1 = data_parallel(args, cfg, zero1_default=False, tensor_parallel=False)
    if zero1:
        raise ValueError("optim.zero1: the baseline entry point runs data parallel without "
                         "ZeRO-1, as the JAX one does")
    run_dir = start_run(mesh, cfg, args.base_config_path, f"baseline-{pruning_type}")
    loop = fine_tune(args, cfg, run_dir, device, pick_arch(args, cfg, pruning_type),
                     pruning_type, mesh=mesh)
    print(f"done: {run_dir}")
    return loop


if __name__ == "__main__":
    main()

"""Stage 1 (prompt-adaptive pruning) entry point: a YAML config and flags →
the router's training run, on one CUDA card.

  python -m diffusion_pruning_tpu_torch.cli.prune \
      --base_config_path configs/pruning/sd-2-1_coco2014.yaml \
      --pretrained_model_name_or_path /path/to/stable-diffusion-2-1 \
      --prompt_encoder_model_name_or_path /path/to/all-mpnet-base-v2

The steps of the JAX package's `scripts/aptp/prune.py`: config and flags →
run directory (with a copy of the config) → the models from local
checkpoints (`training/factory.py`; without `<sd_root>/unet` every model is
the tiny one, randomly initialised) → the step's config from the YAML's
losses and optimiser → AdamW → the loop → synthetic batches, since the
dataset is missing → `gradient_accumulation_steps` micro-batches a step →
the U-Net exported beside each checkpoint unless
`training.logging.export_unet: false` → train. `--device cpu` runs on the
CPU (the plain versions of the kernels); without it there must be a card.

Not yet here: a real dataset (`data_dir` that exists) with its tokenizers
and periodic sample images, and the Hub upload, which wait for the data and
tokenizer slice (A6 of ROADMAP.md); more than one device (`--mesh_shape`),
which waits for the data-parallel step (A4). Each raises before anything is
built.
"""
from __future__ import annotations

import functools
import os
import sys

import numpy as np
import torch


def _device(name: str) -> torch.device:
    from diffusion_pruning_tpu_torch.utils.device import resolve_device
    return resolve_device(None if name == "cuda" else name)


def main(argv=None):
    """Run stage 1; returns the finished `PrunerLoop`."""
    from diffusion_pruning_tpu_torch.training import (
        PrunerConfig,
        PrunerModules,
        make_optimizer,
        make_pruner_step,
        make_validation_step,
    )
    from diffusion_pruning_tpu_torch.training.factory import (
        build_hypernet,
        build_mpnet,
        build_quantizer,
        build_schedule,
        build_text_encoder,
        build_unet,
        build_vae,
        unet_config_from_yaml,
    )
    from diffusion_pruning_tpu_torch.training.loop import LoopConfig, PrunerLoop
    from diffusion_pruning_tpu_torch.utils.arg_utils import parse_args
    from diffusion_pruning_tpu_torch.utils.config import load_config
    from diffusion_pruning_tpu_torch.utils.logging_utils import (
        Tracker,
        init_logging,
        make_run_dir,
    )

    args = parse_args(argv)
    if args.mesh_shape is not None and int(args.mesh_shape) > 1:
        raise NotImplementedError("--mesh_shape > 1 needs the data-parallel stage-1 step "
                                  "(ROADMAP A4), not ported yet")
    cfg = load_config(args.base_config_path)
    cfg.update_flat(vars(args))
    data_dir = cfg.data.get("data_dir") or ""
    if os.path.exists(data_dir):
        raise NotImplementedError(f"data_dir {data_dir!r} exists: real datasets, their "
                                  "tokenizers and the sample-image logger are ROADMAP A6, "
                                  "not ported yet")
    if cfg.get_path("training.hf_hub.push_to_hub", False):
        raise NotImplementedError("training.hf_hub.push_to_hub: the Hub upload is ROADMAP A6, "
                                  "not ported yet")
    device = _device(args.device)

    logging_cfg = cfg.training.get("logging") or {}
    run_dir = make_run_dir(logging_cfg.get("logging_dir", "runs"), args.base_config_path,
                           args.wandb_run_name)
    init_logging(run_dir)
    cfg.dump(os.path.join(run_dir, "config.yaml"))

    sd_root = args.pretrained_model_name_or_path
    tiny = not os.path.exists(os.path.join(sd_root or "", "unet"))
    # frozen-model precision: training.mixed_precision, else the compute dtype
    mp = cfg.training.get("mixed_precision") or args.compute_dtype
    frozen_dtype = torch.bfloat16 if mp in ("bf16", "bfloat16") else torch.float32

    ucfg = unet_config_from_yaml(cfg, tiny=tiny)
    unet = build_unet(ucfg, sd_root, device, frozen_dtype)
    vae = build_vae(sd_root, tiny=tiny, device=device, dtype=frozen_dtype)
    text = build_text_encoder(sd_root, tiny=tiny, device=device, dtype=frozen_dtype)
    mpnet = build_mpnet(args.prompt_encoder_model_name_or_path, tiny=tiny, device=device)
    mp_dim = 768 if not tiny else mpnet.cfg.hidden_size
    hypernet = build_hypernet(unet.spec, cfg, input_dim=mp_dim, device=device)
    quantizer = build_quantizer(unet.spec, cfg, device=device)
    mods = PrunerModules(unet=unet, vae=vae, text_encoder=text, hypernet=hypernet,
                         quantizer=quantizer, schedule=build_schedule(cfg))

    losses = cfg.training.losses
    optim = cfg.training.optim
    pruner_cfg = PrunerConfig(
        snr_gamma=losses.diffusion_loss.get("snr_gamma"),
        diffusion_weight=losses.diffusion_loss.get("weight", 1.0),
        resource_weight=losses.resource_loss.get("weight", 2.0),
        resource_type=losses.resource_loss.get("type", "log"),
        pruning_target=losses.resource_loss.get("pruning_target", 0.6),
        contrastive_weight=losses.contrastive_loss.get("weight", 100.0),
        arch_temperature=losses.contrastive_loss.get("arch_vector_temperature", 0.03),
        prompt_temperature=losses.contrastive_loss.get("prompt_embedding_temperature", 0.03),
        distillation_weight=losses.distillation_loss.get("weight", 0.2),
        block_weight=losses.block_loss.get("weight", 0.2),
        std_weight=losses.std_loss.get("weight", 0.1),
        max_weight=losses.max_loss.get("weight", 0.1),
        hypernet_lr=float(optim.get("hypernet_learning_rate", 2e-4)),
        quantizer_lr=float(optim.get("quantizer_learning_rate", 2e-4)),
        lr_warmup_steps=optim.get("lr_warmup_steps", 100),
        scale_lr=optim.get("scale_lr", True),
        max_grad_norm=optim.get("max_grad_norm"),
        noise_offset=cfg.model.unet.get("noise_offset", 0.0) or 0.0,
        input_perturbation=cfg.model.unet.get("input_perturbation", 0.0) or 0.0,
        max_scheduler_steps=cfg.model.unet.get("max_scheduler_steps"),
    )
    global_batch = cfg.data.dataloader.get("train_batch_size", 8)  # one device
    optimizer = make_optimizer(pruner_cfg, mods, global_batch)

    loop_cfg = LoopConfig(
        max_train_steps=cfg.training.get("max_train_steps", 5000),
        hypernet_pretraining_steps=cfg.training.get("hypernet_pretraining_steps", 500),
        validation_steps=cfg.training.get("validation_steps", 1000),
        image_logging_steps=cfg.training.get("image_logging_steps", 1000),
        checkpoints_total_limit=logging_cfg.get("checkpoints_total_limit", 1),
        resume_from=logging_cfg.get("resume_from_checkpoint"),
    )

    # synthetic data: the dataset is missing
    print(f"[smoke] dataset dir {data_dir!r} missing — synthetic data", file=sys.stderr)
    resolution = ucfg.sample_size * 8
    rng = np.random.RandomState(args.seed)

    def synth(n):
        def gen(_epoch=0):
            for _ in range(n):
                yield {
                    "pixel_values": rng.randn(global_batch, resolution, resolution, 3
                                              ).astype(np.float32) * 0.5,
                    "input_ids": rng.randint(0, 128, (global_batch, 77)).astype(np.int32),
                    "mpnet_embeddings": rng.randn(global_batch, mp_dim).astype(np.float32),
                }
        return gen

    train_batches = synth(max(loop_cfg.max_train_steps, 1))

    def val_batches():
        return synth(2)(0)

    accum = int(cfg.training.get("gradient_accumulation_steps", 1))
    make_step = (functools.partial(make_pruner_step, accum_steps=accum)
                 if accum > 1 else make_pruner_step)
    loop = PrunerLoop(mods, pruner_cfg, loop_cfg, optimizer, make_step, make_validation_step,
                      run_dir, tracker=Tracker(run_dir,
                                               use_wandb=logging_cfg.get("report_to") == "wandb"),
                      seed=args.seed)
    # the original code writes unet/ into every pruning checkpoint; stage 1
    # leaves the U-Net frozen, so this is the pretrained weights again
    if logging_cfg.get("export_unet", True):
        loop.export_unet_ref = unet
    loop.train(train_batches, val_batches)
    print(f"done: {run_dir}")
    return loop


if __name__ == "__main__":
    main()

"""Stage 2 (expert fine-tuning) entry point: a stage-1 checkpoint, a YAML
config and flags → one fine-tuned physically pruned expert, on one CUDA card.

  python -m diffusion_pruning_tpu_torch.cli.finetune \
      --base_config_path configs/finetuning/sd-2-1_coco2014.yaml \
      --pretrained_model_name_or_path /path/to/stable-diffusion-2-1 \
      --pruning_ckpt_dir runs/sd-2-1_coco2014/<run> --expert_id 3

The steps of the JAX package's `scripts/aptp/finetune.py`: config and flags →
run directory → codebook row `--expert_id` of `quantizer_embeddings.pt` in the
newest `checkpoint-N/` of `--pruning_ckpt_dir` as the arch vector (written to
the run directory as `arch_vector.pt`) → the dense U-Net from local weights
(`training/factory.py`; without `<sd_root>/unet` every model is the tiny one,
randomly initialised) → the expert cut from it as a student that owns its
tensors, f32 masters in the optimizer and a compute copy in `--compute_dtype`
→ the dense U-Net as the frozen teacher in `training.mixed_precision` (else
the compute dtype) → the MACs ratio printed → AdamW → the loop
(`gradient_accumulation_steps` micro-batches a step;
`resume_from_checkpoint`) → the model card. With a dataset folder
(`data.data_dir` that exists) the batches come from its train split with
CLIP ids (`<sd_root>/tokenizer`, else the hash tokenizer), and only the
captions the router gave `--expert_id` are kept when
`{dataset_name}_train_mapped_indices.pt` (`cli/filter_dataset.py`) is in
`--pruning_ckpt_dir`; without one, synthetic batches.
`--device cpu` runs on the CPU (the plain versions of the kernels); without
it there must be a card.

Beyond the JAX entry point: the config's `noise_offset`,
`input_perturbation`, `max_grad_norm` and `adam_mu_bf16` reach the step;
`--use_ema` (or `model.unet.use_ema`) keeps an EMA of the weights at decay
`EMA_DECAY`; every `validation_steps` the validation split's first
`max_validation_samples` images (two synthetic batches without a dataset)
are validated.

Data parallel under torchrun, with the launch, batch and writing rules of
`cli/prune.py` (`train_batch_size` per rank, the learning rate scaled by
√global batch, each rank its rows of the global batch and its own draws,
rank 0 alone writing): `optim.zero1` (ZeRO-1, the AdamW moments sharded over
the ranks) defaults to on when the world size exceeds 1, as in the JAX entry
point; asked for at world size 1 it runs on a mesh of one process.

Tensor parallel under torchrun (`optim.tensor_parallel: M` > 1, the JAX
entry point's 2-D branch): the world (a multiple of M, else it raises) forms
a `dp_tp_mesh(world // M, M)`; the global batch is `train_batch_size` ×
world // M, each data rank's rows shared by its M model ranks; the student
(the expert at its uneven kept widths) and the teacher are sharded on the
model axis (`parallel.tp.shard_unet`); the step is
`make_finetune_step_gspmd` with AdamW on the master shards and no ZeRO-1;
checkpoints hold full tensors, as at M = 1.

With `training.hf_hub.push_to_hub`, rank 0 of the expert entry point uploads
the run directory once the loop has ended and the model card is written
(`utils/hub.maybe_push_to_hub`, after the loop's final barrier); the
baseline entry point uploads nothing, as the JAX one.
"""
from __future__ import annotations

import os
import sys
from typing import Callable, Optional

import numpy as np
import torch

from diffusion_pruning_tpu_torch.utils.launch import world_size

EMA_DECAY = 0.9999  # diffusers' EMAModel default


def finetune_config(cfg):
    from diffusion_pruning_tpu_torch.training import FineTuneConfig
    losses, optim, unet = cfg.training.losses, cfg.training.optim, cfg.model.unet
    return FineTuneConfig(
        snr_gamma=losses.diffusion_loss.get("snr_gamma"),
        diffusion_weight=losses.diffusion_loss.get("weight", 1.0),
        distillation_weight=(losses.get("distillation_loss") or {}).get("weight", 0.2),
        block_weight=(losses.get("block_loss") or {}).get("weight", 0.2),
        unet_lr=float(optim.get("unet_learning_rate", 1e-5)),
        lr_warmup_steps=optim.get("lr_warmup_steps", 100),
        scale_lr=optim.get("scale_lr", True),
        max_grad_norm=optim.get("max_grad_norm"),
        adam_mu_bf16=bool(optim.get("adam_mu_bf16", False)),
        noise_offset=unet.get("noise_offset", 0.0) or 0.0,
        input_perturbation=unet.get("input_perturbation", 0.0) or 0.0,
    )


def fine_tune(args, cfg, run_dir: str, device: torch.device, pick_arch: Callable, label: str,
              expert_id: Optional[int] = None, mesh=None, zero1: bool = False):
    """Build the teacher and the student of `pick_arch(dense U-Net)` (an arch
    vector, or None for the dense student), train on the dataset folder's
    train split (only `expert_id`'s captions, where the router's assignment
    is in `--pruning_ckpt_dir`) or on synthetic batches, write the model
    card; returns the finished `FineTuneLoop`. Shared by the baseline entry
    point, which passes no `expert_id` and so trains on every caption. With
    a data `mesh` each rank trains on its rows of the global batch, ZeRO-1
    when `zero1`, and rank 0 alone writes."""
    from diffusion_pruning_tpu_torch.models.unet.pruned import expert_macs_ratio, make_expert_plan
    from diffusion_pruning_tpu_torch.parallel.tp import DpTpMesh, shard_unet
    from diffusion_pruning_tpu_torch.training import (
        FineTunerModules,
        MasterWeights,
        make_finetune_optimizer,
        make_finetune_step,
        make_finetune_validation_step,
    )
    from diffusion_pruning_tpu_torch.training.finetuner import make_finetune_step_gspmd
    from diffusion_pruning_tpu_torch.training.factory import (
        build_schedule,
        build_student,
        build_text_encoder,
        build_unet,
        build_vae,
        unet_config_from_yaml,
    )
    from diffusion_pruning_tpu_torch.cli.prune import rank_rows
    from diffusion_pruning_tpu_torch.training.loop import FineTuneLoop, LoopConfig
    from diffusion_pruning_tpu_torch.utils.checkpoint import save_torch_artifact
    from diffusion_pruning_tpu_torch.utils.logging_utils import NullTracker, Tracker
    from diffusion_pruning_tpu_torch.utils.model_card import write_model_card

    sd_root = args.pretrained_model_name_or_path
    tiny = not os.path.exists(os.path.join(sd_root or "", "unet"))
    # frozen-model precision: training.mixed_precision, else the compute dtype
    mp = cfg.training.get("mixed_precision") or args.compute_dtype
    frozen_dtype = torch.bfloat16 if mp in ("bf16", "bfloat16") else torch.float32
    compute_dtype = torch.bfloat16 if args.compute_dtype == "bfloat16" else torch.float32

    ucfg = unet_config_from_yaml(cfg, tiny=tiny)
    dense = build_unet(ucfg, sd_root, device, torch.float32)  # f32: the student's masters
    arch = pick_arch(dense)
    plan = None if arch is None else make_expert_plan(dense.spec, arch)
    student = build_student(dense, plan, mesh=mesh)
    macs = 1.0 if plan is None else expert_macs_ratio(dense.spec, plan)
    teacher = dense.to(frozen_dtype)
    del dense
    tp = mesh if isinstance(mesh, DpTpMesh) else None
    if tp is not None:  # each rank's slices of both (the expert's at its kept widths)
        student, teacher = shard_unet(student, tp), shard_unet(teacher, tp)
    # the masters take the student's f32 values; the cast then makes its
    # parameters the compute copy that forward and backward run on
    masters = MasterWeights(student, separate=compute_dtype != torch.float32)
    student.to(compute_dtype)
    print(f"{label}: MACs ratio {macs:.3f} of dense", file=sys.stderr)
    main_rank = mesh is None or mesh.is_main
    if arch is not None and main_rank:
        save_torch_artifact(np.asarray(arch), os.path.join(run_dir, "arch_vector.pt"))
    vae = build_vae(sd_root, tiny=tiny, device=device, dtype=frozen_dtype)
    text = build_text_encoder(sd_root, tiny=tiny, device=device, dtype=frozen_dtype)
    mods = FineTunerModules(student=student, teacher=teacher, vae=vae, text_encoder=text,
                            schedule=build_schedule(cfg))

    ft_cfg = finetune_config(cfg)
    rows = mesh if tp is None else tp.data  # the axis the global batch's rows split over
    n_data = 1 if rows is None else rows.world_size
    global_batch = cfg.data.dataloader.get("train_batch_size", 8) * n_data  # per rank × ranks
    optimizer = make_finetune_optimizer(ft_cfg, masters, global_batch,
                                        zero1_mesh=mesh if zero1 else None)
    accum = int(cfg.training.get("gradient_accumulation_steps", 1))
    if tp is None:
        step = make_finetune_step(mods, ft_cfg, optimizer, accum_steps=accum, zero1=zero1,
                                  mesh=mesh)
    else:
        step = make_finetune_step_gspmd(mods, ft_cfg, optimizer, tp, accum_steps=accum)
    logging_cfg = cfg.training.get("logging") or {}
    loop_cfg = LoopConfig(
        max_train_steps=cfg.training.get("max_train_steps", 30000),
        validation_steps=cfg.training.get("validation_steps", 1000),
        checkpoints_total_limit=logging_cfg.get("checkpoints_total_limit", 1),
        resume_from=logging_cfg.get("resume_from_checkpoint"),
    )
    use_ema = args.use_ema or bool(cfg.model.unet.get("use_ema", False))
    tracker = (Tracker(run_dir, use_wandb=logging_cfg.get("report_to") == "wandb")
               if main_rank else NullTracker())
    loop = FineTuneLoop(step, make_finetune_validation_step(mods, ft_cfg, mesh=mesh), optimizer,
                        loop_cfg, run_dir, arch_vector=arch, tracker=tracker, seed=args.seed,
                        ema_decay=EMA_DECAY if use_ema else None, mesh=mesh,
                        shard=None if tp is None else student.shard)

    resolution = ucfg.sample_size * 8
    data_dir = cfg.data.get("data_dir") or ""
    if os.path.exists(data_dir):
        train_batches, val_batches = dataset_batches(args, cfg, text, resolution, global_batch,
                                                     expert_id, rows)
    else:
        print(f"[smoke] dataset dir {data_dir!r} missing — synthetic data", file=sys.stderr)
        train_batches, val_batches = rank_rows(rows, *synthetic_batches(
            args.seed, global_batch, resolution, max(loop_cfg.max_train_steps, 1)))
    loop.train(train_batches, val_batches)
    if main_rank:
        write_model_card(run_dir, sd_root or "stable-diffusion-2-1",
                         cfg.data.get("dataset_name", "?"), expert_id=expert_id,
                         macs_ratio=macs, extra={"max_train_steps": loop_cfg.max_train_steps,
                                                 "unet_lr": ft_cfg.unet_lr})
    return loop


def synthetic_batches(seed: int, batch: int, resolution: int, steps: int):
    """(train_batches, val_batches) of normal pixels and random CLIP ids from
    `RandomState(seed)`, as the JAX entry point draws them."""
    rng = np.random.RandomState(seed)

    def synth(n):
        def gen(_epoch=0):
            for _ in range(n):
                yield {"pixel_values": rng.randn(batch, resolution, resolution, 3
                                                 ).astype(np.float32) * 0.5,
                       "input_ids": rng.randint(0, 128, (batch, 77)).astype(np.int32)}
        return gen

    return synth(steps), lambda: synth(2)(0)


def expert_rows(cols, pruning_dir: str, dataset_name: str, expert_id: int):
    """The train columns routed to `expert_id` when the router's assignment
    `{dataset_name}_train_mapped_indices.pt` is in `pruning_dir`, else all."""
    from diffusion_pruning_tpu_torch.utils.checkpoint import load_torch_artifact
    path = os.path.join(pruning_dir or "", f"{dataset_name}_train_mapped_indices.pt")
    if not os.path.exists(path):
        return cols
    keep = np.nonzero(np.asarray(load_torch_artifact(path)) == expert_id)[0]
    print(f"expert {expert_id}: {len(keep)} assigned prompts", file=sys.stderr)
    return {k: [v[i] for i in keep] for k, v in cols.items()}


def dataset_batches(args, cfg, text_encoder, resolution: int, batch: int,
                    expert_id: Optional[int] = None, mesh=None):
    """(train_batches, val_batches) of the dataset folder with CLIP ids: the
    train split (only `expert_id`'s captions where the router's assignment is
    there) and the validation split's first `max_validation_samples`. `batch`
    is the global batch; with a `mesh` (the axis the rows split over) the
    pipelines make this rank's rows (validation: validation_batch_size ×
    the mesh's ranks a global batch)."""
    from diffusion_pruning_tpu_torch.data import get_dataset
    from diffusion_pruning_tpu_torch.data.loader import DataPipeline
    from diffusion_pruning_tpu_torch.data.tokenizers import build_clip_tokenizer
    from diffusion_pruning_tpu_torch.parallel.mesh import rank_slice

    clip_tok = build_clip_tokenizer(args.pretrained_model_name_or_path,
                                    vocab_size=text_encoder.cfg.vocab_size)

    def tok_clip(caps):
        return np.asarray(clip_tok(caps, max_length=77, padding="max_length", truncation=True,
                                   return_tensors="np").input_ids)

    splits = get_dataset(cfg.data)
    train = splits["train"]
    if expert_id is not None:
        train = expert_rows(train, args.pruning_ckpt_dir, cfg.data.dataset_name, expert_id)
    world = 1 if mesh is None else mesh.world_size

    def rows(n):  # this rank's rows of a global batch of n
        return None if mesh is None else rank_slice(mesh, n)

    train_pipe = DataPipeline(train, batch, resolution, tok_clip, None, train=True,
                              seed=args.seed, rows=rows(batch))
    if not len(train_pipe):  # the loop would turn over empty epochs for ever
        raise ValueError(f"{len(train['caption'])} train captions fill no batch of {batch}")
    val_batch = cfg.data.dataloader.get("validation_batch_size", 16) * world
    val_pipe = DataPipeline(splits["validation"], val_batch, resolution,
                            tok_clip, None, train=False, seed=args.seed,
                            max_samples=cfg.data.get("max_validation_samples"),
                            rows=rows(val_batch))
    return train_pipe.epoch, lambda: val_pipe.epoch(0)


def data_parallel(args, cfg, zero1_default: bool = True, tensor_parallel: bool = True):
    """(device, mesh, zero1) of a finetune entry point: the launch
    (`cli.prune.launch`), the unported options refused, and either
    `optim.tensor_parallel` = M > 1 (where `tensor_parallel`; else it
    raises): the `dp_tp_mesh(world // M, M)`, no ZeRO-1; or `optim.zero1`
    (default: on when the world size exceeds 1 and `zero1_default`), which
    at world size 1 runs on a mesh of one process."""
    from diffusion_pruning_tpu_torch.cli.prune import launch
    from diffusion_pruning_tpu_torch.parallel.mesh import data_mesh
    from diffusion_pruning_tpu_torch.parallel.tp import dp_tp_mesh

    device, mesh = launch(args)
    world = world_size()
    optim = cfg.training.get("optim") or {}
    tp = int(optim.get("tensor_parallel", 1) or 1)
    if tp > 1:
        if not tensor_parallel:
            raise ValueError("optim.tensor_parallel > 1: the baseline entry point runs data "
                             "parallel only, as the JAX one does")
        if world % tp:
            raise ValueError(f"optim.tensor_parallel {tp} does not divide the world size "
                             f"{world} (torchrun --nproc_per_node sets it)")
        if optim.get("zero1"):
            raise ValueError("optim.zero1 with optim.tensor_parallel > 1: the 2-D step keeps "
                             "its AdamW moments at the master shards, without ZeRO-1")
        return device, dp_tp_mesh(world // tp, tp, device), False
    zero1 = bool(optim.get("zero1", zero1_default and world > 1))
    if zero1 and mesh is None:
        mesh = data_mesh(device)
    return device, mesh, zero1


def main(argv=None):
    """Fine-tune codebook row `--expert_id`; returns the finished `FineTuneLoop`."""
    from diffusion_pruning_tpu_torch.cli.prune import start_run
    from diffusion_pruning_tpu_torch.utils.arg_utils import parse_args
    from diffusion_pruning_tpu_torch.utils.checkpoint import (
        latest_checkpoint_dir,
        load_torch_artifact,
    )
    from diffusion_pruning_tpu_torch.utils.config import load_config
    from diffusion_pruning_tpu_torch.utils.hub import maybe_push_to_hub

    args = parse_args(argv)
    if not args.pruning_ckpt_dir or args.expert_id is None:
        raise ValueError("--pruning_ckpt_dir and --expert_id are required")
    cfg = load_config(args.base_config_path)
    cfg.update_flat(vars(args))
    device, mesh, zero1 = data_parallel(args, cfg)
    run_dir = start_run(mesh, cfg, args.base_config_path,
                        (args.wandb_run_name or "") + f"-expert{args.expert_id}")

    latest = latest_checkpoint_dir(args.pruning_ckpt_dir)
    embeddings = load_torch_artifact(os.path.join(latest or args.pruning_ckpt_dir,
                                                  "quantizer_embeddings.pt"))
    arch_vector = embeddings[args.expert_id].float().numpy()
    loop = fine_tune(args, cfg, run_dir, device, lambda dense: arch_vector,
                     f"expert {args.expert_id}", expert_id=args.expert_id, mesh=mesh, zero1=zero1)
    if loop.is_main:
        maybe_push_to_hub(cfg, run_dir)
    print(f"done: {run_dir}")
    return loop


if __name__ == "__main__":
    main()

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
losses and optimiser → AdamW → the loop → the batches: with a dataset folder
(`data.data_dir` that exists) the train and validation `DataPipeline`s of
its COCO or CC3M layout, with CLIP ids and MPNet's mean-pooled embedding
computed on the device (`data/tokenizers.py` reads `<sd_root>/tokenizer` and
the MPNet folder's `vocab.txt`, else the hash tokenizer), and every
`image_logging_steps` the routed samples of `data.prompts` and one sample
of every codebook row (`samples/`); without one, synthetic batches →
`gradient_accumulation_steps` micro-batches a step → the U-Net exported
beside each checkpoint unless `training.logging.export_unet: false` → train.
`--device cpu` runs on the CPU (the plain versions of the kernels); without
it there must be a card.

Data parallel under torchrun (`utils/launch.py`, the JAX entry point's
`init_distributed`):

  torchrun --nproc_per_node N -m diffusion_pruning_tpu_torch.cli.prune ...

`train_batch_size` is per rank: the global batch is train_batch_size ×
world (validation_batch_size × world for validation), and the learning rate
scales with √global batch. Every rank makes the global batch from the same
seed and keeps its rows (`parallel.mesh.shard_batch`): the synthetic batches
are drawn whole, a dataset folder's loader decodes only the rank's rows
where it can (`data/loader.py`), and each rank embeds its own rows with
MPNet on its device. Rank 0 makes the run directory and writes every file;
`--mesh_shape`, when given, must equal the world size.

With `training.hf_hub.push_to_hub`, rank 0 uploads the run directory once
the loop has ended (`utils/hub.maybe_push_to_hub`, after the loop's final
barrier).
"""
from __future__ import annotations

import functools
import os
import sys

import numpy as np
import torch

from diffusion_pruning_tpu_torch.models.text_encoders import MPNET_MAX_LEN, sentence_embedding
from diffusion_pruning_tpu_torch.utils.launch import world_size


def launch(args):
    """(device, mesh or None) of an entry point: the process group the
    launcher's environment asks for (`init_distributed`, first of all), with
    `--mesh_shape` held against its world size."""
    import torch.distributed as dist

    from diffusion_pruning_tpu_torch.parallel.mesh import data_mesh
    from diffusion_pruning_tpu_torch.utils.launch import init_distributed

    device = init_distributed(None if args.device == "cuda" else args.device)
    mesh = data_mesh(device) if dist.is_initialized() else None
    world = world_size()
    if args.mesh_shape is not None and int(args.mesh_shape) != world:
        raise ValueError(f"--mesh_shape {args.mesh_shape} differs from the world size {world} "
                         "the launch formed (torchrun --nproc_per_node sets it)")
    return device, mesh


def start_run(mesh, cfg, config_path: str, run_name) -> str:
    """The run directory `<logging_dir>/<config>/<run_name>` with the config's
    copy and the run's log file, made by rank 0 alone; every rank gets its
    path."""
    from diffusion_pruning_tpu_torch.parallel.mesh import broadcast_object
    from diffusion_pruning_tpu_torch.utils.logging_utils import init_logging, make_run_dir

    main_rank = mesh is None or mesh.is_main
    logging_dir = (cfg.training.get("logging") or {}).get("logging_dir", "runs")
    run_dir = make_run_dir(logging_dir, config_path, run_name) if main_rank else None
    if mesh is not None:
        run_dir = broadcast_object(mesh, run_dir)
    init_logging(run_dir if main_rank else None)
    if main_rank:
        cfg.dump(os.path.join(run_dir, "config.yaml"))
    return run_dir


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
    from diffusion_pruning_tpu_torch.utils.hub import maybe_push_to_hub
    from diffusion_pruning_tpu_torch.utils.logging_utils import NullTracker, Tracker

    args = parse_args(argv)
    device, mesh = launch(args)
    world = world_size()
    cfg = load_config(args.base_config_path)
    cfg.update_flat(vars(args))

    logging_cfg = cfg.training.get("logging") or {}
    run_dir = start_run(mesh, cfg, args.base_config_path, args.wandb_run_name)

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
    hypernet = build_hypernet(unet.spec, cfg, input_dim=mp_dim, device=device, mesh=mesh)
    quantizer = build_quantizer(unet.spec, cfg, device=device, mesh=mesh)
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
    global_batch = cfg.data.dataloader.get("train_batch_size", 8) * world  # per rank × world
    optimizer = make_optimizer(pruner_cfg, mods, global_batch)

    loop_cfg = LoopConfig(
        max_train_steps=cfg.training.get("max_train_steps", 5000),
        hypernet_pretraining_steps=cfg.training.get("hypernet_pretraining_steps", 500),
        validation_steps=cfg.training.get("validation_steps", 1000),
        image_logging_steps=cfg.training.get("image_logging_steps", 1000),
        checkpoints_total_limit=logging_cfg.get("checkpoints_total_limit", 1),
        resume_from=logging_cfg.get("resume_from_checkpoint"),
    )

    resolution = ucfg.sample_size * 8
    data_dir = cfg.data.get("data_dir") or ""
    if os.path.exists(data_dir):
        data = DatasetBatches(cfg, args, text, mpnet, resolution, global_batch, mesh)
        train_batches, val_batches = data.train_batches, data.val_batches
    else:
        print(f"[smoke] dataset dir {data_dir!r} missing — synthetic data", file=sys.stderr)
        train_batches, val_batches = rank_rows(mesh, *synthetic_batches(
            args.seed, global_batch, resolution, mp_dim, max(loop_cfg.max_train_steps, 1)))

    accum = int(cfg.training.get("gradient_accumulation_steps", 1))
    make_step = (functools.partial(make_pruner_step, accum_steps=accum)
                 if accum > 1 else make_pruner_step)
    tracker = (Tracker(run_dir, use_wandb=logging_cfg.get("report_to") == "wandb")
               if mesh is None or mesh.is_main else NullTracker())
    loop = PrunerLoop(mods, pruner_cfg, loop_cfg, optimizer, make_step, make_validation_step,
                      run_dir, tracker=tracker, seed=args.seed, mesh=mesh)
    # the original code writes unet/ into every pruning checkpoint; stage 1
    # leaves the U-Net frozen, so this is the pretrained weights again
    if logging_cfg.get("export_unet", True):
        loop.export_unet_ref = unet
    if cfg.data.get("prompts") and os.path.exists(data_dir):
        loop.image_logger = functools.partial(log_sample_images, data=data, run_dir=run_dir,
                                              steps=cfg.training.get("num_inference_steps", 50))
    loop.train(train_batches, val_batches)
    if mesh is None or mesh.is_main:
        maybe_push_to_hub(cfg, run_dir)
    print(f"done: {run_dir}")
    return loop


def synthetic_batches(seed: int, batch: int, resolution: int, mp_dim: int, steps: int):
    """(train_batches, val_batches) of normal pixels, random CLIP ids and MPNet
    embeddings from `RandomState(seed)`, as the JAX entry point draws them."""
    rng = np.random.RandomState(seed)

    def synth(n):
        def gen(_epoch=0):
            for _ in range(n):
                yield {
                    "pixel_values": rng.randn(batch, resolution, resolution, 3
                                              ).astype(np.float32) * 0.5,
                    "input_ids": rng.randint(0, 128, (batch, 77)).astype(np.int32),
                    "mpnet_embeddings": rng.randn(batch, mp_dim).astype(np.float32),
                }
        return gen

    return synth(steps), lambda: synth(2)(0)


def rank_rows(mesh, train_batches, val_batches):
    """The batch makers with each global batch cut to this rank's rows
    (unchanged without a mesh)."""
    if mesh is None:
        return train_batches, val_batches
    from diffusion_pruning_tpu_torch.parallel.mesh import shard_batch

    def train(epoch):
        return (shard_batch(mesh, b) for b in train_batches(epoch))

    return train, lambda: (shard_batch(mesh, b) for b in val_batches())


class DatasetBatches:
    """The dataset folder's batches for stage 1: both tokenizers, the train
    and validation `DataPipeline`s, and each batch's MPNet embedding (mean
    pooled, computed on the MPNet's device) in place of its MPNet ids and
    mask. `batch` is the global batch; with a `mesh` the pipelines make this
    rank's rows of each global batch, and only they are embedded."""

    def __init__(self, cfg, args, text_encoder, mpnet, resolution: int, batch: int,
                 mesh=None):
        from diffusion_pruning_tpu_torch.data import get_dataset
        from diffusion_pruning_tpu_torch.data.loader import DataPipeline
        from diffusion_pruning_tpu_torch.data.tokenizers import (
            build_clip_tokenizer,
            build_mpnet_tokenizer,
        )
        from diffusion_pruning_tpu_torch.parallel.mesh import rank_slice
        self.cfg, self.mpnet = cfg, mpnet
        self.clip_tok = build_clip_tokenizer(args.pretrained_model_name_or_path,
                                             vocab_size=text_encoder.cfg.vocab_size)
        self.mp_tok = build_mpnet_tokenizer(args.prompt_encoder_model_name_or_path,
                                            vocab_size=mpnet.cfg.vocab_size)
        # capped at the model's position table (the tiny MPNet has 64)
        self.mp_len = min(MPNET_MAX_LEN, mpnet.cfg.max_positions)
        loader_cfg = cfg.data.dataloader
        splits = get_dataset(cfg.data)
        world = world_size()

        def rows(n):  # this rank's rows of a global batch of n
            return None if mesh is None else rank_slice(mesh, n)

        self.train_pipe = DataPipeline(
            splits["train"], batch, resolution, self.tokenize_clip, self.tokenize_mpnet,
            train=True, center_crop=loader_cfg.get("center_crop", False),
            random_flip=loader_cfg.get("random_flip", True), seed=args.seed,
            max_samples=cfg.data.get("max_train_samples"), rows=rows(batch))
        if not len(self.train_pipe):  # the loop would turn over empty epochs for ever
            raise ValueError(f"the train split fills no batch of {batch}")
        val_batch = loader_cfg.get("validation_batch_size", 16) * world
        self.val_pipe = DataPipeline(
            splits["validation"], val_batch, resolution,
            self.tokenize_clip, self.tokenize_mpnet, train=False, seed=args.seed,
            max_samples=cfg.data.get("max_validation_samples"), rows=rows(val_batch))

    def tokenize_clip(self, caps):
        return np.asarray(self.clip_tok(caps, max_length=77, padding="max_length",
                                        truncation=True, return_tensors="np").input_ids)

    def tokenize_mpnet(self, caps):
        enc = self.mp_tok(caps, padding="max_length", max_length=self.mp_len, truncation=True,
                          return_tensors="np")
        return {"mpnet_input_ids": enc.input_ids, "mpnet_attention_mask": enc.attention_mask}

    @torch.no_grad()  # not inference mode: the step differentiates the hypernet on them
    def embed(self, ids, mask) -> torch.Tensor:
        """Mean-pooled MPNet embeddings (B, D), f32, on the MPNet's device."""
        return sentence_embedding(self.mpnet, ids, mask)

    def _embedded(self, batches):
        for b in batches:
            b["mpnet_embeddings"] = self.embed(b.pop("mpnet_input_ids"),
                                               b.pop("mpnet_attention_mask"))
            yield b

    def train_batches(self, epoch):
        return self._embedded(self.train_pipe.epoch(epoch))

    def val_batches(self):
        return self._embedded(self.val_pipe.epoch(0))


def log_sample_images(loop, data: DatasetBatches, run_dir: str, steps: int) -> None:
    """The loop's image logger: routed samples of `data.prompts` (CFG) and one
    unconditional sample of every codebook row (empty prompt, no CFG) from
    the `embedding_gs` snapshot, written as samples/samples_{step}.png and
    samples/quantizer_samples_{step}.png and logged through the tracker."""
    from PIL import Image

    from diffusion_pruning_tpu_torch.pipelines import PruningPipeline
    from diffusion_pruning_tpu_torch.utils.logging_utils import image_grid

    mods = loop.mods
    prompts = list(data.cfg.data.prompts)
    pipe = PruningPipeline(mods.unet, mods.vae, mods.text_encoder, mods.hypernet, mods.quantizer,
                           mods.schedule, device=loop.device)
    step = loop.global_step
    ids = torch.as_tensor(data.tokenize_clip(prompts))
    neg = torch.as_tensor(data.tokenize_clip([""] * len(prompts)))
    emb = data.embed(*data.tokenize_mpnet(prompts).values())
    images, _, _ = pipe(ids, neg, torch.Generator(device=loop.device).manual_seed(step),
                        hyper_net_input=emb, num_inference_steps=steps)
    n_e = mods.quantizer.n_e
    empty = torch.as_tensor(data.tokenize_clip([""] * n_e))
    q_images = pipe.quantizer_samples(empty, empty,
                                      torch.Generator(device=loop.device).manual_seed(step),
                                      expert_ids=list(range(n_e)), guidance_scale=1.0,
                                      num_inference_steps=steps)
    out = os.path.join(run_dir, "samples")
    os.makedirs(out, exist_ok=True)
    grid = image_grid(images.cpu().numpy())
    q_grid = image_grid(q_images.cpu().numpy())
    Image.fromarray(grid).save(os.path.join(out, f"samples_{step}.png"))
    Image.fromarray(q_grid).save(os.path.join(out, f"quantizer_samples_{step}.png"))
    loop.tracker.log_images({"validation_samples": grid, "quantizer_embedding_samples": q_grid},
                            step)


if __name__ == "__main__":
    main()

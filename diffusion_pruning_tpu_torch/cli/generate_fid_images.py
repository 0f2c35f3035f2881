"""Per-expert FID image generation, on one CUDA card.

  python -m diffusion_pruning_tpu_torch.cli.generate_fid_images \
      --base_config_path configs/img_generation/sd-2-1_coco2014.yaml \
      --pretrained_model_name_or_path /path/to/stable-diffusion-2-1 \
      --pruning_ckpt_dir runs/<stage-1 run> --expert_id 3 \
      [--finetuning_ckpt_dir runs/<stage-2 run>]

The counterpart of the JAX package's `scripts/metrics/generate_fid_images.py`
(the paper's per-expert evaluation):

- the expert's arch vector is `<finetuning_ckpt_dir>/arch_vector.pt`, else
  row `--expert_id` of `quantizer_embeddings.pt` in the newest
  `checkpoint-N/` of `--pruning_ckpt_dir`;
- its U-Net is the physically pruned expert of that vector
  (`make_expert_plan`, `build_expert`) holding the stage-2 checkpoint's
  weights (`CheckpointManager(--finetuning_ckpt_dir).restore()["student"]`,
  the f32 masters by name), else the slices of the dense U-Net, in
  `--compute_dtype`;
- the prompts are the validation captions the router assigned to the
  expert (`{dataset_name}_validation_mapped_indices.pt` in
  `--pruning_ckpt_dir`), or synthetic ones where the dataset folder is
  missing, at most `data.max_generated_samples` (`expert_captions`);
- `training.sampler` (default PNDM) for `training.num_inference_steps`
  (default 25) steps, CFG 7.5, `image_generation_batch_size` prompts a batch
  with the last padded by empty prompts, latents from one
  `torch.Generator(device).manual_seed(--seed)` batch after batch;
- uint8 H×W×3 images as `{i:06d}.npy` under
  `<logging_dir>/fid_images_expert_<id>/`, whose path is printed.

Without `<sd_root>/unet` every model is the tiny random one.
`cli/generate_images.py` (the baselines) shares this module's pipeline and
writer. `--device cpu` runs on the CPU; without it there must be a card.
"""
from __future__ import annotations

import os
import sys
from typing import List, Optional

import numpy as np
import torch

SYNTHETIC_PROMPTS = 8


def expert_captions(cfg, pruning_ckpt_dir: Optional[str], expert_id: Optional[int]
                    ) -> List[str]:
    """The validation captions of `expert_id` (all of them when None or
    when the router's assignment file is missing), capped at
    `data.max_generated_samples`. Without the dataset folder: "validation
    prompt {i}" for each assigned row, or 8 of them."""
    from diffusion_pruning_tpu_torch.data import get_dataset
    from diffusion_pruning_tpu_torch.utils.checkpoint import load_torch_artifact

    data_dir = cfg.data.get("data_dir") or ""
    if os.path.exists(data_dir):
        caps = list(get_dataset(cfg.data)["validation"]["caption"])
    else:
        print(f"[smoke] dataset dir {data_dir!r} missing — synthetic captions", file=sys.stderr)
        caps = None
    idx_path = os.path.join(pruning_ckpt_dir or "",
                            f"{cfg.data.dataset_name}_validation_mapped_indices.pt")
    if expert_id is not None and pruning_ckpt_dir and os.path.exists(idx_path):
        assigned = np.asarray(load_torch_artifact(idx_path))
        if caps is None:
            caps = [f"validation prompt {i}" for i in range(len(assigned))]
        caps = [caps[i] for i in np.nonzero(assigned == expert_id)[0]]
    elif caps is None:
        caps = [f"validation prompt {i}" for i in range(SYNTHETIC_PROMPTS)]
    max_n = cfg.data.get("max_generated_samples")
    return caps[:max_n] if max_n else caps


def expert_arch(args) -> np.ndarray:
    """The expert's arch vector: the stage-2 run's `arch_vector.pt`, else row
    `--expert_id` of the stage-1 run's newest `quantizer_embeddings.pt`."""
    from diffusion_pruning_tpu_torch.utils.checkpoint import (
        latest_checkpoint_dir,
        load_torch_artifact,
    )
    if args.finetuning_ckpt_dir:
        arch = load_torch_artifact(os.path.join(args.finetuning_ckpt_dir, "arch_vector.pt"))
    else:
        latest = latest_checkpoint_dir(args.pruning_ckpt_dir)
        arch = load_torch_artifact(os.path.join(latest or args.pruning_ckpt_dir,
                                                "quantizer_embeddings.pt"))[args.expert_id]
    return np.asarray(torch.as_tensor(arch).float()).reshape(-1)


def generation_pipeline(args, cfg, device: torch.device, arch=None, weights_dir=None,
                        pick_arch=None):
    """(pipeline, tokenizer): the dense U-Net, or the expert of `arch` (or of
    `pick_arch(dense U-Net)`), with the VAE and CLIP text encoder in
    `--compute_dtype`, on `training.sampler`. The expert holds the stage-2
    masters of `weights_dir` where given, else the dense slices."""
    from diffusion_pruning_tpu_torch.data.tokenizers import build_clip_tokenizer
    from diffusion_pruning_tpu_torch.models.unet.pruned import make_expert_plan, slice_expert_params
    from diffusion_pruning_tpu_torch.pipelines import PruningPipeline
    from diffusion_pruning_tpu_torch.pipelines.expert_server import build_expert
    from diffusion_pruning_tpu_torch.schedulers import DiffusionSchedule
    from diffusion_pruning_tpu_torch.training.factory import (
        build_text_encoder,
        build_unet,
        build_vae,
        unet_config_from_yaml,
    )
    from diffusion_pruning_tpu_torch.utils.checkpoint import CheckpointManager

    sd_root = args.pretrained_model_name_or_path
    tiny = not os.path.exists(os.path.join(sd_root or "", "unet"))
    dtype = torch.bfloat16 if args.compute_dtype == "bfloat16" else torch.float32
    ucfg = unet_config_from_yaml(cfg, tiny=tiny)
    # f32 first: a baseline's arch is picked from the f32 weights
    unet = build_unet(ucfg, sd_root, device, torch.float32)
    if pick_arch is not None:
        arch = pick_arch(unet)
    unet = unet.to(dtype)
    if arch is not None:
        plan = make_expert_plan(unet.spec, np.asarray(arch).reshape(-1))
        if weights_dir:
            sd = CheckpointManager(weights_dir, create=False).restore()["student"]
        else:
            sd = slice_expert_params(unet.state_dict(), plan)
        unet = build_expert(ucfg, plan, {k: v.to(device, dtype) for k, v in sd.items()})
    vae = build_vae(sd_root, tiny=tiny, device=device, dtype=dtype)
    text = build_text_encoder(sd_root, tiny=tiny, device=device, dtype=dtype)
    pipe = PruningPipeline(unet, vae, text, schedule=DiffusionSchedule(), device=device,
                           sampler=cfg.training.get("sampler", "pndm"))
    return pipe, build_clip_tokenizer(sd_root, vocab_size=text.cfg.vocab_size)


def write_images(pipe, tokenizer, captions: List[str], out_dir: str, batch_size: int,
                 steps: int, seed: int) -> List[str]:
    """Generate `captions` in batches of `batch_size` (the last padded with
    empty prompts) and write each image as `{i:06d}.npy`, uint8 H×W×3;
    returns the paths."""
    def ids(caps):
        return torch.as_tensor(tokenizer(caps, max_length=77, padding="max_length",
                                         truncation=True, return_tensors="np").input_ids)

    os.makedirs(out_dir, exist_ok=True)
    generator = torch.Generator(device=pipe.device).manual_seed(seed)
    neg = ids([""] * batch_size)
    paths = []
    for b in range(0, len(captions), batch_size):
        chunk = list(captions[b:b + batch_size])
        real = len(chunk)
        chunk += [""] * (batch_size - real)
        imgs = pipe.generate_samples(ids(chunk), neg, generator, arch=None,
                                     num_inference_steps=steps)
        imgs = (imgs.cpu().numpy() * 255).astype(np.uint8)
        for j in range(real):
            paths.append(os.path.join(out_dir, f"{b + j:06d}.npy"))
            np.save(paths[-1], imgs[j])
        print(f"{min(b + batch_size, len(captions))}/{len(captions)}", file=sys.stderr)
    return paths


def main(argv=None) -> str:
    """Generate the expert's images; returns their folder."""
    from diffusion_pruning_tpu_torch.utils.arg_utils import parse_args
    from diffusion_pruning_tpu_torch.utils.config import load_config
    from diffusion_pruning_tpu_torch.utils.device import resolve_device

    args = parse_args(argv)
    if args.expert_id is None or not args.pruning_ckpt_dir:
        raise ValueError("--expert_id and --pruning_ckpt_dir are required")
    cfg = load_config(args.base_config_path)
    cfg.update_flat(vars(args))
    device = resolve_device(None if args.device == "cuda" else args.device)
    pipe, tok = generation_pipeline(args, cfg, device, arch=expert_arch(args),
                                    weights_dir=args.finetuning_ckpt_dir)
    caps = expert_captions(cfg, args.pruning_ckpt_dir, args.expert_id)
    out_dir = os.path.join(cfg.training.logging.get("logging_dir", "runs"),
                           f"fid_images_expert_{args.expert_id}")
    write_images(pipe, tok, caps, out_dir,
                 cfg.data.dataloader.get("image_generation_batch_size", 4),
                 cfg.training.get("num_inference_steps", 25), args.seed)
    print(out_dir)
    return out_dir


if __name__ == "__main__":
    main()

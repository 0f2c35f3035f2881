"""Online expert serving: the deployment entry point, on one CUDA card.

  python -m diffusion_pruning_tpu_torch.cli.serve \
      --base_config_path configs/pruning/sd-2-1_coco2014.yaml \
      --pretrained_model_name_or_path /path/to/stable-diffusion-2-1 \
      --prompt_encoder_model_name_or_path /path/to/all-mpnet-base-v2 \
      --pruning_ckpt_dir runs/<stage-1 run> --prompts_file prompts.txt \
      [--finetuning_ckpt_dirs ,,runs/<stage-2 run of expert 2>] --out_dir runs/served

The counterpart of the JAX package's `scripts/other/serve.py`:

- the models from the factory (tiny random ones without `<sd_root>/unet`,
  as every entry point's smoke mode), the router (hypernet and quantizer
  with its `embedding_gs` snapshot) restored from the newest checkpoint of
  `--pruning_ckpt_dir` (a random router without one);
- `--mode experts` or `hybrid`: every codebook row materialised as a
  physically pruned expert (`ExpertServer.from_codebook`, `--compute_dtype`),
  slot e of `--finetuning_ckpt_dirs` holding expert e's stage-2 masters
  (an empty slot: the dense slices), then `ExpertServer.warmup`: on the card
  one CUDA graph of the denoise trajectory per (expert, tier), and under
  `hybrid` per tier of the gated U-Net, which the waves replay
  (`pipelines/aot.py`); `--mode routed`: no experts, the gated U-Net with
  each prompt's arch, eagerly;
- prompts from `--prompts_file` (one a line) or `--n_synthetic` synthetic
  ones, routed by MPNet sentence embeddings tokenized as stage 1 and
  `cli/filter_dataset.py` tokenize them (at min(128, the position table)),
  so serve-time routing equals stage-1 filtering;
- arrival waves of `--arrival_batch` prompts: `ServingQueue.submit`, then
  the previous wave's `flush_async` collected and this wave's started
  (double-buffered: the host routes wave i+1 while the card runs wave i);
  initial latents from one `torch.Generator(device).manual_seed(--seed)`,
  drawn flush after flush;
- each image as `img_{rid:05d}.npy` (uint8) under `--out_dir`; img/s and the
  warm-up's seconds on stderr.

`--aot_dir` and `--warmup_parallel` > 1 raise. A CUDA graph holds this
process's device addresses and cannot be saved, so there is nothing to
persist: a restart keeps only the kernel libraries, cached in
`build/torch_kernels/` by source hash. Capture is host Python under the GIL,
so warm-up threads would have no compile wait to overlap (nvcc already
builds the sources in parallel): the default width is 1.
`--device cpu` runs on the CPU; without it there must be a card.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Serve APTP experts online")
    p.add_argument("--base_config_path", type=str, required=True)
    p.add_argument("--pruning_ckpt_dir", type=str, default=None,
                   help="Stage-1 run (router + codebook).")
    p.add_argument("--finetuning_ckpt_dirs", type=str, default=None,
                   help="Comma-separated per-expert stage-2 runs (index = expert id; an "
                        "empty slot = the dense slices).")
    p.add_argument("--pretrained_model_name_or_path", type=str,
                   default="stabilityai/stable-diffusion-2-1")
    p.add_argument("--prompt_encoder_model_name_or_path", type=str,
                   default="sentence-transformers/all-mpnet-base-v2",
                   help="MPNet folder: the router's input space.")
    p.add_argument("--prompts_file", type=str, default=None,
                   help="One prompt per line; default: synthetic prompts.")
    p.add_argument("--n_synthetic", type=int, default=16)
    p.add_argument("--negative_prompt", type=str, default="")
    p.add_argument("--batch_size", type=int, default=8,
                   help="Largest expert tier (powers of two below it too).")
    p.add_argument("--arrival_batch", type=int, default=8,
                   help="Prompts submitted per request wave.")
    p.add_argument("--num_inference_steps", type=int, default=25)
    p.add_argument("--sampler", type=str, default="ddim", choices=["ddim", "pndm", "dpm++"])
    p.add_argument("--guidance_scale", type=float, default=7.5)
    p.add_argument("--mode", type=str, default="experts",
                   choices=["experts", "hybrid", "routed"],
                   help="hybrid: sub-tier remainders pool into one gated batch; routed: "
                        "no materialised experts, the gated U-Net with per-prompt archs.")
    p.add_argument("--aot_dir", type=str, default=None,
                   help="Persisted programs: raises (a CUDA graph cannot be saved).")
    p.add_argument("--no_warmup", action="store_true")
    p.add_argument("--warmup_parallel", type=int, default=1,
                   help="Warm-up width; > 1 raises (capture is host Python under the "
                        "GIL, with nothing to overlap).")
    p.add_argument("--out_dir", type=str, default="runs/served")
    p.add_argument("--seed", type=int, default=43)
    p.add_argument("--compute_dtype", type=str, default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--jax_cache_dir", type=str, default=".jax_cache",
                   help="Accepted for command-line compatibility; no effect.")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu'.")
    return p.parse_args(argv)


def log(m: str) -> None:
    print(f"# serve: {m}", file=sys.stderr, flush=True)


def check_supported(args) -> None:
    from diffusion_pruning_tpu_torch.pipelines.expert_server import (
        AOT_DIR_REFUSED,
        PARALLEL_REFUSED,
    )
    if args.aot_dir is not None:
        raise NotImplementedError(f"--aot_dir: {AOT_DIR_REFUSED}")
    if args.warmup_parallel > 1:
        raise NotImplementedError(f"--warmup_parallel > 1: {PARALLEL_REFUSED}")


def build_server(args, device: torch.device):
    """(ExpertServer, MPNet encoder): the routed pipeline with the stage-1
    router, and the materialised experts unless `--mode routed`."""
    from diffusion_pruning_tpu_torch.pipelines import PruningPipeline
    from diffusion_pruning_tpu_torch.pipelines.expert_server import ExpertServer
    from diffusion_pruning_tpu_torch.schedulers import DiffusionSchedule
    from diffusion_pruning_tpu_torch.training.factory import (
        build_hypernet,
        build_mpnet,
        build_quantizer,
        build_text_encoder,
        build_unet,
        build_vae,
        unet_config_from_yaml,
    )
    from diffusion_pruning_tpu_torch.utils.checkpoint import CheckpointManager
    from diffusion_pruning_tpu_torch.utils.config import load_config

    cfg = load_config(args.base_config_path)
    sd_root = args.pretrained_model_name_or_path
    tiny = not os.path.exists(os.path.join(sd_root or "", "unet"))
    log(f"building models (tiny={tiny}, dtype={args.compute_dtype})")
    if tiny:
        log(f"[smoke] SD checkpoint {sd_root!r} missing — tiny random models")
    dtype = torch.bfloat16 if args.compute_dtype == "bfloat16" else torch.float32
    ucfg = unet_config_from_yaml(cfg, tiny=tiny)
    unet = build_unet(ucfg, sd_root, device, dtype)
    vae = build_vae(sd_root, tiny=tiny, device=device, dtype=dtype)
    text = build_text_encoder(sd_root, tiny=tiny, device=device, dtype=dtype)
    mpnet = build_mpnet(args.prompt_encoder_model_name_or_path, tiny=tiny, device=device)
    hypernet = build_hypernet(unet.spec, cfg, input_dim=mpnet.cfg.hidden_size, device=device)
    quantizer = build_quantizer(unet.spec, cfg, device=device)
    if args.pruning_ckpt_dir and os.path.exists(args.pruning_ckpt_dir):
        state = CheckpointManager(args.pruning_ckpt_dir, create=False).restore()
        hypernet.load_state_dict(state["hypernet"])
        quantizer.load_state_dict(state["quantizer"])
        log(f"router + codebook restored from {args.pruning_ckpt_dir}")
    else:
        log("[smoke] no pruning checkpoint — random router/codebook")
    pipe = PruningPipeline(unet, vae, text, hypernet, quantizer, DiffusionSchedule(),
                           device=device, sampler=args.sampler)
    if args.mode == "routed":
        # no materialised experts: the routed baseline serves through the
        # gated U-Net alone
        return ExpertServer(pipe, [], [], args.batch_size), mpnet

    expert_weights = None
    if args.finetuning_ckpt_dirs:
        expert_weights = [None] * quantizer.n_e
        for e, d in enumerate(args.finetuning_ckpt_dirs.split(",")):
            d = d.strip()
            if d and os.path.exists(d):
                expert_weights[e] = CheckpointManager(d, create=False).restore()["student"]
                log(f"expert {e}: fine-tuned weights from {d}")
    log("materialising experts")
    server = ExpertServer.from_codebook(pipe, unet.spec, ucfg, expert_weights=expert_weights,
                                        batch_size=args.batch_size, param_dtype=dtype)
    log(f"experts materialised: MACs ratios {[round(r, 3) for r in server.expert_ratios]}")
    return server, mpnet


def read_prompts(args):
    if args.prompts_file and os.path.exists(args.prompts_file):
        with open(args.prompts_file) as f:
            return [ln.strip() for ln in f if ln.strip()]
    return [f"a photo of subject {i} in scene {i % 7}" for i in range(args.n_synthetic)]


def main(argv=None) -> dict:
    """Serve the prompts; returns {"images", "seconds", "img_per_sec",
    "warmup_seconds", "experts" (request id → expert), "macs_ratios"}."""
    from diffusion_pruning_tpu_torch.cli.filter_dataset import caption_embedder
    from diffusion_pruning_tpu_torch.data.tokenizers import (
        build_clip_tokenizer,
        build_mpnet_tokenizer,
    )
    from diffusion_pruning_tpu_torch.models.text_encoders import MPNET_MAX_LEN
    from diffusion_pruning_tpu_torch.pipelines.expert_server import ServingQueue
    from diffusion_pruning_tpu_torch.utils.device import resolve_device

    args = parse_args(argv)
    check_supported(args)
    device = resolve_device(None if args.device == "cuda" else args.device)
    server, mpnet = build_server(args, device)
    pipe = server.base_pipeline

    warmup_s = 0.0
    if not args.no_warmup and args.mode != "routed":
        t0 = time.perf_counter()
        stats = server.warmup(num_inference_steps=args.num_inference_steps,
                              guidance_scale=args.guidance_scale, hybrid=args.mode == "hybrid",
                              parallel=args.warmup_parallel)
        warmup_s = time.perf_counter() - t0
        log(f"warmup {warmup_s:.1f}s (loaded {stats['loaded']}, built {stats['built']})")

    prompts = read_prompts(args)
    ucfg = pipe.unet.cfg
    tok = build_clip_tokenizer(args.pretrained_model_name_or_path, max_length=ucfg.max_text_len,
                               vocab_size=pipe.text_encoder.cfg.vocab_size)

    def ids_of(caps):
        return torch.as_tensor(tok(caps, max_length=ucfg.max_text_len, padding="max_length",
                                   truncation=True, return_tensors="np").input_ids)

    mp_tok = build_mpnet_tokenizer(args.prompt_encoder_model_name_or_path,
                                   vocab_size=mpnet.cfg.vocab_size,
                                   max_length=min(MPNET_MAX_LEN, mpnet.cfg.max_positions))
    route_features = caption_embedder(mpnet, mp_tok)

    queue = ServingQueue(server, num_inference_steps=args.num_inference_steps,
                         guidance_scale=args.guidance_scale, hybrid=args.mode == "hybrid")
    neg = ids_of([args.negative_prompt])
    generator = torch.Generator(device=device).manual_seed(args.seed)
    os.makedirs(args.out_dir, exist_ok=True)

    t0 = time.perf_counter()
    pending, results, experts = None, {}, {}
    for lo in range(0, len(prompts), args.arrival_batch):
        wave = prompts[lo:lo + args.arrival_batch]
        if args.mode == "routed":
            imgs, indices, _ = pipe(ids_of(wave), neg.expand(len(wave), -1), generator,
                                    hyper_net_input=route_features(wave),
                                    num_inference_steps=args.num_inference_steps,
                                    guidance_scale=args.guidance_scale)
            imgs = imgs.cpu()
            for j in range(len(wave)):
                results[lo + j] = imgs[j]
                experts[lo + j] = int(indices[j])
            continue
        queue.submit(ids_of(wave), neg, hyper_net_input=route_features(wave))
        if pending is not None:
            results.update(pending.result())
        pending = queue.flush_async(generator)
    if pending is not None:
        results.update(pending.result())
    dt = time.perf_counter() - t0
    experts = experts or dict(queue.routes)
    log(f"{len(results)} images in {dt:.1f}s ({len(results) / dt:.2f} img/s)")

    for rid in sorted(results):
        np.save(os.path.join(args.out_dir, f"img_{rid:05d}.npy"),
                (results[rid].float().numpy() * 255).astype(np.uint8))
    log(f"wrote {len(results)} .npy images to {args.out_dir}")
    return {"images": len(results), "seconds": dt, "img_per_sec": len(results) / dt,
            "warmup_seconds": warmup_s, "experts": experts,
            "macs_ratios": list(server.expert_ratios)}


if __name__ == "__main__":
    main()

"""The whole APTP workflow replayed through the port's entry points and the
files they hand on.

The port's counterpart of the JAX package's `scripts/other/replay_chain.py`:
every arrow below is a subprocess (`python -m
diffusion_pruning_tpu_torch.cli.<name>`) that reads the files the one before
it wrote, as a user would run the chain:

  prune ──checkpoint-{N}/ (state/, quantizer_embeddings.pt, hypernet/,
     │     quantizer/, unet/ exports)
     ▼
  filter_dataset ──{dataset}_{split}_mapped_indices.pt
     ▼
  finetune × K experts ──per-expert checkpoints + arch_vector.pt
     ▼
  generate_fid_images × K ──.npy image folders     save_captions × K
     ▼                                                 │
  fid / clip_score / cmmd ◄── resize_and_save_images (the reference set)
     ▼
  REPLAY_RESULTS.json + a markdown table

It makes its own fixtures: a tiny COCO-2014 folder of real JPEGs, a tiny
local CLIP folder (config.json, model.safetensors in Hugging Face names and
the BPE files, written without `transformers`), and a TorchScript stand-in
of the InceptionV3 contract. With the default empty
`--pretrained_model_name_or_path` every model is the tiny random one; with a
folder holding `unet/` (random SD-2.1-width weights, say) the chain's YAMLs
take the SD-2.1 U-Net's blocks, gate width and depth order, which the card
needs (its attention kernels take a head size of 64 only), and a codebook
that starts at `quantizer_base` 0, which prunes within the chain's few steps. The metric values
of random weights are no statement of quality: the chain shows that every
file, file name and flag of the workflow round-trips.

  python -m diffusion_pruning_tpu_torch.cli.replay_chain --workspace build/replay \\
      --experts 2 --steps 4 --ft_steps 2 --infer_steps 2 --device cpu

Besides the JAX chain's flags: `--device` (for `--platform`), the two model
folders above (passed to every link that builds models), and `--out_json`,
the results file, by default `REPLAY_RESULTS.json` in the workspace. The
workspace defaults to `build/replay` in this checkout (ignored by git), so
two checkouts never resume each other's links.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
PACKAGE = "diffusion_pruning_tpu_torch.cli"

TOPICS = [
    ("red car", "driving on a sunny road"),
    ("small dog", "playing in the green park"),
    ("old boat", "sailing near the rocky coast"),
    ("tall tower", "standing over the night city"),
    ("fresh bread", "cooling on a wooden table"),
    ("blue bird", "sitting on a snowy branch"),
    ("fast train", "crossing the steel bridge"),
    ("warm soup", "served in a clay bowl"),
]

# the tiny CLIP folder's widths (the JAX chain's CLIPConfig)
CLIP_TEXT = {"hidden_size": 32, "num_hidden_layers": 2, "num_attention_heads": 2,
             "intermediate_size": 64, "max_position_embeddings": 77}
CLIP_VISION = {"hidden_size": 32, "num_hidden_layers": 2, "num_attention_heads": 2,
               "intermediate_size": 64, "image_size": 32, "patch_size": 8}
CLIP_PROJECTION = 16

# the U-Net blocks, GEGLU gate width, depth order and codebook start of the
# chain's YAMLs: the tiny U-Net's (the JAX chain's), and at SD-2.1 width
# configs/pruning/sd-2-1_coco2014.yaml's with `quantizer_base` 0, so that the
# few steps' codebook prunes as a trained router's does and each expert
# fine-tunes (and writes) at its kept widths, not the dense U-Net's
TINY_UNET = {"down": ["CrossAttnDownBlock2DHalfGated", "DownBlock2DHalfGated"],
             "up": ["UpBlock2DHalfGated", "CrossAttnUpBlock2DHalfGated"],
             "ff_gate_width": 4, "depth_order": [-1, -2, 0, 1, -3, 2], "quantizer_base": 3}
SD21_UNET = {"down": ["CrossAttnDownBlock2DHalfGated"] * 3 + ["DownBlock2DHalfGated"],
             "up": ["UpBlock2DHalfGated"] + ["CrossAttnUpBlock2DHalfGated"] * 3,
             "ff_gate_width": 32,
             "depth_order": [-1, -2, 0, 1, -3, -4, 2, 3, -5, -6, 4, 5, -7, 6],
             "quantizer_base": 0}


def log(msg):
    print(f"[replay] {msg}", file=sys.stderr, flush=True)


def make_tiny_coco(root, n_train_imgs=64, caps_per_img=4, n_val_imgs=16, val_caps_per_img=4,
                   resolution=64, seed=0):
    """COCO-2014's layout (images/{split}2014/COCO_{split}2014_*.jpg and
    annotations/captions_{split}2014.json) with topic-clustered captions, so
    that the router's assignment is not degenerate."""
    import numpy as np
    from PIL import Image
    rng = np.random.RandomState(seed)
    for split, n_imgs, cpi in (("train", n_train_imgs, caps_per_img),
                               ("val", n_val_imgs, val_caps_per_img)):
        img_dir = os.path.join(root, "images", f"{split}2014")
        os.makedirs(img_dir, exist_ok=True)
        os.makedirs(os.path.join(root, "annotations"), exist_ok=True)
        annotations = []
        for i in range(n_imgs):
            base = rng.randint(0, 200, 3)
            arr = (base[None, None, :]
                   + rng.randint(0, 56, (resolution, resolution, 3))).astype(np.uint8)
            Image.fromarray(arr).save(os.path.join(img_dir, f"COCO_{split}2014_{i:012d}.jpg"))
            for c in range(cpi):
                subj, rest = TOPICS[(i * cpi + c) % len(TOPICS)]
                annotations.append({"image_id": i,
                                    "caption": f"a photo of a {subj} {rest} number {i * cpi + c}"})
        with open(os.path.join(root, "annotations", f"captions_{split}2014.json"), "w") as f:
            json.dump({"annotations": annotations}, f)
    log(f"tiny COCO dataset at {root}")


def make_tiny_clip(d, seed=0):
    """A tiny local CLIP folder as `CLIPModel.save_pretrained` and
    `CLIPTokenizer.save_pretrained` lay it out: config.json,
    model.safetensors by Hugging Face name (text and vision towers, both
    projections, the logit scale), vocab.json (the specials and the letters,
    no merges), merges.txt and the tokenizer's JSON files; the weights random
    from `seed` (`utils/init_utils.random_init_`). `metrics/towers.py` reads
    it."""
    import string

    import torch
    from safetensors.torch import save_file

    from diffusion_pruning_tpu_torch.models.clip_vision import CLIPVisionConfig, CLIPVisionEncoder
    from diffusion_pruning_tpu_torch.models.text_encoders import CLIPTextConfig, CLIPTextEncoder
    from diffusion_pruning_tpu_torch.utils.init_utils import random_init_

    os.makedirs(d, exist_ok=True)
    vocab = {"<|startoftext|>": 0, "<|endoftext|>": 1}
    for i, ch in enumerate(string.ascii_lowercase):
        vocab[ch + "</w>"] = 2 + i
        vocab[ch] = 2 + 26 + i
    with open(os.path.join(d, "vocab.json"), "w") as f:
        json.dump(vocab, f)
    with open(os.path.join(d, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n")
    specials = {"bos_token": "<|startoftext|>", "eos_token": "<|endoftext|>",
                "unk_token": "<|endoftext|>", "pad_token": "<|endoftext|>"}
    with open(os.path.join(d, "special_tokens_map.json"), "w") as f:
        json.dump(specials, f)
    with open(os.path.join(d, "tokenizer_config.json"), "w") as f:
        json.dump({"model_max_length": 77, "tokenizer_class": "CLIPTokenizer", **specials}, f)
    act = "quick_gelu"  # CLIPConfig's default
    tcfg = CLIPTextConfig(vocab_size=len(vocab), hidden_size=CLIP_TEXT["hidden_size"],
                          num_layers=CLIP_TEXT["num_hidden_layers"],
                          num_heads=CLIP_TEXT["num_attention_heads"],
                          intermediate_size=CLIP_TEXT["intermediate_size"], hidden_act=act)
    vcfg = CLIPVisionConfig(hidden_size=CLIP_VISION["hidden_size"],
                            num_layers=CLIP_VISION["num_hidden_layers"],
                            num_heads=CLIP_VISION["num_attention_heads"],
                            intermediate_size=CLIP_VISION["intermediate_size"],
                            image_size=CLIP_VISION["image_size"],
                            patch_size=CLIP_VISION["patch_size"],
                            projection_dim=CLIP_PROJECTION, hidden_act=act)
    gen = torch.Generator().manual_seed(seed)
    sd = {}
    for module in (CLIPTextEncoder(tcfg), CLIPVisionEncoder(vcfg)):
        sd.update(random_init_(module, gen).state_dict())
    width = CLIP_TEXT["hidden_size"]
    sd["text_projection.weight"] = (torch.randn((CLIP_PROJECTION, width), generator=gen)
                                    / math.sqrt(width))
    sd["logit_scale"] = torch.tensor(math.log(1 / 0.07))
    save_file({k: v.float().contiguous() for k, v in sd.items()},
              os.path.join(d, "model.safetensors"))
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump({"model_type": "clip", "architectures": ["CLIPModel"],
                   "projection_dim": CLIP_PROJECTION,
                   "text_config": {"vocab_size": len(vocab), "hidden_act": act, **CLIP_TEXT},
                   "vision_config": {"hidden_act": act, **CLIP_VISION}}, f)
    log(f"tiny CLIP folder at {d}")


def make_stub_inception(path):
    """A stand-in for `cli/fid.py`'s `--inception` TorchScript contract
    (NCHW float → (N, D)): each channel's mean and maximum."""
    import torch

    class Stub(torch.nn.Module):
        def forward(self, x):
            return torch.cat([x.mean(dim=(2, 3)), x.amax(dim=(2, 3))], dim=1)

    torch.jit.script(Stub()).save(path)
    log(f"stub inception at {path}")


PRUNE_YAML = """\
model:
  unet:
    pretrained_model_name_or_path: /nonexistent
    input_perturbation: 0.0
    resolution: 64
    noise_offset: 0.0
    prediction_type: v_prediction
    max_scheduler_steps: null
    unet_down_blocks: {down}
    unet_mid_block: UNetMidBlock2DCrossAttnWidthGated
    unet_up_blocks: {up}
    gated_ff: true
    ff_gate_width: {ff_gate_width}
  hypernet: {{weight_norm: false, linear_bias: true, single_arch_param: false}}
  quantizer:
    quantizer_T: 0.4
    quantizer_base: {quantizer_base}
    num_arch_vq_codebook_embeddings: {experts}
    arch_vq_beta: 0.25
    depth_order: {depth_order}
    non_zero_width: true
    resource_aware_normalization: false
    optimal_transport: true
data:
  dataset_name: coco
  data_dir: {data_dir}
  year: 2014
  max_train_samples: null
  max_validation_samples: null
  max_generated_samples: 8
  dataloader:
    train_batch_size: {batch}
    validation_batch_size: {batch}
    image_generation_batch_size: 4
    center_crop: false
    random_flip: true
training:
  max_train_steps: {steps}
  hypernet_pretraining_steps: {pretrain}
  validation_steps: 1000
  image_logging_steps: 100000
  num_inference_steps: {infer_steps}
  losses:
    diffusion_loss: {{snr_gamma: 5.0, weight: 1.0}}
    resource_loss: {{type: log, weight: 2.0, pruning_target: 0.6}}
    contrastive_loss: {{arch_vector_temperature: 0.03, prompt_embedding_temperature: 0.03, weight: 100.0}}
    distillation_loss: {{weight: 0.2}}
    block_loss: {{weight: 0.2}}
    std_loss: {{weight: 0.1}}
    max_loss: {{weight: 0.1}}
  optim:
    hypernet_learning_rate: {router_lr}
    quantizer_learning_rate: {router_lr}
    unet_learning_rate: 5e-5
    scale_lr: false
    lr_scheduler: constant_with_warmup
    lr_warmup_steps: 2
  logging:
    logging_dir: {runs}
    report_to: jsonl
    checkpoints_total_limit: 1
    resume_from_checkpoint: null
"""

FINETUNE_YAML = """\
model:
  unet:
    pretrained_model_name_or_path: /nonexistent
    input_perturbation: 0.0
    resolution: 64
    noise_offset: 0.0
    prediction_type: v_prediction
    max_scheduler_steps: null
    unet_down_blocks: {down}
    unet_mid_block: UNetMidBlock2DCrossAttnWidthGated
    unet_up_blocks: {up}
    gated_ff: true
    ff_gate_width: {ff_gate_width}
  hypernet: {{weight_norm: false, linear_bias: true, single_arch_param: false}}
  quantizer:
    quantizer_T: 0.4
    quantizer_base: {quantizer_base}
    num_arch_vq_codebook_embeddings: {experts}
    depth_order: {depth_order}
    non_zero_width: true
    resource_aware_normalization: false
    optimal_transport: true
data:
  dataset_name: coco
  data_dir: {data_dir}
  year: 2014
  max_train_samples: null
  max_validation_samples: null
  max_generated_samples: 8
  dataloader:
    train_batch_size: {batch}
    validation_batch_size: {batch}
    image_generation_batch_size: 4
    center_crop: false
    random_flip: true
training:
  max_train_steps: {steps}
  validation_steps: 1000
  image_logging_steps: 100000
  num_inference_steps: {infer_steps}
  gradient_checkpointing: false
  losses:
    diffusion_loss: {{snr_gamma: 5.0, weight: 1.0}}
    resource_loss: {{type: log, weight: 2.0, pruning_target: 0.6}}
    distillation_loss: {{weight: 0.2}}
    block_loss: {{weight: 0.2}}
  optim:
    unet_learning_rate: 1e-5
    scale_lr: false
    lr_scheduler: constant_with_warmup
    lr_warmup_steps: 2
  logging:
    logging_dir: {runs}
    report_to: jsonl
    checkpoints_total_limit: 1
    resume_from_checkpoint: null
"""


def unet_layout(sd_root: str) -> dict:
    """The YAMLs' U-Net layout: SD-2.1's where `sd_root` holds `unet/` (the
    entry points then build the full-width models), else the tiny one's."""
    return SD21_UNET if os.path.isdir(os.path.join(sd_root or "", "unet")) else TINY_UNET


def write_yamls(ws, args, data_dir, runs):
    """(the prune YAML's path, the finetune YAML's path) in the workspace."""
    layout = unet_layout(args.pretrained_model_name_or_path)
    common = dict(experts=args.experts, data_dir=data_dir, runs=runs, batch=args.batch,
                  infer_steps=args.infer_steps, down=json.dumps(layout["down"]),
                  up=json.dumps(layout["up"]), ff_gate_width=layout["ff_gate_width"],
                  depth_order=json.dumps(layout["depth_order"]),
                  quantizer_base=layout["quantizer_base"])
    prune_cfg = os.path.join(ws, "replay_prune.yaml")
    with open(prune_cfg, "w") as f:
        f.write(PRUNE_YAML.format(steps=args.steps, pretrain=max(args.steps // 3, 1),
                                  router_lr=args.router_lr, **common))
    ft_cfg = os.path.join(ws, "replay_finetune.yaml")
    with open(ft_cfg, "w") as f:
        f.write(FINETUNE_YAML.format(steps=args.ft_steps, **common))
    return prune_cfg, ft_cfg


def leg_done(tag, *paths):
    """A leg whose output files already exist is skipped, so a chain that
    failed resumes from the failed leg (`--fresh` reruns everything)."""
    if paths and all(os.path.exists(p) for p in paths):
        log(f"{tag}: artifacts exist — skipping (resume)")
        return True
    return False


def run_cli(name, args, tag, capture=None):
    """One chain link: `python -m diffusion_pruning_tpu_torch.cli.<name>` in
    a subprocess from the repo root; raises with its output if it fails."""
    cmd = [sys.executable, "-m", f"{PACKAGE}.{name}"] + args
    log(f"$ {' '.join(cmd)}")
    t0 = time.time()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True)
    dt = time.time() - t0
    if capture is not None:
        capture.append({"step": tag, "cmd": cmd, "seconds": round(dt, 1)})
    if proc.returncode != 0:
        sys.stderr.write(proc.stdout[-4000:] + "\n" + proc.stderr[-8000:])
        raise RuntimeError(f"{tag} failed (rc={proc.returncode})")
    log(f"{tag}: ok in {dt:.1f}s")
    return proc.stdout


def results_table(results) -> str:
    """The markdown table of the per-expert results and the chain's total."""
    def fmt(v, spec):
        return format(v, spec) if isinstance(v, float) else "—"

    lines = ["", "| expert | train | val | finetuned | imgs | FID(stub) | CLIP(tiny) "
                 "| CMMD(tiny) |", "|---|---|---|---|---|---|---|---|"]
    for e in range(results["experts"]):
        r = results["per_expert"][e]
        lines.append(f"| {e} | {r['train_prompts']} | {r['val_prompts']} "
                     f"| {'yes' if 'finetune_run' in r else 'no'} "
                     f"| {r.get('images', '—')} "
                     f"| {fmt(r.get('fid_stub'), '.2f')} "
                     f"| {fmt(r.get('clip_score_tiny'), '.2f')} "
                     f"| {fmt(r.get('cmmd_tiny'), '.3f')} |")
    return "\n".join(lines)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workspace", default=os.path.join(ROOT, "build", "replay"),
                   help="fixtures, runs and results; a link whose files exist here is "
                        "skipped (default: build/replay in this checkout)")
    p.add_argument("--experts", type=int, default=8)
    p.add_argument("--steps", type=int, default=10, help="stage-1 train steps")
    p.add_argument("--ft_steps", type=int, default=4, help="stage-2 steps per expert")
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--router_lr", default="2e-4",
                   help="hypernet/quantizer LR; at full width pass ~4e-3 (the convergence-run "
                        "recipe) so Sinkhorn balancing spreads codebook assignment within a "
                        "short schedule")
    p.add_argument("--infer_steps", type=int, default=3)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="every link's --device ('cuda' needs a card)")
    p.add_argument("--pretrained_model_name_or_path", default="",
                   help="SD folder for every link (empty: the tiny random models)")
    p.add_argument("--prompt_encoder_model_name_or_path", default="",
                   help="MPNet folder for every link (empty: the tiny random one)")
    p.add_argument("--fresh", action="store_true", help="wipe the workspace first")
    p.add_argument("--out_json", default=None,
                   help="the results file (default: REPLAY_RESULTS.json in the workspace)")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Run the chain; returns the results written to `--out_json`."""
    import numpy as np

    from diffusion_pruning_tpu_torch.utils.checkpoint import load_torch_artifact

    args = parse_args(argv)
    ws = os.path.abspath(args.workspace)
    if args.fresh and os.path.isdir(ws):
        shutil.rmtree(ws)
    runs = os.path.join(ws, "runs")
    os.makedirs(runs, exist_ok=True)
    out_json = os.path.abspath(args.out_json or os.path.join(ws, "REPLAY_RESULTS.json"))
    timings = []
    results = {"device": args.device, "experts": args.experts,
               "steps": {"prune": args.steps, "finetune": args.ft_steps},
               "chain": timings, "per_expert": {}}

    # ---- fixtures (host side) ----
    data_dir = os.path.join(ws, "coco")
    if not os.path.isdir(data_dir):
        make_tiny_coco(data_dir)
    clip_dir = os.path.join(ws, "tiny_clip")
    if not os.path.isdir(clip_dir):
        make_tiny_clip(clip_dir)
    stub_incep = os.path.join(ws, "stub_inception.pt")
    if not os.path.exists(stub_incep):
        make_stub_inception(stub_incep)
    prune_cfg, ft_cfg = write_yamls(ws, args, data_dir, runs)
    models = ["--pretrained_model_name_or_path", args.pretrained_model_name_or_path,
              "--prompt_encoder_model_name_or_path", args.prompt_encoder_model_name_or_path]
    common = models + ["--device", args.device]
    device = ["--device", args.device]

    # ---- 1. stage-1 prune ----
    prune_run = os.path.join(runs, "replay_prune", "s1")
    prune_artifacts = ("quantizer_embeddings.pt", "state",
                       "hypernet/diffusion_pytorch_model.safetensors",
                       "quantizer/diffusion_pytorch_model.safetensors",
                       "unet/diffusion_pytorch_model.safetensors")

    def latest_ckpt():
        if not os.path.isdir(prune_run):
            return None
        cs = sorted((d for d in os.listdir(prune_run) if d.startswith("checkpoint-")),
                    key=lambda d: int(d.split("-")[1]))
        return os.path.join(prune_run, cs[-1]) if cs else None

    ck = latest_ckpt()
    if not (ck and leg_done("prune", *(os.path.join(ck, a) for a in prune_artifacts))):
        run_cli("prune", ["--base_config_path", prune_cfg, "--wandb_run_name", "s1"] + common,
                "prune", timings)
    ck = latest_ckpt()
    assert ck, f"prune wrote no checkpoint under {prune_run}"
    for artifact in prune_artifacts:
        assert os.path.exists(os.path.join(ck, artifact)), artifact
    results["prune_run"] = prune_run
    log(f"stage-1 checkpoint: {ck}")

    # ---- 2. the router's assignment ----
    if not leg_done("filter_dataset",
                    os.path.join(prune_run, "coco_train_mapped_indices.pt"),
                    os.path.join(prune_run, "coco_validation_mapped_indices.pt")):
        run_cli("filter_dataset", ["--base_config_path", prune_cfg,
                                   "--pruning_ckpt_dir", prune_run] + common,
                "filter_dataset", timings)
    train_idx = np.asarray(load_torch_artifact(
        os.path.join(prune_run, "coco_train_mapped_indices.pt")))
    val_idx = np.asarray(load_torch_artifact(
        os.path.join(prune_run, "coco_validation_mapped_indices.pt")))
    train_counts = np.bincount(train_idx, minlength=args.experts)
    val_counts = np.bincount(val_idx, minlength=args.experts)
    results["train_counts"] = train_counts.tolist()
    results["val_counts"] = val_counts.tolist()
    log(f"router: train {train_counts.tolist()} val {val_counts.tolist()}")

    # ---- 3-6. per expert: finetune → generate → captions → metrics ----
    ref_npy = os.path.join(ws, "ref_npy")
    if not os.path.isdir(ref_npy):
        run_cli("resize_and_save_images", [os.path.join(data_dir, "images", "val2014"), ref_npy,
                                           "--resolution", "64"], "resize_ref", timings)

    for e in range(args.experts):
        r = {"train_prompts": int(train_counts[e]), "val_prompts": int(val_counts[e])}
        results["per_expert"][e] = r
        ft_run = None
        if train_counts[e] >= args.batch:
            ft_run = os.path.join(runs, "replay_finetune", f"ft-expert{e}")
            if not leg_done(f"finetune[{e}]", os.path.join(ft_run, "arch_vector.pt")):
                run_cli("finetune", ["--base_config_path", ft_cfg, "--pruning_ckpt_dir",
                                     prune_run, "--wandb_run_name", "ft",
                                     "--expert_id", str(e)] + common,
                        f"finetune[{e}]", timings)
            assert os.path.isdir(ft_run), ft_run
            assert os.path.exists(os.path.join(ft_run, "arch_vector.pt"))
            ft_ckpts = [d for d in os.listdir(ft_run) if d.startswith("checkpoint-")]
            assert ft_ckpts, f"finetune[{e}] wrote no checkpoint"
            assert os.path.exists(os.path.join(ft_run, sorted(ft_ckpts)[-1], "arch_vector.pt"))
            r["finetune_run"] = ft_run
        else:
            log(f"expert {e}: {train_counts[e]} train prompts < batch {args.batch} — "
                "generating from sliced dense weights")
        if val_counts[e] == 0:
            log(f"expert {e}: no validation prompts routed — skipping metrics")
            continue

        gen_dir = os.path.join(runs, f"fid_images_expert_{e}")
        if not (os.path.isdir(gen_dir) and any(f.endswith(".npy") for f in os.listdir(gen_dir))
                and leg_done(f"generate[{e}]", gen_dir)):
            gen_args = ["--base_config_path", prune_cfg, "--pruning_ckpt_dir", prune_run,
                        "--expert_id", str(e), "--seed", str(100 + e)] + common
            if ft_run:
                gen_args += ["--finetuning_ckpt_dir", ft_run]
            run_cli("generate_fid_images", gen_args, f"generate[{e}]", timings)
        n_imgs = len([f for f in os.listdir(gen_dir) if f.endswith(".npy")])
        assert n_imgs > 0
        r["images"] = n_imgs

        caps_json = os.path.join(ws, f"captions_expert_{e}.json")
        if not leg_done(f"captions[{e}]", caps_json):
            run_cli("save_captions", ["--base_config_path", prune_cfg, "--pruning_ckpt_dir",
                                      prune_run, "--expert_id", str(e), "--out", caps_json],
                    f"captions[{e}]", timings)
        with open(caps_json) as f:
            caps = json.load(f)[:n_imgs]
        with open(caps_json, "w") as f:
            json.dump(caps, f)

        if n_imgs >= 2:
            out = run_cli("fid", [gen_dir, "--ref_stats", ref_npy, "--inception", stub_incep]
                          + device, f"fid[{e}]", timings)
            r["fid_stub"] = float(out.strip().split("FID:")[1])
        else:
            # Fréchet statistics need >= 2 samples; CLIP-score and CMMD stay
            # defined at N = 1
            log(f"expert {e}: only {n_imgs} image — FID undefined, skipping")
            r["fid_stub"] = None
        out = run_cli("clip_score", [gen_dir, "--captions", caps_json, "--clip_model", clip_dir]
                      + device, f"clip_score[{e}]", timings)
        r["clip_score_tiny"] = float(out.strip().split("CLIP-score:")[1])
        out = run_cli("cmmd", [gen_dir, ref_npy, "--clip_model", clip_dir] + device,
                      f"cmmd[{e}]", timings)
        r["cmmd_tiny"] = float(out.strip().split("CMMD:")[1])

    # ---- results ----
    results["total_seconds"] = round(sum(t["seconds"] for t in timings), 1)
    os.makedirs(os.path.dirname(out_json), exist_ok=True)
    with open(out_json, "w") as f:
        json.dump(results, f, indent=2)
    print(results_table(results))
    print(f"\nchain total: {results['total_seconds']}s over {len(timings)} CLI invocations "
          f"→ {out_json}")
    return results


if __name__ == "__main__":
    main()

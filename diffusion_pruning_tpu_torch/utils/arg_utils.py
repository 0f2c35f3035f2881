"""Command-line flags of the port's entry points.

The JAX package's flags and defaults (`utils/arg_utils.py`), so one command
line runs either entry point, plus `--device`: the port's counterpart of
`JAX_PLATFORMS` (the CUDA card by default; an entry point raises when there
is none unless it is given `--device cpu`).
"""
from __future__ import annotations

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Prompt-adaptive pruning of SD-2.1 (PyTorch, CUDA)")
    p.add_argument("--pretrained_model_name_or_path", type=str,
                   default="stabilityai/stable-diffusion-2-1",
                   help="Local path of the base SD model checkpoint (diffusers layout).")
    p.add_argument("--clip_model_name_or_path", type=str,
                   default="laion/CLIP-ViT-H-14-laion2B-s32B-b79K")
    p.add_argument("--prompt_encoder_model_name_or_path", type=str,
                   default="sentence-transformers/all-mpnet-base-v2")
    p.add_argument("--base_config_path", type=str, required=True,
                   help="Path to the model/data/training YAML config.")
    p.add_argument("--cache_dir", type=str, default=None)
    p.add_argument("--pruning_ckpt_dir", type=str, default=None,
                   help="Saved pruning checkpoint dir (stage-2 input).")
    p.add_argument("--finetuning_ckpt_dir", type=str, default=None,
                   help="Saved finetuning checkpoint dir (image generation input).")
    p.add_argument("--expert_id", type=int, default=None,
                   help="Codebook row to materialise/fine-tune.")
    p.add_argument("--pruning_type", type=str, default=None,
                   choices=[None, "no-pruning", "magnitude", "random", "structural",
                            "single-arch"],
                   help="Baseline fine-tuning variant.")
    p.add_argument("--revision", type=str, default=None)
    p.add_argument("--non_ema_revision", type=str, default=None)
    p.add_argument("--use_ema", action="store_true")
    p.add_argument("--wandb_run_name", type=str, default=None)
    p.add_argument("--seed", type=int, default=43)
    p.add_argument("--mesh_shape", type=str, default=None,
                   help="data-parallel size; only 1 (one device) is supported yet.")
    p.add_argument("--compute_dtype", type=str, default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--jax_cache_dir", type=str, default=".jax_cache",
                   help="Accepted for command-line compatibility with the JAX entry "
                        "points; it has no effect here.")
    p.add_argument("--device", type=str, default="cuda",
                   help="Torch device: 'cuda' (default; raises without a card) or 'cpu'.")
    return p.parse_args(argv)

"""Run-directory model card.

The port's copy of the JAX package's `utils/model_card.py`. The original code
uploads a model card to the Hub with the fine-tuned expert; here the same
card is written into the run directory (README.md), so a checkpoint stays
self-describing. Nothing is uploaded.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence


def write_model_card(run_dir: str, base_model: str, dataset_name: str,
                     expert_id: Optional[int] = None, macs_ratio: Optional[float] = None,
                     prompts: Optional[Sequence[str]] = None,
                     extra: Optional[dict] = None) -> str:
    """Write `run_dir`/README.md; returns its path."""
    lines = [
        "---",
        "license: creativeml-openrail-m",
        f"base_model: {base_model}",
        "tags:",
        "- stable-diffusion",
        "- text-to-image",
        "- aptp",
        "- pytorch",
        "- cuda",
        "inference: true",
        "---",
        "",
        f"# APTP expert{'' if expert_id is None else f' {expert_id}'}"
        f" — pruned from {base_model}",
        "",
        f"Trained with diffusion_pruning_tpu_torch on **{dataset_name}**.",
    ]
    if macs_ratio is not None:
        lines.append(f"\nMACs ratio vs the dense U-Net: **{macs_ratio:.3f}**.")
    if prompts:
        lines.append("\nExample routed prompts:\n")
        lines += [f"* {p}" for p in prompts[:8]]
    if extra:
        lines.append("\n## Training info\n")
        lines += [f"* {k}: {v}" for k, v in extra.items()]
    path = os.path.join(run_dir, "README.md")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path

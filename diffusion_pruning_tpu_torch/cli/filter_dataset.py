"""Router assignment entry point: a stage-1 checkpoint and a dataset → each
caption's expert, written as `{dataset_name}_{split}_mapped_indices.pt`, on
one CUDA card.

  python -m diffusion_pruning_tpu_torch.cli.filter_dataset \
      --base_config_path configs/pruning/sd-2-1_coco2014.yaml \
      --pretrained_model_name_or_path /path/to/stable-diffusion-2-1 \
      --prompt_encoder_model_name_or_path /path/to/all-mpnet-base-v2 \
      --pruning_ckpt_dir runs/sd-2-1_coco2014/<run>

The counterpart of the JAX package's `scripts/aptp/filter_dataset.py`: the
hypernet and the quantizer (with its `embedding_gs` snapshot) restored from
the newest checkpoint under `--pruning_ckpt_dir`, every caption of each
split embedded by MPNet (mean-pooled, tokenized as the prune entry point
tokenizes them) 2048 at a time, routed by cosine similarity against the
snapshot (the quantizer's fixed eval noise, no Sinkhorn), and the indices
(int64) written into `--pruning_ckpt_dir` with the count per expert printed.
Without a dataset folder it routes the JAX script's synthetic captions.
`--device cpu` runs on the CPU; without it there must be a card.
"""
from __future__ import annotations

import os
import sys
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

EMBED_BATCH = 2048


def load_router(args, cfg, device: torch.device):
    """(mpnet, hypernet, quantizer) with the stage-1 checkpoint's hypernet and
    quantizer state."""
    from diffusion_pruning_tpu_torch.training.factory import (
        build_hypernet,
        build_mpnet,
        build_quantizer,
        unet_config_from_yaml,
    )
    from diffusion_pruning_tpu_torch.core.structure import build_structure
    from diffusion_pruning_tpu_torch.utils.checkpoint import CheckpointManager

    tiny = not os.path.exists(os.path.join(args.pretrained_model_name_or_path or "", "unet"))
    spec = build_structure(unet_config_from_yaml(cfg, tiny=tiny))
    mpnet = build_mpnet(args.prompt_encoder_model_name_or_path, tiny=tiny, device=device)
    hypernet = build_hypernet(spec, cfg, input_dim=mpnet.cfg.hidden_size, device=device)
    quantizer = build_quantizer(spec, cfg, device=device)
    state = CheckpointManager(args.pruning_ckpt_dir).restore()
    hypernet.load_state_dict(state["hypernet"])
    quantizer.load_state_dict(state["quantizer"])
    return mpnet, hypernet, quantizer


def caption_embedder(mpnet, tokenizer) -> Callable[[List[str]], torch.Tensor]:
    """captions → mean-pooled MPNet embeddings (B, D) on the MPNet's device,
    tokenized at min(128, the position table) as the prune entry point does."""
    from diffusion_pruning_tpu_torch.models.text_encoders import (
        MPNET_MAX_LEN,
        sentence_embedding,
    )
    length = min(MPNET_MAX_LEN, mpnet.cfg.max_positions)

    @torch.inference_mode()
    def embed(caps):
        enc = tokenizer(caps, padding="max_length", max_length=length, truncation=True,
                        return_tensors="np")
        return sentence_embedding(mpnet, enc["input_ids"], enc["attention_mask"])

    return embed


def route_captions(captions: Sequence[str], embed, hypernet, quantizer,
                   noise: Optional[torch.Tensor] = None) -> np.ndarray:
    """Each caption's expert (int64): the cosine argmax of its hypernet gates
    against the codebook snapshot, `EMBED_BATCH` captions at a time. `noise`
    is the quantizer's (B, vq_dim) gumbel noise of a single batch (default:
    its fixed eval noise)."""
    from diffusion_pruning_tpu_torch.data.loader import filter_dataset

    @torch.inference_mode()
    def route(emb):
        return quantizer.cosine_indices(hypernet(emb.float()), noise).cpu().numpy()

    return filter_dataset(list(captions), embed, route, batch_size=EMBED_BATCH).astype(np.int64)


def synthetic_captions() -> Dict[str, Dict[str, List[str]]]:
    """The JAX script's captions where there is no dataset folder."""
    return {s: {"caption": [f"{s} prompt number {i} about topic {i % 7}" for i in range(64)]}
            for s in ("train", "validation")}


def main(argv=None) -> Dict[str, np.ndarray]:
    """Route every caption of each split; returns {split: indices}."""
    from diffusion_pruning_tpu_torch.data import get_dataset
    from diffusion_pruning_tpu_torch.data.tokenizers import build_mpnet_tokenizer
    from diffusion_pruning_tpu_torch.utils.arg_utils import parse_args
    from diffusion_pruning_tpu_torch.utils.checkpoint import save_torch_artifact
    from diffusion_pruning_tpu_torch.utils.config import load_config
    from diffusion_pruning_tpu_torch.utils.device import resolve_device

    args = parse_args(argv)
    if not args.pruning_ckpt_dir:
        raise ValueError("--pruning_ckpt_dir is required")
    cfg = load_config(args.base_config_path)
    cfg.update_flat(vars(args))
    device = resolve_device(None if args.device == "cuda" else args.device)
    mpnet, hypernet, quantizer = load_router(args, cfg, device)
    embed = caption_embedder(mpnet, build_mpnet_tokenizer(args.prompt_encoder_model_name_or_path,
                                                          vocab_size=mpnet.cfg.vocab_size))
    data_dir = cfg.data.get("data_dir") or ""
    if os.path.exists(data_dir):
        splits = get_dataset(cfg.data)
    else:
        print(f"[smoke] dataset dir {data_dir!r} missing — synthetic captions", file=sys.stderr)
        splits = synthetic_captions()
    out = {}
    for split, cols in splits.items():
        idx = route_captions(cols["caption"], embed, hypernet, quantizer)
        path = os.path.join(args.pruning_ckpt_dir,
                            f"{cfg.data.dataset_name}_{split}_mapped_indices.pt")
        save_torch_artifact(idx, path)
        counts = np.bincount(idx, minlength=quantizer.n_e)
        print(f"{split}: {len(idx)} prompts → experts {counts.tolist()} → {path}")
        out[split] = idx
    return out


if __name__ == "__main__":
    main()

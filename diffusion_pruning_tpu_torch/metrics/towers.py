"""The CLIP towers of CLIP-score and CMMD, read from a local Hugging Face
CLIP folder, and the embedding loops the metric entry points share.

A folder holds what `CLIPModel.save_pretrained` writes:

  config.json        `text_config`, `vision_config` and `projection_dim`,
                     read with the defaults of the JAX package's
                     `scripts/metrics/clip_score.py` (`main_jax`);
  model.safetensors  (or `pytorch_model.bin`) by state-dict name:
                     `text_model.*`, `vision_model.*`, `visual_projection.
                     weight`, `text_projection.weight`, `logit_scale`; the
                     port's towers carry those names, so they load with
                     `training.factory.load_by_name`;
  vocab.json, merges.txt (+ the tokenizer JSON files), read by the port's
                     own BPE (`data/tokenizers.CLIPTokenizer`).

A CMMD folder may hold the vision tower alone (`CLIPVisionModelWithProjection`).
Nothing is downloaded and `transformers` is not imported.

On the card the vision tower runs in bf16, as the JAX package's accelerator
path runs it, and the text tower in f32; on the CPU both run in f32. Images
are uint8 (H, W, 3) arrays: scaled to [0, 1], resized and normalised by
`models/safety.clip_preprocess`, then embedded; the embeddings come back as
f32 numpy arrays.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional, Sequence

import numpy as np
import torch

from diffusion_pruning_tpu_torch.models.clip_vision import CLIPVisionConfig, CLIPVisionEncoder
from diffusion_pruning_tpu_torch.models.text_encoders import (
    CLIPTextConfig,
    CLIPTextEncoder,
    clip_pooled_text_features,
)

IMAGE_SUFFIXES = (".npy", ".png", ".jpg")


def read_clip_config(folder: str):
    """(CLIPTextConfig, CLIPVisionConfig) of a folder's `config.json`."""
    with open(os.path.join(folder, "config.json")) as f:
        conf = json.load(f)
    t, v = conf.get("text_config") or {}, conf.get("vision_config") or {}
    tcfg = CLIPTextConfig(
        vocab_size=t.get("vocab_size", 49408),
        hidden_size=t.get("hidden_size", 512),
        num_layers=t.get("num_hidden_layers", 12),
        num_heads=t.get("num_attention_heads", 8),
        intermediate_size=t.get("intermediate_size", 2048),
        max_positions=t.get("max_position_embeddings", 77),
        layer_norm_eps=t.get("layer_norm_eps", 1e-5),
        hidden_act=t.get("hidden_act", "quick_gelu"))
    vcfg = CLIPVisionConfig(
        hidden_size=v.get("hidden_size", 768),
        num_layers=v.get("num_hidden_layers", 12),
        num_heads=v.get("num_attention_heads", 12),
        intermediate_size=v.get("intermediate_size", 3072),
        image_size=v.get("image_size", 224),
        patch_size=v.get("patch_size", 32),
        projection_dim=conf.get("projection_dim", 512),
        layer_norm_eps=v.get("layer_norm_eps", 1e-5),
        hidden_act=v.get("hidden_act", "quick_gelu"))
    return tcfg, vcfg


@dataclasses.dataclass
class CLIPTowers:
    """A CLIP folder's towers on one device; `text` and `tokenizer` are None
    for a vision-only load."""
    vision: CLIPVisionEncoder
    text: Optional[CLIPTextEncoder]
    text_projection: Optional[torch.Tensor]   # (D_text, projection_dim), f32
    logit_scale: float
    tokenizer: object
    device: torch.device

    @torch.inference_mode()
    def embed_images(self, images: Sequence[np.ndarray], unit: bool = False) -> np.ndarray:
        """uint8 (H, W, 3) images (equal sizes) → projected image embeddings
        (N, projection_dim), f32; `unit` scales each row to length 1."""
        from diffusion_pruning_tpu_torch.models.safety import clip_preprocess
        x = torch.as_tensor(np.stack([np.asarray(im, np.float32) / 255.0 for im in images]),
                            device=self.device)
        e = self.vision(clip_preprocess(x, self.vision.cfg.image_size))[1].float()
        if unit:
            e = e / torch.linalg.vector_norm(e, dim=-1, keepdim=True)
        return e.cpu().numpy()

    @torch.inference_mode()
    def embed_texts(self, captions: Sequence[str]) -> np.ndarray:
        """Captions → projected text embeddings (N, projection_dim), f32: the
        final-LN state at the EOS position (the argmax of the ids)."""
        ids = self.tokenizer(list(captions), max_length=self.text.cfg.max_positions,
                             padding="max_length", truncation=True,
                             return_tensors="np").input_ids
        ids = torch.as_tensor(ids, device=self.device)
        hidden = self.text(ids)
        return clip_pooled_text_features(hidden.float(), ids,
                                         projection=self.text_projection).cpu().numpy()


def load_clip_towers(folder: str, device: torch.device, text: bool = True,
                     vision_cfg: Optional[CLIPVisionConfig] = None) -> CLIPTowers:
    """The towers of a local CLIP folder on `device`. `vision_cfg` replaces
    the folder's vision config (CMMD's ViT-L/14-336); `text=False` loads the
    vision tower alone and needs no config.json when `vision_cfg` is given."""
    from diffusion_pruning_tpu_torch.data.tokenizers import CLIPTokenizer
    from diffusion_pruning_tpu_torch.training.factory import load_by_name
    from diffusion_pruning_tpu_torch.utils.export import load_torch_state_dict

    tcfg = None
    if text or vision_cfg is None:
        tcfg, read_vcfg = read_clip_config(folder)
        vision_cfg = vision_cfg or read_vcfg
    sd = load_torch_state_dict(folder)
    vision_dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    with torch.device(device):
        vision = CLIPVisionEncoder(vision_cfg)
    load_by_name(vision, sd, folder)
    vision = vision.to(vision_dtype).eval().requires_grad_(False)
    text_enc = projection = tokenizer = None
    if text:
        with torch.device(device):
            text_enc = CLIPTextEncoder(tcfg)
        load_by_name(text_enc, sd, folder)
        text_enc = text_enc.eval().requires_grad_(False)
        projection = sd["text_projection.weight"].float().T.contiguous().to(device)
        tokenizer = CLIPTokenizer(folder)
    scale = float(np.exp(sd["logit_scale"].float().numpy())) if "logit_scale" in sd else 100.0
    return CLIPTowers(vision, text_enc, projection, scale, tokenizer, device)


def image_files(path: str) -> List[str]:
    return sorted(f for f in os.listdir(path) if f.endswith(IMAGE_SUFFIXES))


def load_images(path: str, files: Sequence[str]) -> List[np.ndarray]:
    """uint8 (H, W, 3) arrays of `.npy` files, or of images Pillow reads."""
    out = []
    for f in files:
        fp = os.path.join(path, f)
        if f.endswith(".npy"):
            out.append(np.load(fp))
        else:
            from PIL import Image
            out.append(np.asarray(Image.open(fp).convert("RGB")))
    return out

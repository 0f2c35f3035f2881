"""Safety checker and CLIP feature extractor of the generation pipeline.

  * `clip_preprocess` — the feature extractor's transform: bilinear resize
    to the tower's input size (antialiased when it shrinks, as
    `jax.image.resize` is), then CLIP mean/std normalisation;
  * `SafetyChecker` — cosine screening of CLIP image embeddings against
    concept embeddings with per-concept thresholds, tightened by 0.01 for an
    image that hits a special-care concept (the diffusers
    `StableDiffusionSafetyChecker` logic); flagged images are blacked out.
    `embed_fn` maps preprocessed pixels to embeddings: a
    `models/clip_vision.CLIPVisionEncoder`'s projection (`from_diffusers`;
    a module is registered, so the checker moves with it) or any callable.
"""
from __future__ import annotations

import json
import os
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from diffusion_pruning_tpu_torch.models.clip_vision import CLIPVisionConfig, CLIPVisionEncoder

CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)

# the vision tower's key prefixes in the checkpoints `from_diffusers` reads:
# diffusers nests HF's CLIPVisionModel (itself prefixed `vision_model.`)
_VISION_PREFIXES = ("vision_model.vision_model.", "vision_model.", "clip.vision_model.")


def clip_preprocess(images: torch.Tensor, size: int = 224) -> torch.Tensor:
    """Images (B, H, W, 3) in [0, 1] → CLIP pixel values (B, size, size, 3), f32."""
    x = F.interpolate(images.float().permute(0, 3, 1, 2), size=(size, size), mode="bilinear",
                      antialias=True, align_corners=False).permute(0, 2, 3, 1)
    mean = torch.tensor(CLIP_IMAGE_MEAN, device=x.device)
    std = torch.tensor(CLIP_IMAGE_STD, device=x.device)
    return (x - mean) / std


class _ImageEmbeds(nn.Module):
    """A vision tower's projected embedding alone."""

    def __init__(self, encoder: CLIPVisionEncoder):
        super().__init__()
        self.encoder = encoder

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        return self.encoder(pixels)[1]


def _unit_rows(t: torch.Tensor) -> torch.Tensor:
    return t / torch.linalg.vector_norm(t, dim=-1, keepdim=True)


class SafetyChecker(nn.Module):
    """Screens images; `__call__(images)` → (screened images, flags (B,) bool).

    concept_embeds (C, D) with concept_thresholds (C,), and optional
    special_embeds (S, D) with special_thresholds (S,): an image whose
    embedding's cosine with a special-care concept exceeds that concept's
    threshold has every concept threshold lowered by 0.01."""

    def __init__(self, embed_fn: Callable[[torch.Tensor], torch.Tensor],
                 concept_embeds: torch.Tensor, concept_thresholds: torch.Tensor,
                 image_size: int = 224, special_embeds: Optional[torch.Tensor] = None,
                 special_thresholds: Optional[torch.Tensor] = None):
        super().__init__()
        self.embed_fn = embed_fn
        self.image_size = image_size
        d = concept_embeds.shape[-1]
        for name, t in (("concept_embeds", concept_embeds),
                        ("concept_thresholds", concept_thresholds),
                        ("special_embeds", special_embeds if special_embeds is not None
                         else torch.zeros(0, d)),
                        ("special_thresholds", special_thresholds
                         if special_thresholds is not None else torch.zeros(0))):
            self.register_buffer(name, torch.as_tensor(t, dtype=torch.float32))

    @torch.inference_mode()
    def flags(self, images: torch.Tensor) -> torch.Tensor:
        px = clip_preprocess(images.to(self.concept_embeds.device), self.image_size)
        emb = _unit_rows(self.embed_fn(px).float())
        adjustment = torch.zeros(emb.shape[0], device=emb.device)
        if len(self.special_embeds):
            special_hit = (emb @ _unit_rows(self.special_embeds).T
                           > self.special_thresholds[None, :]).any(dim=-1)
            adjustment = torch.where(special_hit, 0.01, 0.0)
        scores = emb @ _unit_rows(self.concept_embeds).T - (
            self.concept_thresholds[None, :] - adjustment[:, None])
        return (scores > 0).any(dim=-1)

    def forward(self, images: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        f = self.flags(images).to(images.device)
        return torch.where(f[:, None, None, None], torch.zeros_like(images), images), f

    @classmethod
    def from_diffusers(cls, safety_dir: str,
                       dtype: torch.dtype = torch.float32) -> "SafetyChecker":
        """Build from a local diffusers `safety_checker/` folder: its
        `config.json` (`vision_config`, `projection_dim`) and state dict (a
        CLIP ViT-L/14 vision tower, `visual_projection`, the concept and
        special-care embeddings and their thresholds). A checkpoint without
        a visual projection gets a fixed random one (numpy seed 0). On the
        CPU; the pipeline moves it to its device."""
        from diffusion_pruning_tpu_torch.utils.export import load_torch_state_dict

        with open(os.path.join(safety_dir, "config.json")) as f:
            conf = json.load(f)
        v = conf.get("vision_config", {})
        vcfg = CLIPVisionConfig(
            hidden_size=v.get("hidden_size", 1024),
            num_layers=v.get("num_hidden_layers", 24),
            num_heads=v.get("num_attention_heads", 16),
            intermediate_size=v.get("intermediate_size", 4096),
            image_size=v.get("image_size", 224),
            patch_size=v.get("patch_size", 14),
            projection_dim=conf.get("projection_dim", 768),
            hidden_act=v.get("hidden_act", "quick_gelu"),
        )
        sd = load_torch_state_dict(safety_dir)
        prefix = next((p for p in _VISION_PREFIXES
                       if any(k.startswith(p + "embeddings.") for k in sd)), "")
        enc = CLIPVisionEncoder(vcfg)
        want = {}
        for key in enc.state_dict():
            if key == "visual_projection.weight":
                if key in sd:
                    want[key] = sd[key]
                else:
                    rng = np.random.RandomState(0)
                    kernel = rng.randn(vcfg.hidden_size, vcfg.projection_dim).astype(np.float32)
                    want[key] = torch.from_numpy(kernel.T / np.sqrt(vcfg.hidden_size))
            else:
                name = prefix + key[len("vision_model."):]
                if name not in sd:  # HF spells it pre_layrnorm; accept either
                    name = name.replace("pre_layrnorm", "pre_layernorm")
                want[key] = sd[name]
        enc.load_state_dict({k: t.float() for k, t in want.items()})
        enc = enc.to(dtype).eval().requires_grad_(False)
        d = vcfg.projection_dim
        return cls(_ImageEmbeds(enc), sd["concept_embeds"].float(),
                   sd["concept_embeds_weights"].float(), image_size=vcfg.image_size,
                   special_embeds=sd.get("special_care_embeds", torch.zeros(0, d)).float(),
                   special_thresholds=sd.get("special_care_embeds_weights",
                                             torch.zeros(0)).float())

"""CLIP vision tower (ViT) as a plain `nn.Module`: the image embeddings of
the safety checker (and, later, of CLIP-score and CMMD).

NHWC pixels (already CLIP-normalised, `models/safety.clip_preprocess`) →
non-overlapping patches (a stride-p conv, no bias) → class token + learned
positions → pre-LN → pre-LN transformer layers → post-LN of the class token
→ visual projection. Attribute names follow Hugging Face's
`CLIPVisionModelWithProjection` state dict (`vision_model.encoder.layers.0.
self_attn.q_proj`, `vision_model.pre_layrnorm` with HF's spelling,
`visual_projection`), so its checkpoints load without a key map. Attention
is plain torch ops (matmul, softmax, matmul), as the JAX package computes it
with XLA's `dot_product_attention`, not with a kernel of its own.

OpenAI CLIP checkpoints use quick_gelu (x·σ(1.702x)); `hidden_act` names
it, as HF's config does.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from diffusion_pruning_tpu_torch.ops.flash_attention import plain_attention


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    image_size: int = 224
    patch_size: int = 32
    projection_dim: int = 512
    layer_norm_eps: float = 1e-5
    hidden_act: str = "quick_gelu"

    @property
    def num_positions(self) -> int:
        return (self.image_size // self.patch_size) ** 2 + 1

    @classmethod
    def vit_b32(cls) -> "CLIPVisionConfig":
        """openai/clip-vit-base-patch32."""
        return cls()

    @classmethod
    def vit_l14(cls) -> "CLIPVisionConfig":
        """openai/clip-vit-large-patch14 at 224px: the safety checker's tower."""
        return cls(hidden_size=1024, num_layers=24, num_heads=16, intermediate_size=4096,
                   image_size=224, patch_size=14, projection_dim=768)

    @classmethod
    def vit_l14_336(cls) -> "CLIPVisionConfig":
        """openai/clip-vit-large-patch14-336."""
        return dataclasses.replace(cls.vit_l14(), image_size=336)

    @classmethod
    def tiny(cls) -> "CLIPVisionConfig":
        return cls(hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64,
                   image_size=32, patch_size=8, projection_dim=16)


class _Attention(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.q_proj = nn.Linear(d, d)
        self.k_proj = nn.Linear(d, d)
        self.v_proj = nn.Linear(d, d)
        self.out_proj = nn.Linear(d, d)


class _MLP(nn.Module):
    def __init__(self, d: int, inner: int):
        super().__init__()
        self.fc1 = nn.Linear(d, inner)
        self.fc2 = nn.Linear(inner, d)


class _Layer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        d = cfg.hidden_size
        self.layer_norm1 = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.self_attn = _Attention(d)
        self.layer_norm2 = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.mlp = _MLP(d, cfg.intermediate_size)


class _Encoder(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.layers = nn.ModuleList([_Layer(cfg) for _ in range(cfg.num_layers)])


class _Embeddings(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.class_embedding = nn.Parameter(torch.zeros(cfg.hidden_size))
        self.patch_embedding = nn.Conv2d(3, cfg.hidden_size, cfg.patch_size,
                                         stride=cfg.patch_size, bias=False)
        self.position_embedding = nn.Embedding(cfg.num_positions, cfg.hidden_size)


class _VisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        d = cfg.hidden_size
        self.embeddings = _Embeddings(cfg)
        self.pre_layrnorm = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.encoder = _Encoder(cfg)
        self.post_layernorm = nn.LayerNorm(d, eps=cfg.layer_norm_eps)


class CLIPVisionEncoder(nn.Module):
    """forward(pixels (B, H, W, 3)) → (pooled (B, D), projected (B, proj_dim))."""

    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.cfg = cfg
        self.vision_model = _VisionTransformer(cfg)
        self.visual_projection = nn.Linear(cfg.hidden_size, cfg.projection_dim, bias=False)

    def _act(self, x: torch.Tensor) -> torch.Tensor:
        if self.cfg.hidden_act == "quick_gelu":
            return x * torch.sigmoid(1.702 * x)
        return F.gelu(x)

    def forward(self, pixels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg, vm = self.cfg, self.vision_model
        emb = vm.embeddings
        w = emb.patch_embedding.weight
        b = pixels.shape[0]
        patches = emb.patch_embedding(pixels.permute(0, 3, 1, 2).to(w.dtype))  # (B, D, h, w)
        patches = patches.flatten(2).transpose(1, 2)                            # (B, N, D)
        h = torch.cat([emb.class_embedding.to(w.dtype).expand(b, 1, -1), patches], dim=1)
        h = vm.pre_layrnorm(h + emb.position_embedding.weight[: h.shape[1]])
        s, nh = h.shape[1], cfg.num_heads
        hd = cfg.hidden_size // nh
        for layer in vm.encoder.layers:
            x = layer.layer_norm1(h)
            at = layer.self_attn
            o = plain_attention(at.q_proj(x).view(b, s, nh, hd), at.k_proj(x).view(b, s, nh, hd),
                                at.v_proj(x).view(b, s, nh, hd))
            h = h + at.out_proj(o.reshape(b, s, -1))
            x = layer.layer_norm2(h)
            h = h + layer.mlp.fc2(self._act(layer.mlp.fc1(x)))
        pooled = vm.post_layernorm(h[:, 0])
        return pooled, self.visual_projection(pooled)

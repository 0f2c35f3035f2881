"""Frozen text encoders as plain `nn.Module`s: CLIP text (the conditioning of
SD-2.1, and with `clip_pooled_text_features` the text side of CLIP-score)
and MPNet (the router's input, mean-pooled).

Attribute names follow the Hugging Face state dicts (`text_model.encoder.
layers.0.self_attn.q_proj`, `encoder.layer.0.attention.attn.q`, ...), so the
real checkpoints load without a key map. Attention is plain torch ops
(matmul, softmax, matmul).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from diffusion_pruning_tpu_torch.ops.flash_attention import plain_attention


# ---------------------------------------------------------------- CLIP text

@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 1024
    num_layers: int = 23
    num_heads: int = 16
    intermediate_size: int = 4096
    max_positions: int = 77
    layer_norm_eps: float = 1e-5
    # SD-2.1's OpenCLIP text tower uses exact GELU; OpenAI's CLIP checkpoints
    # (the CLIP-score towers) name quick_gelu, x·σ(1.702x), in their config
    hidden_act: str = "gelu"

    @classmethod
    def sd21(cls) -> "CLIPTextConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "CLIPTextConfig":
        return cls(vocab_size=128, hidden_size=32, num_layers=2, num_heads=2,
                   intermediate_size=64)


class _CLIPAttention(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.q_proj = nn.Linear(d, d)
        self.k_proj = nn.Linear(d, d)
        self.v_proj = nn.Linear(d, d)
        self.out_proj = nn.Linear(d, d)


class _CLIPMLP(nn.Module):
    def __init__(self, d: int, inner: int):
        super().__init__()
        self.fc1 = nn.Linear(d, inner)
        self.fc2 = nn.Linear(inner, d)


class _CLIPLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        d = cfg.hidden_size
        self.layer_norm1 = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.self_attn = _CLIPAttention(d)
        self.layer_norm2 = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.mlp = _CLIPMLP(d, cfg.intermediate_size)


class _CLIPEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_positions, cfg.hidden_size)


class _CLIPEncoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layers = nn.ModuleList([_CLIPLayer(cfg) for _ in range(cfg.num_layers)])


class _CLIPTextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.embeddings = _CLIPEmbeddings(cfg)
        self.encoder = _CLIPEncoder(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)


class CLIPTextEncoder(nn.Module):
    """Causal pre-LN transformer with learned positions and exact GELU (or
    the config's `hidden_act`); returns the final-LN hidden states (B, S, D)."""

    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.cfg = cfg
        self.text_model = _CLIPTextTransformer(cfg)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        cfg, tm = self.cfg, self.text_model
        b, s = input_ids.shape
        nh, hd = cfg.num_heads, cfg.hidden_size // cfg.num_heads
        h = tm.embeddings.token_embedding(input_ids) + tm.embeddings.position_embedding.weight[:s]
        causal = torch.full((s, s), float("-inf"), device=h.device).triu(1)
        for layer in tm.encoder.layers:
            x = layer.layer_norm1(h)
            at = layer.self_attn
            o = plain_attention(at.q_proj(x).view(b, s, nh, hd), at.k_proj(x).view(b, s, nh, hd),
                           at.v_proj(x).view(b, s, nh, hd), causal)
            h = h + at.out_proj(o.reshape(b, s, -1))
            x = layer.layer_norm2(h)
            h = h + layer.mlp.fc2(self._act(layer.mlp.fc1(x)))
        return tm.final_layer_norm(h)

    def _act(self, x: torch.Tensor) -> torch.Tensor:
        if self.cfg.hidden_act == "quick_gelu":
            return x * torch.sigmoid(1.702 * x)
        return F.gelu(x)


def clip_pooled_text_features(hidden: torch.Tensor, input_ids: torch.Tensor,
                              projection: Optional[torch.Tensor] = None,
                              eos_token_id: Optional[int] = None) -> torch.Tensor:
    """CLIP's pooled text feature for CLIP-score: the final-LN hidden state
    (B, S, D) at the EOS position (the argmax of the ids, where EOS is the
    largest id as in OpenAI's tokenizers, else the first `eos_token_id`),
    then `projection` (D, proj_dim) when given (the transpose of HF's
    `text_projection.weight`)."""
    ids = input_ids.to(hidden.device)
    if eos_token_id is None:
        idx = torch.argmax(ids, dim=-1)
    else:
        idx = torch.argmax((ids == eos_token_id).to(torch.int32), dim=-1)
    pooled = hidden[torch.arange(hidden.shape[0], device=hidden.device), idx]
    if projection is not None:
        pooled = pooled @ projection.to(pooled.dtype)
    return pooled


# ---------------------------------------------------------------- MPNet

@dataclasses.dataclass(frozen=True)
class MPNetConfig:
    vocab_size: int = 30527
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_positions: int = 514
    relative_attention_num_buckets: int = 32
    layer_norm_eps: float = 1e-12
    pad_token_id: int = 1

    @classmethod
    def base(cls) -> "MPNetConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "MPNetConfig":
        return cls(vocab_size=128, hidden_size=32, num_layers=2, num_heads=2,
                   intermediate_size=64, max_positions=64)


def relative_position_bucket(relative_position: np.ndarray, num_buckets: int = 32,
                             max_distance: int = 128) -> np.ndarray:
    """MPNet/T5 relative position bucketing (bidirectional)."""
    ret = 0
    n = -relative_position
    num_buckets //= 2
    ret += (n < 0).astype(np.int32) * num_buckets
    n = np.abs(n)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    val_if_large = max_exact + (
        np.log(n.astype(np.float32) / max_exact + 1e-9) / np.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    ).astype(np.int32)
    val_if_large = np.minimum(val_if_large, num_buckets - 1)
    ret += np.where(is_small, n, val_if_large)
    return ret


class _MPNetEmbeddings(nn.Module):
    def __init__(self, cfg: MPNetConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = nn.Embedding(cfg.max_positions, cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)


class _MPNetSelfAttention(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.q = nn.Linear(d, d)
        self.k = nn.Linear(d, d)
        self.v = nn.Linear(d, d)
        self.o = nn.Linear(d, d)


class _MPNetAttention(nn.Module):
    def __init__(self, cfg: MPNetConfig):
        super().__init__()
        self.attn = _MPNetSelfAttention(cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)


class _Dense(nn.Module):
    def __init__(self, din: int, dout: int, norm_eps: float = 0.0):
        super().__init__()
        self.dense = nn.Linear(din, dout)
        if norm_eps:
            self.LayerNorm = nn.LayerNorm(dout, eps=norm_eps)


class _MPNetLayer(nn.Module):
    def __init__(self, cfg: MPNetConfig):
        super().__init__()
        self.attention = _MPNetAttention(cfg)
        self.intermediate = _Dense(cfg.hidden_size, cfg.intermediate_size)
        self.output = _Dense(cfg.intermediate_size, cfg.hidden_size, cfg.layer_norm_eps)


class _MPNetEncoderStack(nn.Module):
    def __init__(self, cfg: MPNetConfig):
        super().__init__()
        self.layer = nn.ModuleList([_MPNetLayer(cfg) for _ in range(cfg.num_layers)])
        self.relative_attention_bias = nn.Embedding(cfg.relative_attention_num_buckets,
                                                    cfg.num_heads)


class MPNetEncoder(nn.Module):
    """Post-LN encoder with a shared relative-position attention bias (32
    buckets) and a −1e9 padding-mask bias; returns token states (B, S, D)."""

    def __init__(self, cfg: MPNetConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = _MPNetEmbeddings(cfg)
        self.encoder = _MPNetEncoderStack(cfg)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        b, s = input_ids.shape
        nh, hd = cfg.num_heads, cfg.hidden_size // cfg.num_heads
        emb = self.embeddings
        mask = attention_mask.long()
        positions = torch.cumsum(mask, dim=1) * mask + cfg.pad_token_id
        h = emb.LayerNorm(emb.word_embeddings(input_ids) + emb.position_embeddings(positions))

        rel = np.arange(s)[None, :] - np.arange(s)[:, None]
        buckets = torch.as_tensor(
            relative_position_bucket(rel, cfg.relative_attention_num_buckets),
            dtype=torch.long, device=h.device)
        bias = self.encoder.relative_attention_bias(buckets).permute(2, 0, 1)[None]
        mask_bias = (1.0 - mask[:, None, None, :].float()) * -1e9
        attn_bias = bias.float() + mask_bias

        for layer in self.encoder.layer:
            at = layer.attention.attn
            o = plain_attention(at.q(h).view(b, s, nh, hd), at.k(h).view(b, s, nh, hd),
                           at.v(h).view(b, s, nh, hd), attn_bias)
            h = layer.attention.LayerNorm(h + at.o(o.reshape(b, s, -1)))
            m = layer.output.dense(F.gelu(layer.intermediate.dense(h)))
            h = layer.output.LayerNorm(h + m)
        return h


def mean_pool(token_embeddings: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
    """Masked mean pooling."""
    m = attention_mask[..., None].to(token_embeddings.dtype)
    return (token_embeddings * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1e-9)


MPNET_MAX_LEN = 128  # MPNet's token length for routing (capped at the position table)


def sentence_embedding(mpnet: MPNetEncoder, input_ids, attention_mask) -> torch.Tensor:
    """Mean-pooled MPNet token states (B, D), f32, on the MPNet's device, of
    host or device ids and mask: the routing feature that stage 1's batches
    and the router's assignment share."""
    device = mpnet.embeddings.word_embeddings.weight.device
    ids = torch.as_tensor(input_ids, dtype=torch.long, device=device)
    mask = torch.as_tensor(attention_mask, dtype=torch.long, device=device)
    return mean_pool(mpnet(ids, mask), mask).float()

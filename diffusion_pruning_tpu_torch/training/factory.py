"""Build stage 1's modules from a YAML config (the schema of
`configs/pruning/*.yaml`).

Nothing is downloaded: checkpoints are local diffusers / Hugging Face
folders, read by state-dict name (the port's modules carry those names).
Where a folder is missing the module gets a seeded random init of the
configured shape (`utils/init_utils.random_init_`) and a warning says so:

  <sd_root>/unet/diffusion_pytorch_model.safetensors (+ config.json)
  <sd_root>/vae/..., <sd_root>/text_encoder/model.safetensors
  <mpnet_root>/model.safetensors

Frozen modules (U-Net, VAE, CLIP text) take `dtype`, the caller's
`training.mixed_precision`; the MPNet encoder and the trainables (hypernet,
codebook) stay f32. Each module is built on `device`.
"""
from __future__ import annotations

import logging
import os
from typing import Dict, Optional

import torch
import torch.nn as nn

from diffusion_pruning_tpu_torch.models.hypernet import HyperStructure
from diffusion_pruning_tpu_torch.models.quantizer import StructureQuantizer
from diffusion_pruning_tpu_torch.models.text_encoders import (
    CLIPTextConfig,
    CLIPTextEncoder,
    MPNetConfig,
    MPNetEncoder,
)
from diffusion_pruning_tpu_torch.models.unet.config import UNetConfig
from diffusion_pruning_tpu_torch.models.unet.unet import GatedUNet
from diffusion_pruning_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from diffusion_pruning_tpu_torch.schedulers import DiffusionSchedule
from diffusion_pruning_tpu_torch.utils.export import load_torch_state_dict
from diffusion_pruning_tpu_torch.utils.init_utils import random_init_

logger = logging.getLogger("diffusion_pruning_tpu_torch")

# seeds of the random inits, as the JAX package's PRNG keys 0 (frozen
# modules), 1 (hypernet) and 2 (codebook)
FROZEN_SEED, HYPERNET_SEED, QUANTIZER_SEED = 0, 1, 2


def unet_config_from_yaml(cfg, tiny: bool = False) -> UNetConfig:
    u = cfg.model.unet
    if tiny:
        return UNetConfig.tiny(gated_ff=u.get("gated_ff", True),
                               fused_norm_conv=u.get("fused_norm_conv", False))
    return UNetConfig.sd21(
        resolution=u.get("resolution", 256),
        down_block_types=tuple(u.get("unet_down_blocks")),
        mid_block_type=u.get("unet_mid_block"),
        up_block_types=tuple(u.get("unet_up_blocks")),
        gated_ff=u.get("gated_ff", True),
        ff_gate_width=u.get("ff_gate_width", 32),
        # the original schema's training.gradient_checkpointing: recompute
        # each subblock in the backward pass
        remat=bool(cfg.get_path("training.gradient_checkpointing", False)),
        use_flash_attention=u.get("use_flash_attention", True),
        fused_norm_conv=u.get("fused_norm_conv", False),
    )


def _exists(path: Optional[str]) -> bool:
    return bool(path) and os.path.exists(path)


def _generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device=torch.device(device)).manual_seed(seed)


def _build(cls, cfg, device, dtype) -> nn.Module:
    with torch.device(device):
        module = cls(cfg)
    return module.to(dtype)


@torch.no_grad()
def load_by_name(module: nn.Module, sd: Dict[str, torch.Tensor], source: str,
                 add_prefix: str = "", strip_prefix: str = "") -> nn.Module:
    """Copy `sd`'s tensors into `module` by state-dict name (cast to the
    module's dtype). A position table longer than the module's is cut to its
    length; keys the module lacks (HF's `position_ids`, a pooler) are
    ignored; a key it needs and `sd` lacks raises."""
    if strip_prefix and any(k.startswith(strip_prefix) for k in sd):
        sd = {k[len(strip_prefix):] if k.startswith(strip_prefix) else k: v
              for k, v in sd.items()}
    if add_prefix and not any(k.startswith(add_prefix) for k in sd):
        sd = {add_prefix + k: v for k, v in sd.items()}
    own = module.state_dict()
    missing = sorted(k for k in own if k not in sd)
    if missing:
        raise KeyError(f"{source} lacks {len(missing)} tensors of "
                       f"{type(module).__name__}: {missing[:8]}")
    picked = {}
    for key, want in own.items():
        t = sd[key]
        if t.shape != want.shape and key.endswith("position_embedding.weight"):
            t = t[: want.shape[0]]
        picked[key] = t
    module.load_state_dict(picked)
    ignored = sorted(set(sd) - set(own))
    if ignored:
        logger.info("%s: ignored %d tensors the module lacks (%s)", source, len(ignored),
                    ignored[:4])
    return module


def _frozen(module: nn.Module, sub: str, what: str, device, **load_kw) -> nn.Module:
    if _exists(sub):
        load_by_name(module, load_torch_state_dict(sub), sub, **load_kw)
        logger.info("loaded %s weights from %s", what, sub)
    else:
        logger.warning("%s checkpoint %s missing — random init", what, sub)
        random_init_(module, _generator(device, FROZEN_SEED))
    return module.eval().requires_grad_(False)


def build_unet(ucfg: UNetConfig, sd_root: Optional[str], device="cuda",
               dtype: torch.dtype = torch.float32) -> GatedUNet:
    return _frozen(_build(GatedUNet, ucfg, device, dtype),
                   os.path.join(sd_root or "", "unet"), "U-Net", device)


def build_vae(sd_root: Optional[str], tiny: bool = False, device="cuda",
              dtype: torch.dtype = torch.float32) -> AutoencoderKL:
    vcfg = VAEConfig.tiny() if tiny else VAEConfig.sd()
    return _frozen(_build(AutoencoderKL, vcfg, device, dtype),
                   os.path.join(sd_root or "", "vae"), "VAE", device)


def build_text_encoder(sd_root: Optional[str], tiny: bool = False, device="cuda",
                       dtype: torch.dtype = torch.float32) -> CLIPTextEncoder:
    tcfg = CLIPTextConfig.tiny() if tiny else CLIPTextConfig.sd21()
    return _frozen(_build(CLIPTextEncoder, tcfg, device, dtype),
                   os.path.join(sd_root or "", "text_encoder"), "text encoder", device,
                   add_prefix="text_model.")


def build_mpnet(root: Optional[str], tiny: bool = False, device="cuda") -> MPNetEncoder:
    mcfg = MPNetConfig.tiny() if tiny else MPNetConfig.base()
    return _frozen(_build(MPNetEncoder, mcfg, device, torch.float32), root, "MPNet", device,
                   strip_prefix="mpnet.")


@torch.no_grad()
def build_hypernet(spec, cfg, input_dim: int = 768, device="cuda") -> HyperStructure:
    """Orthogonal heads, zero biases, unit weight-norm gains (or a standard
    normal `arch`), from the hypernet's seed; f32."""
    h = cfg.model.hypernet
    with torch.device(device):
        model = HyperStructure(spec, input_dim=input_dim,
                               weight_norm=h.get("weight_norm", False),
                               linear_bias=h.get("linear_bias", True),
                               single_arch_param=h.get("single_arch_param", False))
    gen = _generator(device, HYPERNET_SEED)
    if model.single_arch_param:
        model.arch.copy_(torch.randn(model.arch.shape, generator=gen, device=gen.device))
    else:
        for fc in model.mh_fc:
            nn.init.orthogonal_(fc.weight, generator=gen)
            if fc.bias is not None:
                fc.bias.zero_()
    return model


def build_quantizer(spec, cfg, device="cuda") -> StructureQuantizer:
    """The codebook with orthogonal rows from the codebook's seed and its
    eval snapshot taken; f32."""
    q = cfg.model.quantizer
    with torch.device(device):
        model = StructureQuantizer(
            spec,
            n_e=q.get("num_arch_vq_codebook_embeddings", 8),
            temperature=q.get("quantizer_T", 0.4),
            base=q.get("quantizer_base", 3),
            depth_order=tuple(q.get("depth_order")) if q.get("depth_order") else None,
            non_zero_width=q.get("non_zero_width", True),
            resource_aware_normalization=q.get("resource_aware_normalization", False),
            optimal_transport=q.get("optimal_transport", True))
    model.init_params(_generator(device, QUANTIZER_SEED))
    model.init_state()
    return model


def build_schedule(cfg) -> DiffusionSchedule:
    return DiffusionSchedule(
        prediction_type=cfg.model.unet.get("prediction_type", "v_prediction"))

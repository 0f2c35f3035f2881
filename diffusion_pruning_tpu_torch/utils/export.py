"""Checkpoint export in the original APTP code's diffusers-style layout, and
the loader of such state dicts.

A pruning checkpoint holds `hypernet/`, `quantizer/` and optionally `unet/`
subfolders, each with a `config.json` (the ConfigMixin kwargs, with
`_class_name`) and a `diffusion_pytorch_model.safetensors` state dict in
f32, the layout the filtering and stage-2 tools load:

  export_hypernet   HyperStructure → its state dict, weight-norm heads through
                    torch's parametrisation keys
                    (`mh_fc.{i}.parametrizations.weight.original{0,1}`) such
                    that g·v/‖v‖ is the effective weight
  export_quantizer  the codebook and its `embedding_gs` snapshot
  export_unet       the gated U-Net's state dict, which already carries the
                    diffusers names

The JAX package's `utils/export.py` writes the same files from its flax
trees.
"""
from __future__ import annotations

import json
import os
from typing import Dict

import torch

_DIFFUSERS_VERSION = "0.23.1"   # the original APTP code's pin
_WEIGHTS_NAME = "diffusion_pytorch_model.safetensors"
_STATE_DICT_NAMES = ("diffusion_pytorch_model.safetensors", "model.safetensors",
                     "diffusion_pytorch_model.bin", "pytorch_model.bin")


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A `.safetensors` or `.bin` state dict from a file or a diffusers / HF
    model folder (the first of the usual file names that exists), on the
    host with its stored dtypes."""
    if os.path.isdir(path):
        for name in _STATE_DICT_NAMES:
            if os.path.exists(os.path.join(path, name)):
                path = os.path.join(path, name)
                break
        else:
            raise FileNotFoundError(f"no state dict file in {path}")
    if path.endswith(".safetensors"):
        from safetensors.torch import load_file
        return load_file(path)
    return torch.load(path, map_location="cpu", weights_only=True)


def _save(out_dir: str, class_name: str, config: dict, sd: Dict[str, torch.Tensor]) -> None:
    os.makedirs(out_dir, exist_ok=True)
    full = {"_class_name": class_name, "_diffusers_version": _DIFFUSERS_VERSION}
    full.update(config)
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(full, f, indent=2)
    from safetensors.torch import save_file
    save_file({k: v.detach().float().contiguous() for k, v in sd.items()},
              os.path.join(out_dir, _WEIGHTS_NAME))


def reference_structure(spec) -> dict:
    """The original code's nested `structure` dict: one width sublist per
    subblock (its sites' widths in order) and one [0]/[1] depth sublist per
    subblock."""
    return {"width": [list(ws) for ws in spec.subblock_widths],
            "depth": [[d] for d in spec.depth_list]}


def export_hypernet(out_dir: str, hypernet) -> None:
    config = {
        "structure": reference_structure(hypernet.spec),
        "input_dim": hypernet.input_dim,
        "wn_flag": bool(hypernet.weight_norm),
        "linear_bias": bool(hypernet.linear_bias),
        "single_arch_param": bool(hypernet.single_arch_param),
    }
    sd: Dict[str, torch.Tensor] = {}
    if hypernet.single_arch_param:
        sd["arch"] = hypernet.arch
    else:
        for i, fc in enumerate(hypernet.mh_fc):
            weight = fc.effective_weight().detach().float()
            if hypernet.weight_norm:
                sd[f"mh_fc.{i}.parametrizations.weight.original0"] = torch.linalg.vector_norm(
                    weight, dim=1, keepdim=True)
                sd[f"mh_fc.{i}.parametrizations.weight.original1"] = weight
            else:
                sd[f"mh_fc.{i}.weight"] = weight
            if hypernet.linear_bias:
                sd[f"mh_fc.{i}.bias"] = fc.bias
    _save(out_dir, "HyperStructure", config, sd)


def export_quantizer(out_dir: str, quantizer) -> None:
    """The codebook `embedding.weight` and the `embedding_gs` snapshot."""
    nd = quantizer.spec.num_depth
    depth_order = (list(quantizer.depth_order) if quantizer.depth_order is not None
                   else list(range(nd)))
    config = {
        "n_e": quantizer.n_e,
        "structure": reference_structure(quantizer.spec),
        "beta": 0.25,
        "remap": None,
        "unknown_index": "random",
        "sane_index_shape": True,
        "temperature": quantizer.temperature,
        "base": quantizer.base,
        "depth_order": depth_order,
        "non_zero_width": bool(quantizer.non_zero_width),
        "sinkhorn_epsilon": 0.05,     # core/sinkhorn.py's defaults, which the step uses
        "sinkhorn_iterations": 3,
        "resource_aware_normalization": bool(quantizer.resource_aware_normalization),
        "optimal_transport": bool(quantizer.optimal_transport),
    }
    _save(out_dir, "StructureVectorQuantizer", config,
          {"embedding.weight": quantizer.embedding.weight,
           "embedding_gs": quantizer.embedding_gs})


def export_unet(out_dir: str, unet) -> None:
    """A GatedUNet as a diffusers-format unet/ folder (config.json carries the
    gated block types)."""
    cfg = unet.cfg
    config = {
        "sample_size": cfg.sample_size,
        "in_channels": cfg.in_channels,
        "out_channels": cfg.out_channels,
        "down_block_types": list(cfg.down_block_types),
        "mid_block_type": cfg.mid_block_type,
        "up_block_types": list(cfg.up_block_types),
        "block_out_channels": list(cfg.block_out_channels),
        "layers_per_block": cfg.layers_per_block,
        "attention_head_dim": list(cfg.attention_head_dim),
        "cross_attention_dim": cfg.cross_attention_dim,
        "norm_num_groups": cfg.norm_num_groups,
        "norm_eps": cfg.norm_eps,
        "use_linear_projection": cfg.use_linear_projection,
        "flip_sin_to_cos": cfg.flip_sin_to_cos,
        "freq_shift": cfg.freq_shift,
        "act_fn": "silu",
        "center_input_sample": False,
        "downsample_padding": 1,
        "mid_block_scale_factor": 1,
        "gated_ff": cfg.gated_ff,
        "ff_gate_width": cfg.ff_gate_width,
    }
    _save(out_dir, "UNet2DConditionModelGated", config, unet.state_dict())


def export_pruning_checkpoint(ckpt_dir: str, hypernet, quantizer, unet=None) -> None:
    """Write the hypernet/, quantizer/ and (with `unet`) unet/ folders into a
    checkpoint directory. The U-Net is frozen in stage 1, so its export
    equals the pretrained weights (in f32)."""
    export_hypernet(os.path.join(ckpt_dir, "hypernet"), hypernet)
    export_quantizer(os.path.join(ckpt_dir, "quantizer"), quantizer)
    if unet is not None:
        export_unet(os.path.join(ckpt_dir, "unet"), unet)

"""The gated conditional U-Net.

The per-prompt architecture is one flat `(B, vq_dim)` tensor `arch` (widths
then depths, in `StructureSpec` order), sliced per subblock by `_GateReader`;
`arch=None` runs the dense model. Public tensors keep the JAX package's
layout — latents and features `(B, H, W, C)` — while the convolutions run
on logical NCHW tensors inside: contiguous by default, converted once to
`torch.channels_last` after `conv_in` under `fused_norms` or
`fused_norm_conv`, whose kernels read that layout (every later op keeps it).
A U-Net whose conv weights are channels_last (`layout` "nhwc": the route
`pipelines/expert_server.build_expert` gives served bf16 CUDA experts) takes
the latents' permuted view into `conv_in` as it is, already channels_last,
and runs its output head's norm on `group_norm_silu` too, so that no
convolution and no norm converts a layout.
Module names follow diffusers' `UNet2DConditionModel` state dict, so a
diffusers checkpoint loads without a key map.

With `plan` (an `ExpertPlan`, `models/unet/pruned.py`) the same class builds
a physically pruned expert: every subblock at its kept widths, and a dropped
subblock left out (a `None` in its block's list, so that the kept modules
keep their diffusers indices and `slice_expert_params` of the dense state
dict gives exactly the expert's keys). An expert runs without an arch.

With `shard` (a `parallel.tp.UNetShard`) it builds one model rank's slice of
a tensor-parallel U-Net, dense or expert: each resnet, attention and
feed-forward at the rank's units of its site (`parallel.tp.shard_unet`
builds it and loads the shard). Its forward takes the same arguments and
returns the same tensors on every rank of the model axis.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from diffusion_pruning_tpu_torch.core.structure import (
    StructureSpec,
    SubBlock,
    build_structure,
    layer_sites,
)
from diffusion_pruning_tpu_torch.models.unet.blocks import (
    Downsample,
    GatedResnetBlock,
    GatedTransformer2D,
    Upsample,
    norm_silu_conv,
)
from diffusion_pruning_tpu_torch.models.unet.config import UNetConfig
from diffusion_pruning_tpu_torch.models.unet.pruned import ExpertPlan
from diffusion_pruning_tpu_torch.ops.gates import match_batch
from diffusion_pruning_tpu_torch.ops.norm_conv import PackedWeight


def timestep_embedding(timesteps: torch.Tensor, dim: int, flip_sin_to_cos: bool = True,
                       freq_shift: float = 0.0, max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal timestep features (diffusers `Timesteps`), [cos, sin]."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(half, dtype=torch.float32,
                                                    device=timesteps.device)
    exponent = exponent / (half - freq_shift)
    emb = timesteps.float()[:, None] * torch.exp(exponent)[None, :]
    sin, cos = torch.sin(emb), torch.cos(emb)
    return torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)


class _GateReader:
    """Slices width/depth gates for a subblock out of the flat arch tensor."""

    def __init__(self, spec: StructureSpec, arch: Optional[torch.Tensor]):
        self.subs = {sb.name: sb for sb in spec.subblocks}
        self.num_width = spec.num_width
        self.arch = arch

    def resnet(self, name: str):
        """(width_gate, depth_gate) for a resnet subblock (or None, None)."""
        sb = self.subs.get(name)
        if sb is None or self.arch is None:
            return None, None
        site = sb.sites[0]
        return self.arch[:, site.start: site.start + site.width], self._depth(sb)

    def transformer(self, name: str):
        """(one (attn1, attn2, ff) gate tuple per stacked layer, depth gate);
        an ungated ff's gate is None."""
        sb = self.subs.get(name)
        if sb is None or self.arch is None:
            return None, None
        gates = tuple(tuple(None if layer.get(kind) is None else
                            self.arch[:, layer[kind].start: layer[kind].start + layer[kind].width]
                            for kind in ("attn1", "attn2", "ff"))
                      for layer in layer_sites(sb.sites))
        return gates, self._depth(sb)

    def _depth(self, sb: SubBlock):
        if sb.depth_index < 0:
            return None
        return self.arch[:, self.num_width + sb.depth_index]


class _TimeEmbedding(nn.Module):
    def __init__(self, in_dim: int, dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, dim)
        self.linear_2 = nn.Linear(dim, dim)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class _Block(nn.Module):
    """A down/up block: resnets, optional attentions, optional resampler; a
    subblock an expert drops is None."""

    def __init__(self, resnets, attentions=None, downsample=None, upsample=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if attentions is not None:
            self.attentions = nn.ModuleList(attentions)
        if downsample is not None:
            self.downsamplers = nn.ModuleList([downsample])
        if upsample is not None:
            self.upsamplers = nn.ModuleList([upsample])


class GatedUNet(nn.Module):
    def __init__(self, cfg: UNetConfig, plan: Optional[ExpertPlan] = None, shard=None):
        super().__init__()
        self.cfg = cfg
        self.plan = plan
        self.shard = shard
        self.spec = build_structure(cfg)
        b0 = cfg.block_out_channels[0]
        temb = cfg.time_embed_dim
        g = cfg.norm_num_groups
        L = cfg.num_levels
        kept = plan.by_name if plan is not None else {}
        split = shard is not None and shard.axis.distributed  # a model axis of one splits nothing

        def resnet(cin, cout, name):
            p = kept.get(name)
            if p is not None and p.dropped:
                return None
            keep = p.sites[0] if p is not None else None
            hidden = keep and keep.kept_channels
            if shard is not None:
                hidden = shard.local_channels(name, "resnet")
            block = GatedResnetBlock(cin, cout, temb, g, cfg.norm_eps, cfg.fused_norms,
                                     cfg.fused_norm_conv, hidden)
            if split:
                block.tp = shard.split(name, "resnet")
            return block

        def transformer(c, heads, name, layers):
            p = kept.get(name)
            if p is not None and p.dropped:
                return None
            active = None
            if p is not None:
                active = [(len(s["attn1"].kept), len(s["attn2"].kept),
                           s["ff"].kept_channels if "ff" in s else None)
                          for s in layer_sites(p.sites)]
            if shard is not None:
                if layers != 1:
                    raise NotImplementedError("a tensor-parallel U-Net shards one transformer "
                                              "layer per Transformer2D")
                active = [(shard.local_units(name, "attn1"), shard.local_units(name, "attn2"),
                           shard.local_channels(name, "ff"))]
            block = GatedTransformer2D(c, heads, cfg.cross_attention_dim, g,
                                       cfg.use_flash_attention, cfg.fused_norms,
                                       cfg.fused_norm_conv, active,
                                       use_linear_projection=cfg.use_linear_projection,
                                       num_layers=layers)
            if split:
                tb = block.transformer_blocks[0]
                tb.attn1.tp, tb.attn2.tp = shard.split(name, "attn1"), shard.split(name, "attn2")
                tb.ff.tp = shard.split(name, "ff")
            return block

        self.conv_in = nn.Conv2d(cfg.in_channels, b0, 3, padding=1)
        self.time_embedding = _TimeEmbedding(b0, temb)
        if cfg.addition_embed_type == "text_time":
            self.add_embedding = _TimeEmbedding(cfg.projection_class_embeddings_input_dim, temb)

        ch = b0
        skips = [b0]
        self.down_blocks = nn.ModuleList()
        for i, block_type in enumerate(cfg.down_block_types):
            out = cfg.block_out_channels[i]
            cross = block_type.startswith("CrossAttn")
            resnets, attns = [], []
            for j in range(cfg.layers_per_block):
                resnets.append(resnet(ch, out, f"down.{i}.resnet.{j}"))
                ch = out
                if cross:
                    attns.append(transformer(out, cfg.heads_at(i), f"down.{i}.attn.{j}",
                                             cfg.transformer_layers_at(i)))
                skips.append(ch)
            down = Downsample(ch) if i < L - 1 else None
            if down is not None:
                skips.append(ch)
            self.down_blocks.append(_Block(resnets, attns if cross else None, downsample=down))

        mid = cfg.block_out_channels[-1]
        self.mid_block = _Block([resnet(mid, mid, "mid.resnet.0"),
                                 resnet(mid, mid, "mid.resnet.1")],
                                [transformer(mid, cfg.heads_at(L - 1), "mid.attn.0",
                                             cfg.transformer_layers_at(L - 1))])

        rev = list(reversed(cfg.block_out_channels))
        self.up_blocks = nn.ModuleList()
        for i, block_type in enumerate(cfg.up_block_types):
            out = rev[i]
            cross = block_type.startswith("CrossAttn")
            resnets, attns = [], []
            for j in range(cfg.layers_per_block + 1):
                resnets.append(resnet(ch + skips.pop(), out, f"up.{i}.resnet.{j}"))
                ch = out
                if cross:
                    attns.append(transformer(out, cfg.heads_at(L - 1 - i), f"up.{i}.attn.{j}",
                                             cfg.transformer_layers_at(L - 1 - i)))
            up = Upsample(ch) if i < L - 1 else None
            self.up_blocks.append(_Block(resnets, attns if cross else None, upsample=up))

        self.conv_norm_out = nn.GroupNorm(g, ch, eps=cfg.norm_eps)
        self.conv_out = nn.Conv2d(ch, cfg.out_channels, 3, padding=1)
        self._packed_out = PackedWeight()

    @property
    def layout(self) -> str:
        """"nhwc" where the conv weights are `torch.channels_last` (then the
        activations keep that layout from `conv_in` to `conv_out`), else
        "nchw"."""
        w = self.conv_in.weight
        nhwc = w.is_contiguous(memory_format=torch.channels_last) and not w.is_contiguous()
        return "nhwc" if nhwc else "nchw"

    def _text_time(self, added_cond, dtype) -> torch.Tensor:
        """`add_embedding`'s input: the pooled text embedding, then the
        sinusoidal features of each of the six time ids, in float32, cast to
        `dtype` (diffusers' "text_time")."""
        if added_cond is None:
            raise ValueError('a "text_time" U-Net takes added_cond=(text_embeds, time_ids)')
        text_embeds, time_ids = added_cond
        cfg = self.cfg
        feats = timestep_embedding(time_ids.reshape(-1), cfg.addition_time_embed_dim,
                                   cfg.flip_sin_to_cos, cfg.freq_shift)
        feats = feats.reshape(time_ids.shape[0], -1)
        return torch.cat([text_embeds.float(), feats], dim=-1).to(dtype)

    def _call(self, block: nn.Module, *args):
        """Run a subblock, recomputed in the backward pass under `remat`."""
        if self.cfg.remat and torch.is_grad_enabled():
            return checkpoint(block, *args, use_reentrant=False)
        return block(*args)

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor,
                encoder_hidden_states: torch.Tensor,
                arch: Optional[torch.Tensor] = None, return_features: bool = False,
                added_cond: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        """sample: (B, H, W, C_in) latents; timesteps: (B,); encoder_hidden_states:
        (B, 77, cross_dim); arch: (B or B/2 under CFG, vq_dim) or None
        (always None for an expert, whose kept widths do not fit the dense
        gate layout); added_cond: a "text_time" U-Net's (text_embeds (B,
        pooled dim), time_ids (B, 6)), diffusers' `added_cond_kwargs`.
        Returns (B, H, W, C_out) in the weights' dtype; with `return_features`
        also the block-distillation features {"d0".., "m", "u0"..}, NHWC: the
        hidden state after each down level, after the mid block and after
        each up level."""
        cfg, spec = self.cfg, self.spec
        dtype = self.conv_in.weight.dtype
        if arch is not None and self.plan is not None:
            raise ValueError("an expert U-Net (built with a plan) runs without an arch: its "
                             "kept widths do not fit the dense gate layout")
        if arch is not None:
            if arch.shape[-1] != spec.vq_dim:
                raise ValueError(
                    f"arch vector has {arch.shape[-1]} logits, structure expects "
                    f"{spec.vq_dim} ({spec.num_width} width + {spec.num_depth} depth)")
            arch = match_batch(arch, sample.shape[0])
        gates = _GateReader(spec, arch)
        features = {}
        call = self._call

        t_emb = timestep_embedding(timesteps, cfg.block_out_channels[0],
                                   cfg.flip_sin_to_cos, cfg.freq_shift).to(dtype)
        temb = self.time_embedding(t_emb)
        if cfg.addition_embed_type == "text_time":
            temb = temb + self.add_embedding(self._text_time(added_cond, dtype))
        ehs = encoder_hidden_states.to(dtype)

        nhwc = self.layout == "nhwc"
        x = sample.to(dtype).permute(0, 3, 1, 2)
        if nhwc:  # the NHWC latents' permuted view has channels_last strides
            h = self.conv_in(x)
        else:
            h = self.conv_in(x.contiguous())
            if cfg.fused_norms or cfg.fused_norm_conv:
                h = h.contiguous(memory_format=torch.channels_last)
        res_stack = [h]
        for i, block in enumerate(self.down_blocks):
            cross = hasattr(block, "attentions")
            for j, res in enumerate(block.resnets):
                if res is not None:
                    wg, dg = gates.resnet(f"down.{i}.resnet.{j}")
                    h = call(res, h, temb, wg, dg)
                if cross and block.attentions[j] is not None:
                    tg, tdg = gates.transformer(f"down.{i}.attn.{j}")
                    h = call(block.attentions[j], h, ehs, tg, tdg)
                res_stack.append(h)
            if hasattr(block, "downsamplers"):
                h = block.downsamplers[0](h)
                res_stack.append(h)
            features[f"d{i}"] = h

        wg, _ = gates.resnet("mid.resnet.0")
        h = call(self.mid_block.resnets[0], h, temb, wg)
        tg, _ = gates.transformer("mid.attn.0")
        h = call(self.mid_block.attentions[0], h, ehs, tg, None)
        wg, _ = gates.resnet("mid.resnet.1")
        h = call(self.mid_block.resnets[1], h, temb, wg)
        features["m"] = h

        for i, block in enumerate(self.up_blocks):
            cross = hasattr(block, "attentions")
            for j, res in enumerate(block.resnets):
                skip = res_stack.pop()  # a dropped resnet's skip is discarded
                if res is not None:
                    identity = h
                    h = torch.cat([h, skip], dim=1)
                    wg, dg = gates.resnet(f"up.{i}.resnet.{j}")
                    h = call(res, h, temb, wg, dg, identity)
                if cross and block.attentions[j] is not None:
                    tg, tdg = gates.transformer(f"up.{i}.attn.{j}")
                    h = call(block.attentions[j], h, ehs, tg, tdg)
            if hasattr(block, "upsamplers"):
                h = block.upsamplers[0](h)
            features[f"u{i}"] = h

        # the output head's norm stays unfused under `fused_norms`, as in the
        # JAX package, except in the NHWC layout, where torch's GroupNorm
        # would make its input contiguous
        out = norm_silu_conv(h, self.conv_norm_out, self.conv_out, None, nhwc,
                             cfg.fused_norm_conv, self._packed_out).permute(0, 2, 3, 1)
        if return_features:
            return out, {name: f.permute(0, 2, 3, 1) for name, f in features.items()}
        return out

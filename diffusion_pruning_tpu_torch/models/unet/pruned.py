"""Physically pruned experts: a hard arch vector → a smaller U-Net.

The port's copy of the JAX package's `models/unet/pruned.py`. An
`ExpertPlan` is derived once, on the host, from a hard architecture vector:
per subblock the kept gate units of each width site and whether its depth
gate dropped it. `GatedUNet(cfg, plan=plan)` builds the expert with the kept
widths only (kept groups of a resnet's hidden channels, kept heads, kept
GEGLU units; a dropped subblock is elided), and `slice_expert_params` gathers
its weights out of the dense U-Net's state dict, so an expert starts from the
dense weights and runs with no masking at all. Each stacked transformer
layer of a `Transformer2D` (SDXL's) is cut at its own kept heads and units.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from diffusion_pruning_tpu_torch.core.structure import StructureSpec, layer_sites


@dataclasses.dataclass(frozen=True)
class SiteKeep:
    kind: str
    kept: Tuple[int, ...]     # kept gate-unit indices (sorted)
    width: int                # original number of units
    channels: int             # original channels covered

    @property
    def unit(self) -> int:
        """Channels a gate unit covers."""
        return self.channels // self.width

    @property
    def kept_channels(self) -> int:
        return len(self.kept) * self.unit


@dataclasses.dataclass(frozen=True)
class SubBlockPlan:
    name: str
    kind: str
    dropped: bool             # depth gate off → identity
    sites: Tuple[SiteKeep, ...]

    def site(self, kind: str) -> Optional[SiteKeep]:
        for s in self.sites:
            if s.kind == kind:
                return s
        return None


@dataclasses.dataclass(frozen=True)
class ExpertPlan:
    subblocks: Tuple[SubBlockPlan, ...]

    def get(self, name: str) -> Optional[SubBlockPlan]:
        for sb in self.subblocks:
            if sb.name == name:
                return sb
        return None

    @property
    def by_name(self) -> Dict[str, SubBlockPlan]:
        return {sb.name: sb for sb in self.subblocks}


def make_expert_plan(spec: StructureSpec, arch_vector) -> ExpertPlan:
    """Hard-threshold an arch vector (vq_dim values) into a static plan: a
    width unit is kept iff its gate >= 0.5, a subblock is dropped iff its
    depth gate < 0.5, and a site with no unit kept keeps unit 0."""
    if torch.is_tensor(arch_vector):
        arch_vector = arch_vector.detach().float().cpu().numpy()
    arch = np.asarray(arch_vector).reshape(-1)
    if arch.shape[0] != spec.vq_dim:
        raise ValueError(f"arch vector has {arch.shape[0]} values, structure expects "
                         f"{spec.vq_dim}")
    plans = []
    for sb in spec.subblocks:
        dropped = sb.depth_index >= 0 and bool(arch[spec.num_width + sb.depth_index] < 0.5)
        sites = []
        for site in sb.sites:
            kept = tuple(int(i) for i in np.nonzero(arch[site.start: site.start + site.width]
                                                    >= 0.5)[0]) or (0,)
            sites.append(SiteKeep(site.kind, kept, site.width, site.channels))
        plans.append(SubBlockPlan(sb.name, sb.kind, dropped, tuple(sites)))
    return ExpertPlan(tuple(plans))


def expert_macs_ratio(spec: StructureSpec, plan: ExpertPlan) -> float:
    """Pruned/dense MACs of the expert."""
    kept = spec.other_macs  # ungated modules always run
    for sb_spec, sb_plan in zip(spec.subblocks, plan.subblocks):
        if sb_plan.dropped:
            continue
        kept += sb_spec.nonprunable_macs + sum(
            site_spec.prunable_macs * len(site_plan.kept) / site_plan.width
            for site_spec, site_plan in zip(sb_spec.sites, sb_plan.sites))
    return kept / spec.total_macs


# ---------------------------------------------------------------------------
# Parameter slicing (dense state dict → expert state dict)
# ---------------------------------------------------------------------------

def module_name(sb_name: str) -> str:
    """The state-dict prefix of a subblock: 'down.0.resnet.1' →
    'down_blocks.0.resnets.1', 'mid.attn.0' → 'mid_block.attentions.0'."""
    parts = sb_name.split(".")
    if parts[0] in ("down", "up"):
        kind = "resnets" if parts[2] == "resnet" else "attentions"
        return f"{parts[0]}_blocks.{parts[1]}.{kind}.{parts[3]}"
    kind = "resnets" if parts[1] == "resnet" else "attentions"
    return f"mid_block.{kind}.{parts[2]}"


def _kept_index(keep: SiteKeep, device) -> torch.Tensor:
    """Indices of the kept channels: every channel of each kept unit."""
    unit = keep.unit
    idx = np.concatenate([np.arange(k * unit, (k + 1) * unit) for k in keep.kept])
    return torch.as_tensor(idx, dtype=torch.long, device=device)


def _subblock_cuts(sb: SubBlockPlan, prefix: str, device
                   ) -> Dict[str, Tuple[int, torch.Tensor]]:
    """{key: (dim, index)} of the tensors of one kept subblock that are cut."""
    if sb.kind == "resnet":
        ch = _kept_index(sb.sites[0], device)
        return {f"{prefix}.conv1.weight": (0, ch), f"{prefix}.conv1.bias": (0, ch),
                f"{prefix}.time_emb_proj.weight": (0, ch),
                f"{prefix}.time_emb_proj.bias": (0, ch),
                f"{prefix}.norm2.weight": (0, ch), f"{prefix}.norm2.bias": (0, ch),
                f"{prefix}.conv2.weight": (1, ch)}
    out = {}
    for k, sites in enumerate(layer_sites(sb.sites)):  # each stacked layer at its own widths
        tb = f"{prefix}.transformer_blocks.{k}"
        for kind in ("attn1", "attn2"):
            ch = _kept_index(sites[kind], device)
            for proj in ("to_q", "to_k", "to_v"):
                out[f"{tb}.{kind}.{proj}.weight"] = (0, ch)
            out[f"{tb}.{kind}.to_out.0.weight"] = (1, ch)
        ff = sites.get("ff")
        if ff is not None:
            ch = _kept_index(ff, device)
            both = torch.cat([ch, ff.channels + ch])  # both GEGLU halves
            out[f"{tb}.ff.net.0.proj.weight"] = (0, both)
            out[f"{tb}.ff.net.0.proj.bias"] = (0, both)
            out[f"{tb}.ff.net.2.weight"] = (1, ch)
    return out


def expert_cuts(plan: ExpertPlan, device=None) -> Dict[str, Tuple[int, torch.Tensor]]:
    """{state-dict key: (dim, kept indices on `device`)} of every dense
    tensor the expert keeps only a slice of: a resnet's conv1 and
    time_emb_proj outputs, norm2 and conv2's inputs; an attention's q/k/v
    outputs and to_out's inputs per kept head; both GEGLU halves and the
    feed-forward's output projection inputs per kept unit, for each stacked
    transformer layer."""
    out = {}
    for sb in plan.subblocks:
        if not sb.dropped:
            out.update(_subblock_cuts(sb, module_name(sb.name), device))
    return out


def slice_expert_params(state_dict: Dict[str, torch.Tensor], plan: ExpertPlan
                        ) -> Dict[str, torch.Tensor]:
    """Gather the kept weight slices out of a dense U-Net state dict (the
    port's diffusers names). A dropped subblock keeps no keys. A cut tensor
    (`expert_cuts`) is a copy (`index_select`); every other entry is the
    dense tensor itself, so an expert loaded with
    `load_state_dict(..., assign=True)` shares those leaves' storage with the
    dense U-Net and must never be written in place. On the NHWC route
    (`pipelines/expert_server.build_expert`, served bf16 CUDA experts) every
    4-D conv weight whose layout changes is copied once more, to
    channels_last: the uncut 3×3 leaves (conv_in, conv_out, the resamplers)
    then stop sharing; a 1×1 shortcut is channels_last as it is and, like
    every leaf of fewer dimensions, still shares. The copies are made
    outside `torch.inference_mode` even when the caller is inside it, so they
    keep the version counter the fused conv's packed-weight cache reads."""
    dropped = tuple(module_name(sb.name) + "." for sb in plan.subblocks if sb.dropped)
    out = {k: v for k, v in state_dict.items() if not k.startswith(dropped)}
    device = state_dict["conv_in.weight"].device
    with torch.inference_mode(False):
        for key, (dim, index) in expert_cuts(plan, device).items():
            out[key] = state_dict[key].index_select(dim, index)
    return out

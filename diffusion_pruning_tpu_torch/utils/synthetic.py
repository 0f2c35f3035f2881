"""Synthetic validation of the APTP mechanism: planted redundancy.

The port's copy of the JAX package's `utils/synthetic.py`. The stage-1
router can be shown to converge without pretrained SD weights, but not on
plain random weights: there every channel is equally important, the dense
point is the optimum of the distillation and block terms, and the codebook
stays at ratio 1.0. Two ingredients give it the redundancy a pretrained
U-Net has:

1. `plant_redundancy` damps a random fraction of the gate units, so pruning
   them costs about eps² of distillation;
2. `PrunerConfig.self_distill_target=True` (and `FineTuneConfig`'s) takes the
   dense teacher's prediction as the diffusion target: a frozen random
   U-Net denoises nothing, and the ε/v target would be gradient noise.

Used by `cli/convergence_run.py` only.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from diffusion_pruning_tpu_torch.core.structure import layer_sites
from diffusion_pruning_tpu_torch.models.unet.pruned import module_name


def _expand_units(units, unit: int) -> np.ndarray:
    return np.concatenate([np.arange(k * unit, (k + 1) * unit) for k in units])


def plant_redundancy(spec, state_dict: Dict[str, torch.Tensor], keep: float = 0.5,
                     eps: float = 0.02, seed: int = 123
                     ) -> Tuple[Dict[str, torch.Tensor], float]:
    """Damp a random `1 - keep` fraction of the gate units of a dense U-Net's
    state dict (diffusers names) by `eps`, where `models/unet/pruned.py`
    slices them:

    - a resnet's hidden groups: its `norm2.weight` slabs (the gate sits
      between conv1 and norm2, whose GroupNorm is scale-invariant per group,
      so its scale is the group's magnitude);
    - an attention head: the rows of its `to_v.weight` (torch's (out, in)
      layout; the flax kernel's columns);
    - a GEGLU unit: the rows of both halves of `ff.net.0.proj.weight`.

    The kept units are `RandomState(seed).rand(num_width) < keep`, and the
    first unit of every site is always kept (the non-zero-width rescue).
    Returns (the damped state dict, the kept fraction of the width units);
    the input is left as it was (the damped tensors are copies, the others
    shared)."""
    rng = np.random.RandomState(seed)
    kept_mask = rng.rand(spec.num_width) < keep
    for sb in spec.subblocks:
        for site in sb.sites:
            kept_mask[site.start] = True
    out = dict(state_dict)

    def damp(key: str, rows: np.ndarray) -> None:
        t = out[key]
        if t is state_dict[key]:
            t = out[key] = t.clone()
        idx = torch.as_tensor(rows, dtype=torch.long, device=t.device)
        t[idx] = t[idx] * eps

    with torch.no_grad():
        for sb in spec.subblocks:
            prefix = module_name(sb.name)
            for k, site in ((k, site) for k, layer in enumerate(layer_sites(sb.sites))
                            for site in layer.values()):
                dropped = np.nonzero(~kept_mask[site.start: site.start + site.width])[0]
                if len(dropped) == 0:
                    continue
                ch = _expand_units(dropped, site.channels // site.width)
                if sb.kind == "resnet":
                    damp(f"{prefix}.norm2.weight", ch)
                    continue
                tb = f"{prefix}.transformer_blocks.{k}"
                if site.kind in ("attn1", "attn2"):
                    damp(f"{tb}.{site.kind}.to_v.weight", ch)
                elif site.kind == "ff":
                    damp(f"{tb}.ff.net.0.proj.weight", np.concatenate([ch, site.channels + ch]))
    return out, float(kept_mask.mean())

"""Weights and codebooks from the seed, identical for the program and the
reference.

`seeded_init_` fills a module's parameters from one normal draw on the
generator's device, laid out over the leaves in the order of their names:
norm scales 1, biases and other 1-D leaves 0, every other leaf a normal
scaled by 1/sqrt(fan-in) (an embedding table's fan-in is its row count), the
convention of the program's own `utils/init_utils.random_init_`. Two modules
with the same state-dict names and shapes get the same values, whatever
their classes, so the reference rebuilds the program's weights from the seed
instead of reading them.
"""
from __future__ import annotations

import math
import zlib
from typing import List, Optional, Tuple

import torch
import torch.nn as nn

_NORMS = (nn.LayerNorm, nn.GroupNorm)


def module_seed(seed: int, tag: str) -> int:
    """The seed of one module of a run (63 bits)."""
    return (int(seed) * 1_000_003 + zlib.crc32(tag.encode())) % (2 ** 63 - 1)


def leaves(module: nn.Module) -> List[Tuple[str, nn.Parameter, str, int]]:
    """(name, parameter, kind, fan-in) in name order; kind is 'ones',
    'zeros' or 'normal'."""
    out = []
    for mod_name, mod in module.named_modules():
        for name, p in mod.named_parameters(recurse=False):
            full = f"{mod_name}.{name}" if mod_name else name
            if isinstance(mod, _NORMS) and name == "weight":
                out.append((full, p, "ones", 0))
            elif p.dim() <= 1:
                out.append((full, p, "zeros", 0))
            else:
                fan = p.shape[0] if isinstance(mod, nn.Embedding) else p[0].numel()
                out.append((full, p, "normal", max(fan, 1)))
    return sorted(out, key=lambda leaf: leaf[0])


@torch.no_grad()
def seeded_init_(module: nn.Module, seed: int, device=None,
                 round_to: Optional[torch.dtype] = None) -> nn.Module:
    """Overwrite every parameter of `module` (already on `device`) from one
    float32 normal draw of `torch.Generator(device).manual_seed(seed)`.
    `round_to`: round the values through that dtype first (the reference,
    in float32, takes the values the program serves in bfloat16)."""
    ls = leaves(module)
    if device is None:
        device = ls[0][1].device
    total = sum(p.numel() for _, p, kind, _ in ls if kind == "normal")
    gen = torch.Generator(device=device).manual_seed(int(seed))
    draw = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    off = 0
    for _, p, kind, fan in ls:
        if kind == "ones":
            p.fill_(1.0)
        elif kind == "zeros":
            p.zero_()
        else:
            n = p.numel()
            v = draw[off:off + n].view(p.shape) / math.sqrt(fan)
            off += n
            p.copy_(v if round_to is None else v.to(round_to))
    del draw
    return module


def expert_codes(layout, num_experts: int, rule: dict) -> torch.Tensor:
    """The hard codes (K, vq_dim) of a configuration's codebook rule: every
    width unit kept with probability `keep`, the first unit of each site
    always; every odd-numbered code closes `depth_closed_min` to
    `depth_closed_max` depth gates; all from `torch.Generator().manual_seed
    (seed)` on the CPU. `layout` is the reference's `gate_layout`."""
    gen = torch.Generator().manual_seed(int(rule["seed"]))
    nw, nd = layout.num_width, layout.num_depth
    codes = (torch.rand(num_experts, layout.vq_dim, generator=gen) < rule["keep"]).float()
    for sb in layout.subblocks:
        for site in sb.sites:
            codes[:, site.start] = 1.0
    codes[:, nw:] = 1.0
    lo, hi = rule["depth_closed_min"], rule["depth_closed_max"]
    for e in range(1, num_experts, 2):
        n = int(torch.randint(lo, hi + 1, (1,), generator=gen))
        codes[e, nw + torch.randperm(nd, generator=gen)[:n]] = 0.0
    return codes


def codebook_snapshot(codes: torch.Tensor) -> torch.Tensor:
    """The quantizer's `embedding_gs` snapshot of hard codes: 0.8 where a
    code keeps a unit, 0.2 where it drops it."""
    return torch.where(codes >= 0.5, 0.8, 0.2)


def steering_noise(codes: torch.Tensor, experts: torch.Tensor, num_width: int,
                   depth_order) -> torch.Tensor:
    """Routing noise (N, vq_dim) that sends row i to expert experts[i]:
    ±1e3 saturates every gate to that expert's hard code. The depth samples
    are ranked: depth slot depth_order[i] takes the i-th sample."""
    noise = 1e3 * (2 * codes[experts] - 1)
    nd = codes.shape[1] - num_width
    order = depth_order if depth_order is not None else range(nd)
    noise[:, num_width:] = noise[:, num_width + torch.as_tensor([i % nd for i in order])]
    return noise

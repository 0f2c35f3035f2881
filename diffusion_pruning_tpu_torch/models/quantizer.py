"""StructureQuantizer: the K-expert architecture codebook and its router.

Training (`forward_train`): the codebook rows go through a gumbel-sigmoid
(differentiable in `embedding.weight`), prompts are assigned to them by
Sinkhorn optimal transport over the batch, and the assigned rows z_q carry
the gradient back into the codebook. Eval (`forward_eval`): each prompt goes
to the code of highest cosine similarity against the frozen gumbel-sigmoid
snapshot of the codebook (`embedding_gs`), which is then binarised.

Gumbel noise is an explicit argument everywhere. At eval it defaults to
`torch.Generator().manual_seed(0)` — the original APTP code's fixed-seed
semantics; the JAX package draws it from `jax.random.PRNGKey(0)` instead, and
the two give different bits, so the tests hand the JAX noise to the port. In
training the caller passes it (the train step draws it from its generator).

Options, as in the JAX package: `non_zero_width` (reopen the first unit of a
width group whose gates all close; default on), `optimal_transport`
(Sinkhorn assignment in training; off: the argmax of the cosine scores),
`resource_aware_normalization` (scale the normalised similarity vectors by
the prunable-MACs template of `core.resource.ResourceModel`). Sinkhorn runs
with the JAX package's defaults (epsilon 0.05, 3 iterations).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from diffusion_pruning_tpu_torch.core.estimators import (
    fixed_generator,
    hard_concrete,
    importance_gumbel_sigmoid,
    sample_gumbel,
)
from diffusion_pruning_tpu_torch.core.resource import ResourceModel
from diffusion_pruning_tpu_torch.core.sinkhorn import sinkhorn_assign
from diffusion_pruning_tpu_torch.core.structure import StructureSpec


class StructureQuantizer(nn.Module):
    """State dict: `embedding.weight` (K, vq_dim) codebook logits and the
    `embedding_gs` buffer, the snapshot eval routing compares against."""

    def __init__(self, spec: StructureSpec, n_e: int = 8, temperature: float = 0.4,
                 base: float = 2.0, depth_order: Optional[Tuple[int, ...]] = None,
                 non_zero_width: bool = True, resource_aware_normalization: bool = False,
                 optimal_transport: bool = True):
        super().__init__()
        self.spec = spec
        self.n_e = n_e
        self.temperature = temperature
        self.base = base
        self.depth_order = depth_order
        self.non_zero_width = non_zero_width
        self.resource_aware_normalization = resource_aware_normalization
        self.optimal_transport = optimal_transport
        self.embedding = nn.Embedding(n_e, spec.vq_dim)
        self.register_buffer("embedding_gs", torch.zeros(n_e, spec.vq_dim))
        gids, first, template, soft_mask, depth_col = self._tables()
        for name, t in (("_group_ids", gids), ("_group_first", first),
                        ("_norm_template", template), ("_soft_mask", soft_mask),
                        ("_depth_col", depth_col), ("_depth_perm", self._perm())):
            self.register_buffer(name, torch.as_tensor(t), persistent=False)
        self.register_buffer("_macs_template", torch.as_tensor(
            ResourceModel(spec).prunable_macs_template()) if resource_aware_normalization
            else None, persistent=False)

    def _perm(self) -> np.ndarray:
        """Gather index: depth slot depth_order[i] takes the i-th ranked sample."""
        nd = self.spec.num_depth
        order = self.depth_order if self.depth_order is not None else tuple(range(nd))
        order = [i % nd for i in order]
        inv = np.empty(nd, dtype=np.int64)
        inv[np.asarray(order, dtype=np.int64)] = np.arange(nd)
        return inv

    def _tables(self):
        spec = self.spec
        gids = np.zeros(spec.num_width, dtype=np.int64)
        first = np.zeros(spec.num_width, dtype=np.float32)
        template = np.ones(spec.vq_dim, dtype=np.float32)
        soft_mask = np.zeros(spec.vq_dim, dtype=np.float32)
        depth_col = np.zeros(spec.vq_dim, dtype=np.int64)
        g = 0
        for sb in spec.subblocks:
            for site in sb.sites:
                sl = slice(site.start, site.start + site.width)
                gids[sl] = g
                first[site.start] = 1.0
                template[sl] = 1.0 / np.sqrt(site.width)
                g += 1
            if sb.depth_index >= 0:
                lo = sb.sites[0].start
                hi = sb.sites[-1].start + sb.sites[-1].width
                soft_mask[lo:hi] = 1.0
                depth_col[lo:hi] = spec.num_width + sb.depth_index
        return gids, first, template, soft_mask, depth_col

    def gumbel_sigmoid_trick(self, z: torch.Tensor,
                             noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Logits → soft gates. noise: (B, vq_dim) gumbel noise (width columns
        then depth columns); default from the fixed generator."""
        spec = self.spec
        z = z.float()
        if noise is None:
            noise = sample_gumbel(z.shape, fixed_generator())
        noise = noise.to(device=z.device, dtype=z.dtype)
        nw = spec.num_width
        zw, zd = z[:, :nw], z[:, nw:]
        yw = torch.sigmoid((zw + noise[:, :nw] + self.base) / self.temperature)
        if self.non_zero_width:
            # a width group whose gates all close gets its first unit reopened
            alive = torch.zeros(yw.shape[0], len(spec.width_list), device=z.device,
                                dtype=z.dtype)
            alive.index_add_(1, self._group_ids, hard_concrete(yw))
            dead = (alive == 0).to(yw.dtype)
            yw = yw + 0.5 * dead[:, self._group_ids] * self._group_first[None, :]
        if spec.num_depth > 0:
            yd = importance_gumbel_sigmoid(zd, noise[:, nw:], self.temperature, self.base)
            return torch.cat([yw, yd[:, self._depth_perm]], dim=1)
        return yw

    def width_depth_normalize(self, x: torch.Tensor) -> torch.Tensor:
        """Hard-concrete everywhere except the width slabs of depth-gated
        subblocks, which become soft width·depth products; then scale width
        slots by 1/√group_size (and, with `resource_aware_normalization`,
        every slot by its prunable MACs)."""
        out = hard_concrete(x)
        sm = self._soft_mask
        out = out * (1.0 - sm) + x * x[:, self._depth_col] * sm
        out = out * self._norm_template
        if self._macs_template is not None:
            out = out * self._macs_template
        return out

    def _scores(self, gates: torch.Tensor, codes_gs: torch.Tensor) -> torch.Tensor:
        u = self.width_depth_normalize(gates)
        u = u / torch.linalg.norm(u, dim=-1, keepdim=True)
        v = self.width_depth_normalize(codes_gs)
        v = v / torch.linalg.norm(v, dim=-1, keepdim=True)
        return u @ v.T

    def cosine_indices(self, z: torch.Tensor,
                       noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Argmax cosine similarity of the gated logits against the snapshot."""
        gates = self.gumbel_sigmoid_trick(z, noise)
        return torch.argmax(self._scores(gates, self.embedding_gs.float()), dim=-1)

    @torch.no_grad()
    def init_params(self, generator: Optional[torch.Generator] = None) -> None:
        """Orthogonal codebook rows (K < vq_dim), as the JAX package inits it."""
        nn.init.orthogonal_(self.embedding.weight, generator=generator)

    def codebook_gates(self, noise: Optional[torch.Tensor] = None,
                       hard: bool = False) -> torch.Tensor:
        """Gumbel-sigmoid'd codebook rows (K, vq_dim), binarised with `hard`."""
        g = self.gumbel_sigmoid_trick(self.embedding.weight, noise)
        return hard_concrete(g) if hard else g

    def forward_train(self, z: torch.Tensor, codebook_noise: torch.Tensor,
                      gates_noise: torch.Tensor):
        """Training forward: (z_q (B, vq_dim), indices (B,), new snapshot).

        codebook_noise (K, vq_dim) and gates_noise (B, vq_dim) are the gumbel
        noise of the codebook rows and of the logits z. z_q are the
        gumbel-sigmoid'd codebook rows the prompts are assigned to,
        differentiable in `embedding.weight`; the assignment (Sinkhorn over
        the batch, or the cosine argmax without `optimal_transport`) and the
        new `embedding_gs` snapshot carry no gradient."""
        embedding_gs = self.gumbel_sigmoid_trick(self.embedding.weight, codebook_noise)
        with torch.no_grad():
            scores = self._scores(self.gumbel_sigmoid_trick(z, gates_noise),
                                  embedding_gs.detach())
            if self.optimal_transport:
                indices = sinkhorn_assign(scores)
            else:
                indices = torch.argmax(scores, dim=-1)
        return embedding_gs[indices], indices, embedding_gs.detach()

    @torch.no_grad()
    def init_state(self) -> None:
        """Take the eval snapshot of the codebook with the fixed noise."""
        self.embedding_gs.copy_(self.gumbel_sigmoid_trick(self.embedding.weight))

    def forward_eval(self, z: torch.Tensor, noise: Optional[torch.Tensor] = None):
        """(hard arch codes (B, vq_dim), expert indices (B,))."""
        indices = self.cosine_indices(z, noise)
        return hard_concrete(self.embedding_gs.float()[indices]), indices

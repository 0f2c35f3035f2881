"""Resource (MACs) model over the gate layout.

  cur_prunable_macs(sample) =
      Σ_sites  mean(hard(width_gates_site)) * prunable_site * depth_factor
    + Σ_{depth-gated subblocks} nonprunable_sb * hard(depth_gate_sb)

where depth_factor is hard(depth_gate) of the site's subblock (1 if the
subblock is not depth-gated). The ratio divides by the all-ones value
(`spec.cur_prunable_macs_dense`).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from diffusion_pruning_tpu_torch.core.estimators import hard_concrete
from diffusion_pruning_tpu_torch.core.structure import StructureSpec
from diffusion_pruning_tpu_torch.utils.profiling import host_sync


@dataclasses.dataclass(frozen=True)
class ResourceModel:
    spec: StructureSpec

    def _tables(self):
        spec = self.spec
        w_coeff = np.zeros(spec.num_width, dtype=np.float32)
        w_depth_idx = np.zeros(spec.num_width, dtype=np.int64)  # 0-based +1; 0 = none
        d_nonprunable = np.zeros(max(spec.num_depth, 1), dtype=np.float32)
        for sb in spec.subblocks:
            for site in sb.sites:
                sl = slice(site.start, site.start + site.width)
                w_coeff[sl] = site.prunable_macs / site.width
                w_depth_idx[sl] = sb.depth_index + 1
            if sb.depth_index >= 0:
                d_nonprunable[sb.depth_index] = sb.nonprunable_macs
        return w_coeff, w_depth_idx, d_nonprunable

    def cur_prunable_macs(self, arch: torch.Tensor) -> torch.Tensor:
        """Per-sample MACs under the gates. arch: (B, vq_dim) -> (B,)."""
        spec = self.spec
        tables = []
        for t in self._tables():
            with host_sync(arch.device):   # a copy from the host's memory waits for the stream
                tables.append(torch.as_tensor(t, device=arch.device))
        w_coeff, w_depth_idx, d_nonprunable = tables
        arch = arch.float()
        w = hard_concrete(arch[:, : spec.num_width])
        if spec.num_depth > 0:
            d = hard_concrete(arch[:, spec.num_width:])
        else:
            d = arch.new_ones((arch.shape[0], 1))
        d_ext = torch.cat([arch.new_ones((arch.shape[0], 1)), d], dim=1)
        dfac = d_ext[:, w_depth_idx]
        macs = torch.sum(w * dfac * w_coeff, dim=1)
        return macs + d @ d_nonprunable

    def resource_ratio(self, arch: torch.Tensor) -> torch.Tensor:
        """Per-sample ratio vs the dense (all-ones) model — in (0, 1];
        differentiable in `arch` through the straight-through estimator."""
        return self.cur_prunable_macs(arch) / self.spec.cur_prunable_macs_dense

    def actual_pruning_target(self, p: float) -> float:
        """Rescale a total-MACs keep fraction p onto prunable-MACs space:
        keeping p of the total MACs means keeping this fraction of the
        gateable ones."""
        return float(1.0 - (1.0 - p) * self.spec.total_macs / self.spec.cur_prunable_macs_dense)

    def prunable_macs_template(self) -> np.ndarray:
        """Per arch-vector slot, the fraction of all prunable MACs its gate
        site controls; a depth slot gets its subblock's fraction (the
        quantizer's resource-aware normalisation)."""
        spec = self.spec
        out = np.zeros(spec.vq_dim, dtype=np.float32)
        for sb in spec.subblocks:
            for site in sb.sites:
                out[site.start: site.start + site.width] = site.prunable_macs / spec.prunable_macs
            if sb.depth_index >= 0:
                out[spec.num_width + sb.depth_index] = sb.prunable_macs / spec.prunable_macs
        return out

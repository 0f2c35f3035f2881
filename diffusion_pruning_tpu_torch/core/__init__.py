from diffusion_pruning_tpu_torch.core.estimators import (
    fixed_generator,
    hard_concrete,
    importance_gumbel_sigmoid,
    sample_gumbel,
)
from diffusion_pruning_tpu_torch.core.resource import ResourceModel
from diffusion_pruning_tpu_torch.core.structure import (
    GateSite,
    StructureSpec,
    SubBlock,
    build_structure,
)

__all__ = ["GateSite", "ResourceModel", "StructureSpec", "SubBlock", "build_structure",
           "fixed_generator", "hard_concrete", "importance_gumbel_sigmoid", "sample_gumbel"]

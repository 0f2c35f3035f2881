from diffusion_pruning_tpu_torch.training.pruner import (
    PrunerConfig,
    PrunerModules,
    compute_losses,
    make_optimizer,
    make_pruner_step,
    make_validation_step,
)

__all__ = ["PrunerConfig", "PrunerModules", "compute_losses", "make_optimizer",
           "make_pruner_step", "make_validation_step"]

from diffusion_pruning_tpu_torch.training.finetuner import (
    FineTuneConfig,
    FineTunerModules,
    MasterWeights,
    make_finetune_optimizer,
    make_finetune_step,
    make_finetune_validation_step,
)
from diffusion_pruning_tpu_torch.training.pruner import (
    PrunerConfig,
    PrunerModules,
    compute_losses,
    make_optimizer,
    make_pruner_step,
    make_validation_step,
)

__all__ = ["FineTuneConfig", "FineTunerModules", "MasterWeights", "PrunerConfig", "PrunerModules",
           "compute_losses", "make_finetune_optimizer", "make_finetune_step",
           "make_finetune_validation_step", "make_optimizer", "make_pruner_step",
           "make_validation_step"]

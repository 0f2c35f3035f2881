from diffusion_pruning_tpu_torch.losses.losses import (
    contrastive_loss,
    diffusion_loss,
    resource_loss,
    snr_weights,
)

__all__ = ["contrastive_loss", "diffusion_loss", "resource_loss", "snr_weights"]

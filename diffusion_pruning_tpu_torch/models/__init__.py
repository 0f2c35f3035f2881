"""Model definitions: the gated U-Net, text encoders, router and VAE decoder."""

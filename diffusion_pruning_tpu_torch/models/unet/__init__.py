"""The gated SD U-Net."""

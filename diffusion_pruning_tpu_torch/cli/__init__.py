"""Command-line entry points: `python -m diffusion_pruning_tpu_torch.cli.<name>`."""

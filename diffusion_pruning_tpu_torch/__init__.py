"""PyTorch/CUDA port of diffusion_pruning_tpu (APTP: prompt-routed pruned
experts of the SD-2.1 U-Net) for NVIDIA Hopper.

Same module layout and names as the JAX package, written in PyTorch idiom.
Entry points run on the CUDA card unless the caller passes `device="cpu"`.
Hand-written CUDA kernels live in `csrc/` and are built with nvcc at first use.
"""

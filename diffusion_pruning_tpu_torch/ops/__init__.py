"""Gate application and the hand-written CUDA kernels' wrappers."""

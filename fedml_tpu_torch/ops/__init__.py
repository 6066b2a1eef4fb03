"""Tensor ops of the port; hand-written CUDA kernels live in ``csrc/``."""

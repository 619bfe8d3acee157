"""Compute kernels: hand-written CUDA, each with its plain PyTorch twin."""

"""Losses, metrics, their registries and the CUDA kernels of the port."""

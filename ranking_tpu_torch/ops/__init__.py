"""Metrics, the metric registry and the CUDA kernels of the port."""

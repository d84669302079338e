"""Tensor ops of the port: capacity, node sorting, the gang solve, the
segmented window solve and its CUDA kernel, and the kernels' build."""

"""Tensor ops of the port: capacity, node sorting, the closed-form packing
and the batched engine (plain PyTorch), the gang solve, the segmented
window solve and the queue-mode FIFO admission with their CUDA kernels, and
the kernels' build."""

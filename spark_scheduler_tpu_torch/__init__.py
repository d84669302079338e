"""PyTorch/CUDA port of spark_scheduler_tpu for NVIDIA Hopper.

A package of its own beside the JAX package, which stays the reference: it
imports torch and numpy, never jax and nothing of spark_scheduler_tpu. Entry
points run on CUDA unless the caller asks for the CPU, where the hand-written
kernels' plain PyTorch versions run instead.
"""

"""Shark on PyTorch and CUDA: the port of the JAX package `repro`.

This slice holds the SQL main path (`core/`) and its hand-written Hopper
kernels (`kernels/`).  Sessions compute on the GPU unless the caller asks
for the CPU (`SharkSession(device="cpu")`)."""

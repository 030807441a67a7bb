"""Hand-written Hopper kernels of the torch port, each beside its plain
PyTorch version (see ops.py for the engine-facing wrappers)."""

"""Hand-written CUDA kernels of the port, their plain twins and wrappers."""

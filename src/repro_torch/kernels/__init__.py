"""Hand-written CUDA kernels for Hopper and their plain versions."""

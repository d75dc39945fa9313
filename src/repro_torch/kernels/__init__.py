"""Hand-written CUDA kernels, their launch wrappers and plain versions."""

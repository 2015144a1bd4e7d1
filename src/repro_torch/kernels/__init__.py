"""Hand-written CUDA kernels of the port, their launch wrappers and their
plain PyTorch versions."""

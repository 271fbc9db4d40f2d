"""Plain PyTorch ops and the switch between them and the CUDA kernels."""

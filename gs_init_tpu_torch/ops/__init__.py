"""PyTorch ops of the port; the tile compositor holds the CUDA kernels."""

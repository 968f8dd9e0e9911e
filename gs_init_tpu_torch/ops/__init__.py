"""PyTorch ops of the port; the tile compositor holds the CUDA kernels."""
from . import projection, rasterize_ref, sh  # noqa: F401

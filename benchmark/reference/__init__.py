"""The benchmark's plain reference: plain PyTorch that imports nothing of
the port, of the JAX package or of JAX."""

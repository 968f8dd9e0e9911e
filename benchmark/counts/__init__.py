"""The benchmark's operation and byte counts, computed from shapes and
inputs, never read from the port's kernels."""

"""Multi-GPU training: process groups, collectives with JAX's gradients, the
(data, gauss) mesh and the sharded train steps."""

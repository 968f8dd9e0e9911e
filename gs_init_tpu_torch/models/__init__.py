"""The depth networks — port of ``gs_init_tpu/models/`` (all but SAM): the
DINOv2 ViT, the DPT head, Metric3D's RAFT-DPT decoder, MoGe-2, UniDepth-v2
and DepthPro. Plain PyTorch: the JAX package has no Pallas kernel in them."""

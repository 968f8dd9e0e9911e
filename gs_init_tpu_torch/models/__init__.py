"""The networks — port of ``gs_init_tpu/models/``: the DINOv2 ViT, the DPT
head, Metric3D's RAFT-DPT decoder, MoGe-2, UniDepth-v2, DepthPro and SAM.
Plain PyTorch: the JAX package has no Pallas kernel in them."""

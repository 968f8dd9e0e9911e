"""Depth predictors: the stub, Metric3D v2, Depth-Anything-V2, MoGe-2,
UniDepth-v2 and Apple DepthPro (their networks under
``gs_init_tpu_torch/models/``)."""

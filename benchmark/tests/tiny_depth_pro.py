"""Depth Pro cut to a narrow network for the CPU tests of its cell: the port's
``pick_model`` builds ``NARROW`` at ``SIZE`` pixels (the published
structure: 3 scales, 1 + 9 + 25 crops, hooks, merge padding), with a fault
planted in the port or none. Run a cell with it:

    python3 -c "import tiny_depth_pro; tiny_depth_pro.main()" <fault or none> <run.py arguments>

with this folder on ``PYTHONPATH``. Faults:

- ``merge_no_crop``: the port merges its crop grids with merge padding 0;
- ``hooks_swapped``: the port's patch encoder hands out the hook blocks'
  outputs (blocks 1 and 2 of the narrow network) in each other's place.
"""
from __future__ import annotations

import runpy
import sys

NARROW = dict(vit_dim=64, vit_depth=4, vit_heads=4, vit_image_size=64, vit_patch=16, fusion=16,
              intermediate_hook_ids=(2, 1), intermediate_feature_dims=(16, 16),
              scaled_images_ratios=(0.25, 0.5, 1.0), scaled_images_overlap_ratios=(0.0, 0.5, 0.25),
              scaled_images_feature_dims=(64, 64, 32), merge_padding_value=3)
SIZE = 256  # 4 crops wide, as 1536 is of 384


def group() -> dict:
    """The configuration's ``depth_pro`` group for the narrow network."""
    return dict({k: list(v) if isinstance(v, tuple) else v for k, v in NARROW.items()}, input_size=SIZE)


def install(fault: str) -> None:
    from gs_init_tpu_torch.mdi.predictors import apple_depth_pro as pdp

    real = pdp.AppleDepthProPredictor

    class Narrow(real):
        def __init__(self, **kw):
            super().__init__(input_size=SIZE, **kw, **NARROW)
            if fault == "merge_no_crop":
                self.net.merge_padding_value = 0
            elif fault == "hooks_swapped":
                vit = self.net.depth_pro.encoder.patch_encoder.model
                n = len(self.net.hook_ids)
                vit.out_layers = vit.out_layers[:n][::-1] + vit.out_layers[n:]
            elif fault != "none":
                raise SystemExit(f"unknown fault {fault!r}")

    pdp.AppleDepthProPredictor = Narrow


def main() -> None:
    install(sys.argv[1])
    sys.argv = ["benchmark/run.py"] + sys.argv[2:]
    runpy.run_path("benchmark/run.py", run_name="__main__")

"""Faults planted in the port underneath an init cell's run, for the tests
that see ``correct`` come out false. Run a cell with one installed:

    python3 -c "import faults_init; faults_init.main()" <fault> <run.py arguments>

with this folder on ``PYTHONPATH``:

- ``sam_token0``: SAM's mask decoder hands out the single-mask token's
  logits and IoU for every token (multimask output then repeats it);
- ``ransac_scale``: the default path's RANSAC scale is 0.1% too large.
"""
from __future__ import annotations

import runpy
import sys


def install(kind: str) -> None:
    if kind == "sam_token0":
        from gs_init_tpu_torch.models import sam

        real = sam.SamMaskDecoder.forward

        def forward(self, *a, **kw):
            masks, iou = real(self, *a, **kw)
            return masks[:, :1].expand_as(masks).contiguous(), iou[:, :1].expand_as(iou).contiguous()

        sam.SamMaskDecoder.forward = forward
    elif kind == "ransac_scale":
        from gs_init_tpu_torch.mdi import points_from_depth as pfd

        real = pfd.ransac_scale_shift

        def ransac_scale_shift(*a, **kw):
            s, t, inliers = real(*a, **kw)
            return s * 1.001, t, inliers

        pfd.ransac_scale_shift = ransac_scale_shift
    else:
        raise SystemExit(f"unknown fault {kind!r}")


def main() -> None:
    kind = sys.argv[1]
    install(kind)
    sys.argv = ["benchmark/run.py"] + sys.argv[2:]
    runpy.run_path("benchmark/run.py", run_name="__main__")

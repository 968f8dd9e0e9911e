"""Faults planted in the port underneath a benchmark run, for the tests that
see ``correct`` come out false. Run a cell with one installed:

    python3 -c "import faults; faults.main()" <fault> <run.py arguments>

with this folder on ``PYTHONPATH``. The faults a training cell on one card
can have:

- ``unchanged``: each train step returns the state it was given;
- ``half_batch``: the loss leaves out half of the batch (the lower half of
  each image's rows: the batch holds one image) and takes the mean over the
  rest;
- ``altered``: an answer altered where it is produced: each step's update
  of the opacities is off by 1e-2.

Across chips there is no exchange to leave out: every cell runs on one.
"""
from __future__ import annotations

import runpy
import sys


def install(kind: str) -> None:
    import torch

    from gs_init_tpu_torch.engine import runner as prunner
    from gs_init_tpu_torch.engine import train_step as pstep

    if kind == "half_batch":
        real = pstep.image_loss

        def image_loss(cfg, la, batch, rendered, alpha, depth, depth_count=None):
            h = rendered.shape[1] // 2
            half = pstep.Batch(camtoworlds=batch.camtoworlds, Ks=batch.Ks, pixels=batch.pixels[:, :h],
                               image_ids=batch.image_ids)
            return real(cfg, la, half, rendered[:, :h], alpha[:, :h], depth, depth_count)

        pstep.image_loss = image_loss
        return
    real_make = prunner.make_train_step

    def make_train_step(*a, **kw):
        step_fn = real_make(*a, **kw)

        def broken(gstate, adam, sstate, aux, aux_opt, batch, step, **kw2):
            before = {k: v.clone() for k, v in gstate.params.items()} if kind == "unchanged" else None
            out = step_fn(gstate, adam, sstate, aux, aux_opt, batch, step, **kw2)
            with torch.no_grad():
                if kind == "unchanged":
                    for k, v in out[0].params.items():
                        v.copy_(before[k])
                elif kind == "altered":
                    out[0].params.opacities.add_(1e-2)
            return out

        return broken

    prunner.make_train_step = make_train_step


def main() -> None:
    kind = sys.argv[1]
    install(kind)
    sys.argv = ["benchmark/run.py"] + sys.argv[2:]
    runpy.run_path("benchmark/run.py", run_name="__main__")

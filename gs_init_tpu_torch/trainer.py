"""CLI entry point of the port — counterpart of ``gs_init_tpu/trainer.py``.

    python -m gs_init_tpu_torch.trainer default --data_dir data/360_v2/garden \
        --result_dir results/garden
    python -m gs_init_tpu_torch.trainer mcmc --strategy.cap_max=6000000
    python -m gs_init_tpu_torch.trainer default --ckpt=results/g/ckpts/ckpt_7000.npz

Presets: ``default`` (the default strategy) and ``mcmc`` (the MCMC strategy
with its opacity and scale regularisers and init overrides). ``--ckpt``
loads a checkpoint (either package's), evaluates it and renders the
trajectory instead of training. It runs on the card; ``main(argv,
device="cpu")`` runs it on the CPU (the tests do).

With ``--disable_viewer=false`` the live viewer serves during training and,
unless ``--non_blocking_viewer``, stays up after it until Ctrl+C.

Multi-GPU: one process per GPU, launched by torchrun or with the JAX
trainer's ``COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` /
``JAX_PROCESS_ID`` (``parallel/multihost.py``); ``--mesh=DxG`` (or
``auto``) and ``--shard_pixels`` pick the mesh::

    torchrun --nproc_per_node=4 -m gs_init_tpu_torch.trainer default \
        --data_dir data/360_v2/garden --mesh=2x2

Each process runs on ``cuda:LOCAL_RANK`` unless ``main`` is given a
device; the process group uses NCCL on the card and gloo on the CPU, and
``main(..., backend="gloo")`` lets several ranks share one card.
"""
from __future__ import annotations

import sys

from .config import Config, DefaultStrategyConfig, MCMCStrategyConfig, parse_cli


def build_presets():
    default = Config(strategy=DefaultStrategyConfig())
    mcmc = Config(
        strategy=MCMCStrategyConfig(),
        init_opa=0.5,
        init_scale=0.1,
        opacity_reg=0.01,
        scale_reg=0.01,
    )
    return {"default": default, "mcmc": mcmc}


def run_with_config(cfg: Config, device=None):
    """Train (or, with ``cfg.ckpt``, load, evaluate and render the
    trajectory); returns the Runner."""
    from .engine.runner import Runner

    cfg.adjust_steps()
    runner = Runner(cfg, device=device)
    if cfg.ckpt:
        step = runner.load(cfg.ckpt[0])
        runner.eval(step)
        runner.render_traj(step)
    else:
        runner.train()
    if not cfg.disable_viewer and not cfg.non_blocking_viewer:
        import time

        print("Viewer running... Ctrl+C to exit.")
        try:
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            pass
    return runner


def main(argv=None, device=None, backend=None):
    """Parse the CLI and run. Under a multi-process launch (torchrun, or
    ``COORDINATOR_ADDRESS``) join the process group first: ``device``
    defaults to ``cuda:LOCAL_RANK`` and ``backend`` to NCCL there (gloo on
    the CPU)."""
    from .parallel.multihost import initialize_multihost, launch_env, local_device

    if launch_env():
        device = local_device(device)
        rank, world = initialize_multihost(backend=backend, device=device)
        print(f"[trainer] process {rank} of {world} on {device}", flush=True)
    cfg = parse_cli(argv if argv is not None else sys.argv[1:], build_presets())
    return run_with_config(cfg, device=device)


if __name__ == "__main__":
    main()

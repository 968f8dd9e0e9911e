"""The multi-process launch and the global mesh — port of
``gs_init_tpu/parallel/multihost.py``.

One process per GPU (``torch.distributed``), where the JAX package runs one
controller per host. ``initialize_multihost`` joins the process group from
the environment: torchrun's ``MASTER_ADDR`` / ``MASTER_PORT`` /
``WORLD_SIZE`` / ``RANK`` / ``LOCAL_RANK``, or the JAX trainer's
``COORDINATOR_ADDRESS`` (or ``JAX_COORDINATOR_ADDRESS``, host:port),
``JAX_NUM_PROCESSES`` and ``JAX_PROCESS_ID``, so a launch line written for
the JAX trainer works. Without ``LOCAL_RANK`` a process takes ``RANK``
modulo the visible card count.

Axis layout as in the JAX package: the "data" (camera) axis spans hosts,
its collectives being the small loss and gradient sums; the "gauss" axis
stays within a host, where the per-step all_gather of screen-space
attributes rides NVLink. Ranks are numbered host-major (torchrun's order)
and reshaped row-major into (data, gauss).
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

_JAX_ENV = (
    ("JAX_NUM_PROCESSES", "WORLD_SIZE"),
    ("JAX_PROCESS_ID", "RANK"),
)


def launch_env() -> dict:
    """The torchrun variables this process's environment implies (the JAX
    trainer's names mapped onto them); empty for a single-process run."""
    env = os.environ
    coord = env.get("COORDINATOR_ADDRESS") or env.get("JAX_COORDINATOR_ADDRESS")
    out = {}
    if coord:
        host, _, port = coord.rpartition(":")
        out["MASTER_ADDR"], out["MASTER_PORT"] = host or "localhost", port
        for jax_name, name in _JAX_ENV:
            if env.get(jax_name) is not None:
                out[name] = env[jax_name]
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        if env.get(name) is not None:
            out[name] = env[name]
    if not out.get("WORLD_SIZE"):
        return {}
    out.setdefault("RANK", "0")
    if "LOCAL_RANK" not in out:
        out["LOCAL_RANK"] = str(int(out["RANK"]) % max(torch.cuda.device_count(), 1))
    return out


def default_backend(device) -> str:
    """``nccl`` for ranks on their own cards, ``gloo`` on the CPU. Ranks
    that share one card must ask for ``gloo`` themselves."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def local_device(device=None) -> torch.device:
    """``device`` if given, else this process's card (``cuda:LOCAL_RANK``)."""
    if device is not None:
        return torch.device(device)
    return torch.device("cuda", int(launch_env().get("LOCAL_RANK", 0)))


def initialize_multihost(backend: Optional[str] = None, device=None) -> Tuple[int, int]:
    """Join the process group from the environment (idempotent; a no-op
    without a multi-process launch). ``backend`` defaults to
    ``default_backend(device)``. Returns (rank, world size)."""
    if not dist.is_initialized():
        env = launch_env()
        if not env:
            return 0, 1
        os.environ.update(env)
        dev = local_device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend or default_backend(dev), init_method="env://",
            world_size=int(env["WORLD_SIZE"]), rank=int(env["RANK"]),
        )
    return dist.get_rank(), dist.get_world_size()


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def local_process_count() -> int:
    """Processes per host: ``LOCAL_WORLD_SIZE``, else the visible cards
    (at least 1, at most the world)."""
    n = os.environ.get("LOCAL_WORLD_SIZE")
    n = int(n) if n else max(torch.cuda.device_count(), 1)
    return max(1, min(n, process_count()))


def make_global_mesh(n_data: Optional[int] = None, n_gauss: Optional[int] = None):
    """The mesh over every process, data axis across hosts. Defaults: one
    data shard per host, gaussian shards over the processes of a host."""
    from .shard import make_mesh

    world = process_count()
    n_data = n_data or max(world // local_process_count(), 1)
    n_gauss = n_gauss or world // max(n_data, 1)
    return make_mesh(n_data, n_gauss)


def local_batch_slice(global_batch: int) -> slice:
    """This process's slice of a batch sharded over all processes."""
    per = global_batch // process_count()
    start = process_index() * per
    return slice(start, start + per)

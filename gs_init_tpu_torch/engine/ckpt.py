"""Sharded checkpoints — port of ``gs_init_tpu/engine/ckpt.py``.

The JAX package writes sharded state with orbax (``save_orbax`` /
``load_orbax``). Orbax and tensorstore are not on the card's machine, so the
port has a format of its own, in the spirit of the reference's per-rank
``ckpt_*_rank{r}`` files:

    <result_dir>/ckpts/sharded_<step>/shard<g>.npz   gaussian shard g's rows:
        alive, params/*, mu/*, nu/*, strategy/* (written by the rank of
        data row 0 that holds them; the other data rows hold the same rows)
    <result_dir>/ckpts/sharded_<step>/replicated.npz  aux/*, transform
    <result_dir>/ckpts/sharded_<step>/meta.json       step, capacity, mesh,
        shards, adam_count (written last)

``load_sharded`` re-shards onto the current mesh, whatever its shape (its
gauss axis must divide the capacity), or onto one device: each rank reads
only the shard files that overlap its rows. The whole-state npz of
``Runner.save`` stays the format that both packages load.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch
import torch.distributed as dist

from ..parallel import shard as pshard
from .optim import AdamState
from .params import PARAM_NAMES, GaussianState, aux_from_leaves, aux_leaves, params_from_numpy
from .strategy import default as dstrat

_STRATEGY = ("grad2d", "count", "radii_max")


def save_sharded(runner, step: int) -> str:
    """Write this rank's shard of the runner's state (every rank of the
    mesh calls it); returns the checkpoint directory."""
    mesh = runner.mesh
    path = os.path.join(runner.cfg.result_dir, "ckpts", f"sharded_{step}")
    os.makedirs(path, exist_ok=True)
    di, gi = (0, 0) if mesh is None else (mesh.di, mesh.gi)
    n = lambda x: x.detach().cpu().numpy()
    if di == 0:
        flat = {"alive": n(runner.gstate.alive)}
        for name in PARAM_NAMES:
            flat[f"params/{name}"] = n(getattr(runner.gstate.params, name))
            flat[f"mu/{name}"] = n(getattr(runner.adam.mu, name))
            flat[f"nu/{name}"] = n(getattr(runner.adam.nu, name))
        for name in _STRATEGY:
            flat[f"strategy/{name}"] = n(getattr(runner.sstate, name))
        np.savez(os.path.join(path, f"shard{gi}.npz"), **flat)
    if runner.is_main:
        rep = {"transform": runner.parser.transform}
        rep.update({f"aux/{i}": n(leaf) for i, leaf in enumerate(aux_leaves(runner.aux))})
        np.savez(os.path.join(path, "replicated.npz"), **rep)
    if mesh is not None:
        dist.barrier(group=mesh.world)
    if runner.is_main:
        shape = [1, 1] if mesh is None else [mesh.n_data, mesh.n_gauss]
        meta = dict(step=int(step), capacity=int(runner.cfg.max_gaussians), mesh=shape,
                    shards=shape[1], adam_count=int(runner.adam.count))
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(meta, f, indent=2)
    if mesh is not None:
        dist.barrier(group=mesh.world)
    return path


def load_sharded(runner, path: str) -> int:
    """Restore a ``save_sharded`` checkpoint onto the runner's mesh (or its
    one device); every rank of the mesh calls it. Returns the step."""
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    cap = meta["capacity"]
    if cap != runner.cfg.max_gaussians:
        raise ValueError(f"checkpoint capacity {cap} != this run's max_gaussians {runner.cfg.max_gaussians}")
    rows = slice(0, cap) if runner.mesh is None else pshard.gauss_rows(cap, runner.mesh)
    per = cap // meta["shards"]
    parts = {}
    for j in range(meta["shards"]):
        lo, hi = max(rows.start, j * per), min(rows.stop, (j + 1) * per)
        if lo >= hi:
            continue
        with np.load(os.path.join(path, f"shard{j}.npz")) as z:
            for k in z.files:
                parts.setdefault(k, []).append(z[k][lo - j * per:hi - j * per])
    flat = {k: np.concatenate(v) for k, v in parts.items()}
    dev = runner.device
    leaves = lambda prefix: {k: flat[f"{prefix}/{k}"] for k in PARAM_NAMES}
    runner.gstate = GaussianState(
        params=params_from_numpy(leaves("params"), dev),
        alive=torch.as_tensor(flat["alive"], device=dev).bool(),
    )
    runner.adam = AdamState(
        mu=params_from_numpy(leaves("mu"), dev), nu=params_from_numpy(leaves("nu"), dev),
        count=int(meta["adam_count"]),
    )
    runner.sstate = dstrat.strategy_from_numpy(*(flat[f"strategy/{k}"] for k in _STRATEGY), dev)
    like = aux_leaves(runner.aux)
    with np.load(os.path.join(path, "replicated.npz")) as z:
        if like and sum(k.startswith("aux/") for k in z.files) == len(like):
            runner.aux = aux_from_leaves(
                runner.aux, [torch.as_tensor(z[f"aux/{i}"], device=dev).float() for i in range(len(like))]
            )
    runner.refresh_view()
    runner.global_step = int(meta["step"])
    return runner.global_step

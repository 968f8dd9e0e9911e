"""Multi-process helpers for the port's multi-GPU tests (tests/test_torch_
{parallel,band_shard,runner_mesh,ckpt,multihost}.py).

``spawn(fn, world, *args)`` starts ``world`` processes that join a gloo
process group on the CPU and run ``fn(rank, world, *args)``; it returns
their results (numpy and plain Python) by rank and re-raises a rank's
exception. A spawn costs seconds, so each test module runs many cases in
one. This module imports no JAX, so the ranks start quickly; the parent
builds the inputs (from numpy, or from the JAX package's state) and the
references.

``run_step`` is one train step from numpy inputs, on one device or (under
an initialised process group) on a mesh; it returns the whole-capacity
state after the step as numpy, gathered from every rank's slice.
"""
from __future__ import annotations

import os
import socket
import traceback

import numpy as np
import torch

from torch_parity import assert_close_scaled

CPU = torch.device("cpu")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _entry(rank, world, port, fn, args, queue, init):
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        if init:
            dist.init_process_group(
                "gloo", init_method=f"tcp://localhost:{port}", world_size=world, rank=rank
            )
            out = fn(rank, world, *args)
        else:
            out = fn(rank, world, port, *args)
        if dist.is_initialized():
            dist.destroy_process_group()
        queue.put((rank, "ok", out))
    except BaseException:  # handed to the parent
        queue.put((rank, "error", traceback.format_exc()))


def spawn(fn, world: int, *args, init: bool = True, timeout: float = 300.0):
    """Run ``fn(rank, world, *args)`` in ``world`` gloo ranks on the CPU;
    returns the results ordered by rank. With ``init=False`` the ranks join
    no process group themselves and ``fn(rank, world, port, *args)`` gets
    the free port for its own launch."""
    import torch.multiprocessing as mp

    os.environ.setdefault("TORCH_CPP_LOG_LEVEL", "ERROR")
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_entry, args=(r, world, port, fn, args, queue, init)) for r in range(world)]
    for p in procs:
        p.start()
    try:
        results = {}
        for _ in procs:
            rank, status, out = queue.get(timeout=timeout)
            if status != "ok":
                raise RuntimeError(f"rank {rank} of {world} failed:\n{out}")
            results[rank] = out
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
    return [results[r] for r in range(world)]


# ---------------------------------------------------------------- a step


def port_inputs(inputs: dict, device=CPU):
    """The port's state, batch and aux groups from numpy ``inputs``:
    ``params`` (dict by field), ``alive``, ``batch`` (dict of Batch fields),
    optional ``pose``, ``app`` (dict by field) and ``grids``."""
    from gs_init_tpu_torch.engine import optim
    from gs_init_tpu_torch.engine.params import aux_from_numpy, state_from_numpy
    from gs_init_tpu_torch.engine.strategy import default as dstrat
    from gs_init_tpu_torch.engine.train_step import Batch

    g = state_from_numpy(inputs["params"], inputs["alive"], device)
    t = lambda k, v: torch.as_tensor(np.array(v), device=device).long() if k == "image_ids" else \
        torch.as_tensor(np.array(v, np.float32), device=device)
    batch = Batch(**{k: t(k, v) for k, v in inputs["batch"].items()})
    aux = aux_from_numpy(inputs.get("pose"), inputs.get("app"), inputs.get("grids"), device)
    return g, optim.init_adam_state(g.params), dstrat.init_state(g.alive.shape[0], device), batch, aux


_MESHES: dict = {}


def mesh_for(shape):
    """One mesh per shape and process (every rank asks in the same order,
    as ``dist.new_group`` needs)."""
    from gs_init_tpu_torch.parallel import shard

    if tuple(shape) not in _MESHES:
        _MESHES[tuple(shape)] = shard.make_mesh(*shape)
    return _MESHES[tuple(shape)]


def run_step(cfg, scene_scale: float, width: int, height: int, inputs: dict, mesh_shape=None,
             band: bool = False, bands_per_rank: int = 1, device=CPU) -> dict:
    """One step of ``make_train_step`` (``mesh_shape`` None) or of the
    sharded / band step (``bands_per_rank`` bands a rank) on that mesh;
    returns numpy: loss and metrics, the
    whole-capacity params, Adam first moments, grad2d and count after it,
    and the aux leaves."""
    from gs_init_tpu_torch.engine import optim
    from gs_init_tpu_torch.engine.params import PARAM_NAMES, aux_leaves
    from gs_init_tpu_torch.engine.train_step import init_aux_opt, make_train_step
    from gs_init_tpu_torch.parallel import shard

    g, adam, ss, batch, aux = port_inputs(inputs, device)
    acfg = optim.make_adam_config(cfg, scene_scale)
    bkgd = None if inputs.get("bkgd") is None else torch.as_tensor(np.array(inputs["bkgd"]), device=device)
    if mesh_shape is None:
        step = make_train_step(cfg, acfg, width, height)
        mesh = None
    else:
        mesh = mesh_for(mesh_shape)
        if not mesh.member:
            return None
        g, adam, ss = shard.local_state(g, adam, ss, mesh)
        if not band:
            batch = shard.local_batch(batch, mesh)
        if band:
            step = shard.make_band_sharded_train_step(cfg, acfg, width, height, mesh, bands_per_rank)
        else:
            step = shard.make_sharded_train_step(cfg, acfg, width, height, mesh)
    g, adam, ss, aux, aux_opt, m = step(g, adam, ss, aux, init_aux_opt(aux), batch, inputs.get("step", 5), bkgd=bkgd)
    if mesh is not None:
        g, adam, ss = shard.global_state(g, adam, ss, mesh)
    n = lambda x: x.detach().cpu().numpy()
    out = {f"metric/{k}": n(v) for k, v in m.items()}
    out.update({f"params/{k}": n(getattr(g.params, k)) for k in PARAM_NAMES})
    out.update({f"mu/{k}": n(getattr(adam.mu, k)) for k in PARAM_NAMES})
    out.update({"grad2d": n(ss.grad2d), "count": n(ss.count), "alive": n(g.alive)})
    out.update({f"aux/{i}": n(x) for i, x in enumerate(aux_leaves(aux))})
    aux_mu = [optim.tensor_leaves(getattr(aux_opt, k).mu) for k in ("pose", "app", "grids")
              if getattr(aux_opt, k) is not None]
    out.update({f"auxmu/{i}": n(x) for i, x in enumerate(x for group in aux_mu for x in group)})
    return out


def strategy_on_mesh(kind: str, inputs: dict, mesh_shape=None, seed: int = 7) -> dict:
    """The Runner's refine (``kind`` "refine": split noise ``inputs["eps"]``)
    or MCMC relocation and noise ("mcmc": a generator seeded ``seed``, the
    noise's normals drawn whole and sliced per rank) on the whole state:
    under a mesh, gathered from the ranks' slices, run alike on every rank,
    sliced again; returns the whole state after it as numpy."""
    from gs_init_tpu_torch.config import DefaultStrategyConfig, MCMCStrategyConfig
    from gs_init_tpu_torch.device import generator
    from gs_init_tpu_torch.engine.params import PARAM_NAMES
    from gs_init_tpu_torch.engine.strategy import default as dstrat
    from gs_init_tpu_torch.engine.strategy import mcmc
    from gs_init_tpu_torch.parallel import shard

    g, adam, ss, _, _ = port_inputs(inputs)
    ss.grad2d[:16] = 1.0
    ss.count[:] = 1.0
    cap = g.alive.shape[0]
    mesh = None if mesh_shape is None else mesh_for(mesh_shape)
    whole = (lambda *st: st) if mesh is None else (lambda *st: shard.global_state(*st, mesh))
    part = (lambda *st: st) if mesh is None else (lambda *st: shard.local_state(*st, mesh))
    if mesh is not None:
        g, adam, ss = part(g, adam, ss)
    if kind == "refine":
        eps1, eps2 = (torch.as_tensor(e) for e in inputs["eps"])
        g, adam, ss = part(*dstrat.refine(*whole(g, adam, ss), eps1, eps2, 1.0, DefaultStrategyConfig(), 1000)[:3])
    else:
        scfg = MCMCStrategyConfig(cap_max=cap)
        gen = generator(seed)
        g, adam, ss = part(*mcmc.relocate(*whole(g, adam, ss), gen, scfg))
        eps = mcmc.noise_eps(cap, gen)
        if mesh is not None:
            eps = eps[shard.gauss_rows(cap, mesh)]
        g = mcmc.add_noise(g, eps, 1e-3, scfg)
    g, adam, ss = whole(g, adam, ss)
    out = {f"params/{k}": getattr(g.params, k).numpy() for k in PARAM_NAMES}
    out.update({f"mu/{k}": getattr(adam.mu, k).numpy() for k in PARAM_NAMES})
    out["alive"] = g.alive.numpy()
    return out


def mesh_jobs(rank, world, jobs):
    """A spawn worker: each job is ("step", cfg_kw, scene_scale, width,
    height, inputs, mesh_shape, band[, bands_per_rank]) for ``run_step``, ("train", ...) for
    ``train_losses``, ("runner", ...) for ``runner_job``, ("restore", ...)
    for ``restore_job``, ("mdi", ...) for ``mdi_job`` or (kind, inputs,
    mesh_shape) for ``strategy_on_mesh``; returns their results."""
    from gs_init_tpu_torch.config import Config

    out = []
    for job in jobs:
        if job[0] == "step":
            _, cfg_kw, scale, w, h, inputs, mesh_shape, band, *per_rank = job
            out.append(run_step(Config(**cfg_kw), scale, w, h, inputs, mesh_shape, band, *per_rank))
        elif job[0] == "train":
            out.append(train_losses(rank, world, *job[1:]))
        elif job[0] == "runner":
            out.append(runner_job(*job[1:]))
        elif job[0] == "restore":
            out.append(restore_job(*job[1:]))
        elif job[0] == "mdi":
            out.append(mdi_job(*job[1:]))
        else:
            out.append(strategy_on_mesh(*job))
    return out


def project_pack_calls(rank, world, cfg_kw, scale, width, height, inputs):
    """A spawn worker: the calls of ``project_pack`` in one camera step and
    in one band step with two bands, each on a 1x1 mesh."""
    from gs_init_tpu_torch.config import Config
    from gs_init_tpu_torch.parallel import shard

    real, calls = shard.project_pack, []

    def counted(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    shard.project_pack = counted
    out = {}
    try:
        for band, bands_per_rank in ((False, 1), (True, 2)):
            calls.clear()
            cfg = Config(**dict(cfg_kw, shard_pixels=band))
            run_step(cfg, scale, width, height, inputs, (1, 1), band, bands_per_rank)
            out["band" if band else "cameras"] = len(calls)
    finally:
        shard.project_pack = real
    return out


def train_losses(rank, world, cfg_kw, scale, inputs, images, c2ws, Ks):
    """A spawn worker: 30 sharded steps on a (2, 2) mesh over alternating
    camera pairs; returns the losses."""
    from gs_init_tpu_torch.engine import optim
    from gs_init_tpu_torch.engine.params import AuxParams
    from gs_init_tpu_torch.engine.train_step import Batch, init_aux_opt
    from gs_init_tpu_torch.config import Config
    from gs_init_tpu_torch.parallel import shard

    cfg = Config(**cfg_kw)
    g, adam, ss, _, _ = port_inputs(inputs)
    mesh = mesh_for((2, 2))
    g, adam, ss = shard.local_state(g, adam, ss, mesh)
    step = shard.make_sharded_train_step(cfg, optim.make_adam_config(cfg, scale), images.shape[2], images.shape[1], mesh)
    aux, losses = AuxParams(), []
    for i in range(30):
        idx = np.array([i % 8, (i + 4) % 8])
        t = lambda x: torch.as_tensor(np.asarray(x, np.float32))
        batch = shard.local_batch(Batch(camtoworlds=t(c2ws[idx]), Ks=t(Ks[idx]), pixels=t(images[idx]),
                                        image_ids=torch.as_tensor(idx)), mesh)
        g, adam, ss, aux, _, m = step(g, adam, ss, aux, init_aux_opt(aux), batch, i)
        losses.append(float(m["loss"]))
    return losses


def global_mesh_info(rank, world):
    """A spawn worker: the default global mesh with two ranks per host."""
    from gs_init_tpu_torch.parallel import multihost

    os.environ["LOCAL_WORLD_SIZE"] = "2"
    mesh = multihost.make_global_mesh()
    return (mesh.shape, (mesh.di, mesh.gi), mesh.ranks.tolist(), multihost.local_batch_slice(8),
            multihost.initialize_multihost())


# ----------------------------------------------------------- comparisons


def assert_step_match(got, want, atol=1e-5, what=""):
    """Two runs of one step in the port (one device and a mesh): loss
    within 1e-5 relative, means, scales, opacities, sh0, grad2d and the aux
    leaves within ``atol``."""
    np.testing.assert_allclose(got["metric/loss"], want["metric/loss"], rtol=1e-5, err_msg=what)
    # As tests/test_parallel.py: the isotropic initial scales leave the
    # quaternions' gradients at rounding noise, whose Adam steps (lr x sign)
    # may flip between summation orders; shN is 0 at SH degree 0.
    for k in ("means", "scales", "opacities", "sh0"):
        np.testing.assert_allclose(got[f"params/{k}"], want[f"params/{k}"], atol=atol, err_msg=f"{what} {k}")
    np.testing.assert_allclose(got["grad2d"], want["grad2d"], atol=atol, err_msg=f"{what} grad2d")
    aux = sorted(k for k in want if k.startswith("aux/"))
    assert aux == sorted(k for k in got if k.startswith("aux/"))
    for k in aux:
        np.testing.assert_allclose(got[k], want[k], atol=atol, err_msg=f"{what} {k}")


def assert_adam_steps_close(got, want, lr, b1, key, mu_key, what):
    """Two libraries' Adam step: the first moment within 1e-4 of the
    leaf's max, each parameter within 1e-5 plus lr x min(2, 2e-4 max|g| /
    |g|), g the JAX gradient (tests/test_torch_train_step.py's bound: a
    gradient error e moves a parameter by about lr x 2e / |g|)."""
    mu = want[mu_key]
    assert_close_scaled(got[mu_key], mu, 1e-4, err_msg=f"{what} {mu_key}")
    g = np.abs(mu) / (1 - b1)
    allowed = 1e-5 + lr * np.minimum(2.0, 2e-4 * g.max() / np.maximum(g, 1e-30))
    diff = np.abs(got[key] - want[key])
    assert (diff <= allowed).all(), (what, key, float((diff - allowed).max()))


# ------------------------------------------------------------ the Runner


def whole_state(runner) -> dict:
    """A Runner's whole-capacity state as numpy (gathered under a mesh):
    params, Adam moments, alive, strategy statistics, aux leaves."""
    from gs_init_tpu_torch.engine.params import PARAM_NAMES, aux_leaves
    from gs_init_tpu_torch.parallel import shard

    g, a, st = runner.gstate, runner.adam, runner.sstate
    if runner.mesh is not None:
        g, a, st = shard.global_state(g, a, st, runner.mesh)
    n = lambda x: x.detach().cpu().numpy()
    out = {"alive": n(g.alive), "adam_count": a.count}
    for k in PARAM_NAMES:
        out.update({f"params/{k}": n(getattr(g.params, k)), f"mu/{k}": n(getattr(a.mu, k)),
                    f"nu/{k}": n(getattr(a.nu, k))})
    out.update({f"strategy/{k}": n(getattr(st, k)) for k in ("grad2d", "count", "radii_max")})
    out.update({f"aux/{i}": n(x) for i, x in enumerate(aux_leaves(runner.aux))})
    return out


def runner_job(cfg_kw: dict, steps: int, actions=()) -> dict:
    """A CPU Runner on the process group's mesh (``cfg_kw["mesh"]``):
    ``steps`` train iterations (their losses), then each action in order:
    "eval" (PSNR), "save" (the npz path), "sharded" (``save_sharded``'s
    directory), "reload" (a second Runner loads the npz: whether its state
    equals this one's, and the loss of one more step), "state"
    (``whole_state``)."""
    from gs_init_tpu_torch.config import Config
    from gs_init_tpu_torch.engine import ckpt
    from gs_init_tpu_torch.engine.runner import Runner

    r = Runner(Config(**cfg_kw), device="cpu")
    out = {"losses": [float(r.train_iteration(i)["loss"]) for i in range(steps)],
           "mesh": None if r.mesh is None else r.mesh.shape, "num_GS": r.num_gaussians()}
    for action in actions:
        if action == "eval":
            out["psnr"] = r.eval(steps)["psnr"]
        elif action == "save":
            out["npz"] = r.save(steps)
        elif action == "sharded":
            out["sharded"] = ckpt.save_sharded(r, steps)
        elif action == "reload":
            r2 = Runner(Config(**cfg_kw), device="cpu")
            out["reload_step"] = r2.load(out["npz"])
            a, b = whole_state(r), whole_state(r2)
            out["reload_equal"] = all(np.array_equal(a[k], b[k]) for k in a)
            out["resumed_loss"] = float(r2.train_iteration(steps + 1)["loss"])
        elif action == "state":
            out["state"] = whole_state(r)
    return out


def mdi_job(cfg_kw: dict) -> dict:
    """A CPU Runner on the process group's mesh with the monocular-depth
    init through the stub predictor: how many images this rank's predictor
    was asked for, and ``whole_state``."""
    from gs_init_tpu_torch.config import Config
    from gs_init_tpu_torch.engine.runner import Runner
    from gs_init_tpu_torch.mdi.predictors.stub import StubPredictor

    class Counting(StubPredictor):
        predicted = 0

        def predict_depth_batch(self, images, intrinsics):
            self.predicted += len(images)
            return super().predict_depth_batch(images, intrinsics)

    model = Counting()
    r = Runner(Config(**cfg_kw), device="cpu", mdi_model=model)
    return {"predicted": model.predicted, "state": whole_state(r)}


def restore_job(cfg_kw: dict, path: str) -> dict:
    """A CPU Runner on the process group's mesh (or one device) restored
    from a sharded checkpoint: its step and ``whole_state``."""
    from gs_init_tpu_torch.config import Config
    from gs_init_tpu_torch.engine import ckpt
    from gs_init_tpu_torch.engine.runner import Runner

    r = Runner(Config(**cfg_kw), device="cpu")
    step = ckpt.load_sharded(r, path)
    return {"step": step, "state": whole_state(r), "mesh": None if r.mesh is None else r.mesh.shape}


def trainer_rank(rank, world, port, argv):
    """A spawn worker launched as the JAX trainer's processes are: the
    ``COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID``
    environment, then ``trainer.main(argv, device="cpu")``; returns the
    rank, the world, the mesh and the final eval."""
    import torch.distributed as dist

    from gs_init_tpu_torch import trainer

    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        os.environ.pop(k, None)
    os.environ.update(COORDINATOR_ADDRESS=f"localhost:{port}", JAX_NUM_PROCESSES=str(world),
                      JAX_PROCESS_ID=str(rank))
    runner = trainer.main(argv, device="cpu")
    return dict(rank=dist.get_rank(), world=dist.get_world_size(), backend=dist.get_backend(),
                mesh=None if runner.mesh is None else runner.mesh.shape, is_main=runner.is_main,
                psnr=runner.eval(runner.cfg.max_steps)["psnr"], state=whole_state(runner))

"""The check of a training cell: the plain reference (``splat_step.py``)
follows the program's first steps from the program's own starting state,
and the start and the strategy step it skips are checked by themselves.

The numbers (``step_numbers``, ``strategy_gap``, ``start_numbers``); those
that the configuration's ``limits.train`` names are compared:

- ``loss_gap``: the largest relative gap of a checked step's loss;
- ``grad_gap``: over the leaves, the gap between the norms of the program's
  first gradient (Adam's first moment after one step over 1 - b1) and the
  reference's, over the larger of the reference leaf's norm and the median
  leaf's;
- ``grad_diff_bulk``: the median leaf's norm of the first gradient's
  difference, without its largest ``BULK_DROP`` of elements, over the leaf's
  norm (the TF32 control moves every element; the norm gaps average it out);
- ``change_gap``: as ``grad_gap``, of the parameters' change over the steps;
- ``stats_gap`` (default strategy): the densification statistics after the
  checked steps, each leaf's norm gap over its norm;
- ``strategy_gap``: the window's first refine or relocation, redone on its
  captured inputs: each output leaf's float64 sum and weighted sum, the gap
  over the leaf's sum of magnitudes;
- ``init_surface_median``, ``init_scale_gap``: the start, by itself.

Leaves whose reference gradient is under a thousandth of the median leaf's
(shN while only degree 0 is active) are left out of the gradient and change
numbers. With ``control="tf32"`` the reference with TF32 matmuls stands in
the program's place.
"""
from __future__ import annotations

import math
import statistics
from types import SimpleNamespace

import numpy as np
import torch

from . import cameras as C
from . import splat_step as R

SAMPLE = 2048
# The share of a leaf's elements left out of ``grad_diff_bulk``: where a
# tile's transmittance falls to the stopping threshold within rounding, the
# kernel and the plain compositor can part on whether the tile takes one more
# chunk of 128 pairs, and those few gaussians' gradients part with it.
BULK_DROP = 1e-3


def scene_cameras(scn, sc: dict):
    """(normalised camera-to-worlds [C, 4, 4] float32, K [3, 3], the Runner's
    scene scale, the normalising transform), as the port's parser derives
    them from the scene's COLMAP model."""
    c2w = scn.c2w.cpu().numpy().astype(np.float64)
    pts = scn.sfm_xyz.astype(np.float32)
    t1 = C.similarity_from_cameras(c2w)
    c2w = C.transform_cameras(t1, c2w)
    pts = C.transform_points(t1, pts)
    t2 = C.align_principal_axes(pts)
    c2w = C.transform_cameras(t2, c2w)
    centers = c2w[:, :3, 3]
    scale = float(np.linalg.norm(centers - centers.mean(axis=0), axis=-1).max()) * 1.1
    return c2w.astype(np.float32), scn.K.cpu().numpy().astype(np.float32), scale * 1.1, t2 @ t1


def follow(st, start, ids, scn, sc, kind, w0, dev, fault=None):
    """The reference's checked steps from the program's starting state:
    (losses, first gradient, parameters after, statistics after). ``fault``
    plants one for the calibration of the limits: ``half_batch`` (the loss
    over half of the batch) or ``altered`` (each step's opacities off by
    1e-2)."""
    c2w, K, scene_scale, _ = scene_cameras(scn, sc)
    acfg = R.adam_config(st, scene_scale)
    d = lambda x: x.to(dev, copy=True)  # the start stays as it was
    g = R.GState(R.Leaves(**{k: d(v) for k, v in start["params"].items()}), d(start["alive"]))
    adam = R.AdamS(R.Leaves(**{k: d(v) for k, v in start["mu"].items()}),
                   R.Leaves(**{k: d(v) for k, v in start["nu"].items()}), start["count"])
    sstate = R.Leaves(**{k: d(v) for k, v in start["sstate"].items()}) if kind == "default" else None
    gen = torch.Generator(device=dev)
    gen.set_state(start["gen_state"])
    strat = SimpleNamespace(**st["strategy"])
    losses, first = [], None
    for k, cam in enumerate(ids):
        step = w0 + k
        pix = S_cast(scn, cam).float() / 255.0
        batch = dict(camtoworlds=torch.as_tensor(c2w[cam], device=dev)[None],
                     Ks=torch.as_tensor(K, device=dev)[None], pixels=pix[None])
        loss, grads = R.train_step(st, acfg, g, adam, sstate, batch, step, scn.width, scn.height,
                                   half=fault == "half_batch")
        if fault == "altered":
            g.params.opacities.add_(1e-2)
        if kind == "mcmc":
            lr_now = float(acfg["lrs"]["means"] * acfg["means_decay_gamma"] ** step)
            R.add_noise(g, R.noise_eps(g.alive.shape[0], gen), lr_now, strat)
        if k == 0:
            first = {n: v.detach().clone() for n, v in grads.items()}
        losses.append(float(loss))
    after = {k: v.clone() for k, v in g.params.items()}
    return losses, first, after, None if sstate is None else dict(sstate.items()), scene_scale


def S_cast(scn, cam):
    from ..harness import scene

    return scene.cast(scn, cam)[0]


def norm_gaps(got: dict, ref: dict, keep) -> float:
    med = statistics.median(float(torch.linalg.norm(ref[k].double())) for k in keep)
    out = 0.0
    for k in keep:
        a = float(torch.linalg.norm(got[k].double()))
        b = float(torch.linalg.norm(ref[k].double()))
        out = max(out, abs(a - b) / max(b, med))
    return out


def strategy_gap(st, captured, kind, scene_scale, dev, weights_seed=12345, tf32=False, unchanged=False) -> float:
    """The window's first refine or relocation redone by the reference on its
    captured inputs (``tf32``: with TF32 matmuls, the control; ``unchanged``:
    the inputs themselves stand for the program's outputs, a fault): the
    largest gap of an output leaf's sum or weighted sum over its sum of
    magnitudes."""
    if tf32:
        return with_tf32(lambda: strategy_gap(st, captured, kind, scene_scale, dev, weights_seed))
    cap = captured["alive"].shape[0]
    d = lambda x: x.to(dev, copy=True)  # the capture stays as it was
    g = R.GState(R.Leaves(**{k: d(v) for k, v in captured["params"].items()}), d(captured["alive"]))
    a = R.AdamS(R.Leaves(**{k: d(v) for k, v in captured["mu"].items()}),
                R.Leaves(**{k: d(v) for k, v in captured["nu"].items()}), 0)
    s = R.Leaves(**{k: d(v) for k, v in captured["sstate"].items()})
    strat = SimpleNamespace(**st["strategy"])
    if kind == "default":
        eps1, eps2, _, _, step = captured["rest"]
        g, a, _, _ = R.refine_default(g, a, s, d(eps1), d(eps2), scene_scale, strat, step)
    else:
        gen = torch.Generator(device=dev)
        gen.set_state(captured["gen_state"])
        g, a, _ = R.relocate(g, a, s, gen, strat)
    w = torch.Generator(device=dev).manual_seed(weights_seed)
    weights = torch.rand((cap,), generator=w, device=dev, dtype=torch.float64)
    leaves = [("alive", g.alive)] + [(k, v) for k, v in g.params.items()]
    leaves += [("mu." + k, v) for k, v in a.mu.items()] + [("nu." + k, v) for k, v in a.nu.items()]
    before = dict([("alive", captured["alive"])] + list(captured["params"].items())
                  + [("mu." + k, v) for k, v in captured["mu"].items()] + [("nu." + k, v) for k, v in captured["nu"].items()])
    out = 0.0
    for k, v in leaves:
        x = v.double().reshape(cap, -1)
        if unchanged:
            y = before[k].to(dev).double().reshape(cap, -1)
            s0, s1 = float(y.sum()), float((y * weights[:, None]).sum())
        else:
            s0, s1 = (float(t) for t in captured["out"][k])
        scale = float(x.abs().sum()) + 1e-30
        out = max(out, abs(s0 - float(x.sum())) / scale, abs(s1 - float((x * weights[:, None]).sum())) / scale)
    return out


def surfaces_distance(scn, sc, xyz: torch.Tensor) -> torch.Tensor:
    """Distance of world points [N, 3] (float64) to the nearest analytic surface."""
    d = torch.full((xyz.shape[0],), float("inf"), dtype=torch.float64, device=xyz.device)
    for c in scn.spheres:
        d = torch.minimum(d, (torch.linalg.norm(xyz - c[:3], dim=-1) - c[3]).abs())
    r = torch.linalg.norm(xyz[:, [0, 2]], dim=-1)
    d = torch.minimum(d, (r - scn.wall_r).abs())
    return torch.minimum(d, (xyz[:, 1] - scn.ground_y).abs())


def knn_mean(points: torch.Tensor, queries: torch.Tensor, k: int = 3, block: int = 256) -> torch.Tensor:
    """sqrt of the mean squared distance from each query to its k nearest
    points other than the nearest (itself), by brute force in float64."""
    out = []
    pts = points.double()
    for i in range(0, queries.shape[0], block):
        q = queries[i:i + block].double()
        d2 = ((q[:, None, :] - pts[None]) ** 2).sum(-1) if pts.shape[0] * q.shape[0] < 1 << 22 else (
            (q ** 2).sum(-1)[:, None] + (pts ** 2).sum(-1)[None] - 2 * q @ pts.T)
        out.append(torch.topk(d2.clamp(min=0), k + 1, largest=False).values[:, 1:].mean(-1).sqrt())
    return torch.cat(out)


def start_numbers(st, start, scn, sc, seed, dev, fault=None) -> dict:
    """The initial gaussians by themselves, on a sample drawn from the seed:
    the median distance of their means, mapped back to the scene's world, to
    the nearest analytic surface over their distance from the world's origin
    (the largest swings with RANSAC's per-image scale); and the largest gap
    of their scales from the mean distance to their three nearest neighbours
    among all initial means.
    ``fault`` plants one for the calibration: ``cloud_scaled`` (the cloud 2%
    too large about the origin, as an alignment 2% off) or ``knn1`` (scales
    from the nearest neighbour alone)."""
    alive = start["alive"]
    idx = torch.nonzero(alive).flatten()
    pick = idx[torch.randperm(len(idx), generator=torch.Generator().manual_seed(seed % 2**62))[:SAMPLE]]
    means = start["params"]["means"].to(dev)
    _, _, _, T = scene_cameras(scn, sc)
    inv = torch.as_tensor(np.linalg.inv(T), device=dev)
    x = means[pick.to(dev)].double()
    world = x @ inv[:3, :3].T + inv[:3, 3]
    if fault == "cloud_scaled":
        world = world * 1.02
    rel = surfaces_distance(scn, sc, world) / torch.linalg.norm(world, dim=-1).clamp(min=1.0)
    d_ref = knn_mean(means[alive.to(dev)], x)
    d_got = torch.exp(start["params"]["scales"][pick].double().to(dev)).amax(-1) / st["init_scale"]
    if fault == "knn1":
        d_got = knn_mean(means[alive.to(dev)], x, k=1)
    clamp = float(torch.exp(start["params"]["scales"][alive].double()).amax()) / st["init_scale"]
    want = torch.clamp(d_ref, max=clamp)
    return dict(init_surface_median=float(rel.median()), init_scale_gap=float(((d_got - want).abs() / want).max()))


def reference_settings(settings: dict) -> dict:
    """The configuration's settings as the reference reads them: top-level
    keys, and the strategy's under ``strategy``."""
    st = {k: v for k, v in settings.items() if "." not in k}
    st["strategy"] = {k.split(".", 1)[1]: v for k, v in settings.items() if k.startswith("strategy.")}
    return st


def bulk_diff(a: torch.Tensor, b: torch.Tensor, share: float = BULK_DROP) -> float:
    """The norm of ``a - b`` without its largest ``share`` of elements."""
    d = (a - b).double().reshape(-1) ** 2
    k = int(math.ceil(share * d.numel()))
    return float(torch.sqrt(d.sum() - torch.topk(d, k).values.sum()).clamp(min=0)) if k < d.numel() else 0.0


def step_numbers(got, ref, start, dev) -> dict:
    """The step numbers of ``got`` against the reference's ``ref``, both
    (losses, first gradient, parameters after, statistics after or None)."""
    losses, first, after, sstate = ref
    norms = {k: float(torch.linalg.norm(v.double())) for k, v in first.items()}
    med = statistics.median(norms.values())
    keep = [k for k in R.PARAM_NAMES if norms[k] >= 1e-3 * med]
    g_got = {k: got[1][k].to(dev) for k in keep}
    p0 = {k: v.to(dev) for k, v in start["params"].items()}
    out = dict(
        loss_gap=max(abs(a - b) / abs(b) for a, b in zip(got[0], losses)),
        grad_gap=norm_gaps(g_got, first, keep),
        grad_diff_bulk=statistics.median(bulk_diff(g_got[k], first[k]) / norms[k] for k in keep),
        change_gap=norm_gaps({k: got[2][k].to(dev) - p0[k] for k in keep}, {k: after[k] - p0[k] for k in keep}, keep),
    )
    if sstate is not None and got[3] is not None:
        gap = 0.0
        for k, v in sstate.items():
            b = float(torch.linalg.norm(v.double()))
            gap = max(gap, abs(float(torch.linalg.norm(got[3][k].to(dev).double())) - b) / max(b, 1e-30))
        out["stats_gap"] = gap
    return out


def with_tf32(fn):
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        return fn()
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def check(limits, bounds: dict, config: dict, scn, start, got, captured, kind, w0, seed, dev, control=None):
    """Compare the program's outputs with the reference's: every number that
    ``bounds`` gives a limit, in the order of ``bounds``."""
    st, sc = reference_settings(config["settings"]), config["scene"]
    run = lambda fault=None: follow(st, start, got["ids"], scn, sc, kind, w0, dev, fault)
    ref = run()
    scene_scale = ref[4]
    mine = (got["losses"], got["first_grad"], got["after"]["params"], got["after"]["sstate"])
    if control == "tf32":  # the reference in the program's place, one precision below
        mine = with_tf32(run)[:4]
    nums = step_numbers(mine, ref[:4], start, dev)
    if captured is not None:
        nums["strategy_gap"] = strategy_gap(st, captured, kind, scene_scale, dev, tf32=control == "tf32")
    nums.update(start_numbers(st, start, scn, sc, seed, dev))
    for name, limit in bounds.items():
        if name == "stats_gap" and kind != "default":
            continue
        limits.add(name, nums.get(name, float("nan")), limit)
    return ref, nums


def calibration(config, scn, start, got, captured, kind, w0, seed, dev) -> dict:
    """The readings the limits are set from, beside the program's own: the
    control (the reference with TF32 in the program's place) and the planted
    faults, each against the float32 reference, on this seed."""
    st, sc = reference_settings(config["settings"]), config["scene"]
    run = lambda fault=None: follow(st, start, got["ids"], scn, sc, kind, w0, dev, fault)
    full = run()
    ref = full[:4]
    out = {"control_tf32": step_numbers(with_tf32(run)[:4], ref, start, dev)}
    if captured is not None:
        out["control_tf32"]["strategy_gap"] = strategy_gap(st, captured, kind, full[4], dev, tf32=True)
    for fault in ("half_batch", "altered"):
        out[fault] = step_numbers(run(fault)[:4], ref, start, dev)
    if captured is not None:  # a refine or relocation that leaves the state as it was
        out["unchanged"] = dict(strategy_gap=strategy_gap(st, captured, kind, full[4], dev, unchanged=True))
    for fault in ("cloud_scaled", "knn1"):
        out[fault] = start_numbers(st, start, scn, sc, seed, dev, fault)
    return out

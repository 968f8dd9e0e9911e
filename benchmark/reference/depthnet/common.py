"""Helpers shared by the depth networks: the JAX package's resizes as
explicit weight matrices, random initialisation from a seed, and the
carry-across of flax variables into a module's ``state_dict``.

Resizes. ``jax.image.resize(..., "bilinear" | "bicubic")`` is separable:
one weight matrix per axis, built by ``jax_resize_matrix`` exactly as
``jax.image.scale_and_translate`` builds it (half-pixel centres, the
triangle or Keys A=-0.5 kernel, widened by 1/scale when it shrinks: it
antialiases a downscale; weights normalised per output pixel). That is
neither ``F.interpolate(mode="bilinear")`` nor ``mode="bicubic"`` (A=-0.75),
so the port applies the matrices with two matmuls. ``torch_bicubic_matrix``
is torch's own bicubic with an explicit scale factor (DINOv2's pos-embed
trick), which the JAX package also writes out as a matrix.
"""
from __future__ import annotations

import contextlib
import functools
import math
import re
from typing import Callable, Dict, Iterable, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

_EPS32 = float(np.finfo(np.float32).eps)


def torch_bicubic_matrix(n_in: int, n_out: int, scale: float) -> np.ndarray:
    """1D interpolation matrix W [n_out, n_in] matching torch
    ``F.interpolate(mode='bicubic', align_corners=False)`` with an explicit
    ``scale_factor``: src = (dst + 0.5) / scale - 0.5, cubic convolution
    kernel A = -0.75, border taps clamped (replicate)."""
    A = -0.75

    def kern(d):
        d = abs(d)
        if d <= 1.0:
            return (A + 2.0) * d**3 - (A + 3.0) * d**2 + 1.0
        if d < 2.0:
            return A * d**3 - 5.0 * A * d**2 + 8.0 * A * d - 4.0 * A
        return 0.0

    W = np.zeros((n_out, n_in), np.float64)
    for i in range(n_out):
        src = (i + 0.5) / scale - 0.5
        f = math.floor(src)
        frac = src - f
        for j in range(-1, 3):
            W[i, min(max(f + j, 0), n_in - 1)] += kern(j - frac)
    return W.astype(np.float32)


def _triangle(x):
    return np.maximum(np.float32(0), np.float32(1) - np.abs(x))


def _keys_cubic(x):
    x = np.abs(x)
    f = np.float32
    out = np.where(x >= 1, ((f(-0.5) * x + f(2.5)) * x - f(4)) * x + f(2),
                   ((f(1.5) * x - f(2.5)) * x) * x + f(1))
    return np.where(x >= 2, f(0), out)


@functools.lru_cache(maxsize=64)
def jax_resize_matrix(n_in: int, n_out: int, method: str = "linear") -> np.ndarray:
    """W [n_out, n_in] of ``jax.image.resize`` along one axis (antialiased,
    as its default is), computed in float32 step for step as JAX computes
    it. Read-only: the cache hands out the same array."""
    kernel = {"linear": _triangle, "bilinear": _triangle, "cubic": _keys_cubic,
              "bicubic": _keys_cubic}[method]
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    w = kernel(np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) / kernel_scale).astype(f32)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * _EPS32, w / np.where(total != 0, total, f32(1)), f32(0))
    w = np.where(((sample >= -0.5) & (sample <= n_in - 0.5))[None, :], w, f32(0))
    out = np.ascontiguousarray(w.T, dtype=f32)
    out.flags.writeable = False
    return out


def resize(x: torch.Tensor, hw: Tuple[int, int], method: str = "linear") -> torch.Tensor:
    """``jax.image.resize`` over the last two axes of ``x`` [..., H, W]; an
    axis whose size does not change is left as it is, as JAX leaves it."""
    h, w = x.shape[-2:]
    H, W = hw
    if H != h:
        wh = torch.tensor(jax_resize_matrix(h, H, method), device=x.device, dtype=x.dtype)
        x = torch.matmul(wh, x)
    if W != w:
        ww = torch.tensor(jax_resize_matrix(w, W, method), device=x.device, dtype=x.dtype)
        x = torch.matmul(x, ww.T)
    return x


def resize_align_corners(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear with align_corners=True on [B, C, H, W] (the DPT heads'
    ``interpolate``; the JAX package writes it out as two lerps)."""
    if tuple(x.shape[-2:]) == tuple(hw):
        return x
    return F.interpolate(x, size=tuple(hw), mode="bilinear", align_corners=True)


@contextlib.contextmanager
def full_fp32():
    """Matmuls and cuDNN convolutions in full float32 (no TF32) inside the
    block; the settings are restored on exit."""
    mm, cd = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd


@contextlib.contextmanager
def without_cudnn():
    """Convolutions inside the block skip cuDNN (PyTorch's own CUDA
    convolution: im2col and a cuBLAS GEMM); the setting is restored on exit."""
    enabled = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = False
    try:
        yield
    finally:
        torch.backends.cudnn.enabled = enabled


# Parameters flax starts at zero (initializers.zeros).
_ZERO_PARAMS = ("cls_token", "register_tokens")


def build(cls: Callable[..., nn.Module], *args, **kwargs) -> nn.Module:
    """Construct a module without running PyTorch's own initialisers (its
    parameters are uninitialised CPU memory until ``init_random_`` or a
    checkpoint fills every one of them)."""
    with torch.device("meta"):
        module = cls(*args, **kwargs)
    return module.to_empty(device="cpu")


@torch.no_grad()
def init_random_(module: nn.Module, seed: int) -> nn.Module:
    """Random weights from ``seed``, drawn on the CPU in parameter order, so
    the same seed gives the same weights whatever device the module goes to.
    The distributions are flax's defaults: weights normal with variance
    1/fan_in (fan_in over the input channels and the kernel window), biases
    0, norm scales and LayerScale 1, position embeddings normal(0, 0.02),
    class and register tokens 0."""
    g = torch.Generator().manual_seed(int(seed))
    for mod in module.modules():
        for name, p in mod.named_parameters(recurse=False):
            if name in _ZERO_PARAMS or name == "bias":
                p.zero_()
            elif name == "pos_embed":
                p.normal_(0.0, 0.02, generator=g)
            elif p.ndim == 1:  # LayerNorm weight, LayerScale gamma
                p.fill_(1.0)
            else:
                if isinstance(mod, nn.ConvTranspose2d):  # weight [in, out, kh, kw]
                    fan_in = p.shape[0] * p.shape[2] * p.shape[3]
                else:  # Linear [out, in], Conv2d [out, in, kh, kw]
                    fan_in = int(np.prod(p.shape[1:]))
                p.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=g)
    return module


# --------------------------------------------------- flax variables -> torch

Rename = Tuple[str, Union[str, Callable[[re.Match], str]]]


def carry_plan(
    variables: dict, renames: Iterable[Rename] = (), transposed: Sequence[str] = ()
) -> Dict[str, Tuple[object, Tuple[int, ...], bool]]:
    """How a network's flax variables (nested dicts, ``{"params": ...}`` or
    the params themselves) map onto its torch ``state_dict``: torch name ->
    (the flax leaf, the axis permutation to apply, whether to flip the two
    spatial axes first). Each flax module path ("a/b_0/c") goes through
    ``renames`` (regex, replacement; in order) and its "/" become "."; leaves
    map as ``kernel`` -> ``weight`` (Dense [in, out] transposed, Conv HWIO
    to OIHW, ConvTranspose, for module paths matching a pattern of
    ``transposed``, flipped and HWIO to IOHW: the flax op correlates with
    the flipped kernel), ``scale`` -> ``weight``, anything else by name.
    The leaves are not read, so they may be shapes only."""
    renames = tuple(renames)
    plan = {}

    def walk(d, path):
        for key, val in d.items():
            if isinstance(val, dict):
                walk(val, path + [key])
                continue
            mod = "/".join(path)
            name = mod
            for pat, rep in renames:
                name = re.sub(pat, rep, name)
            ndim = len(val.shape)
            perm, flip, leaf = tuple(range(ndim)), False, key
            if key == "kernel":
                leaf = "weight"
                if ndim == 2:
                    perm = (1, 0)
                elif any(re.fullmatch(p, mod) for p in transposed):
                    perm, flip = (2, 3, 0, 1), True
                else:
                    perm = (3, 2, 0, 1)
            elif key == "scale":
                leaf = "weight"
            full = f"{name}/{leaf}" if name else leaf
            plan[full.replace("/", ".")] = (val, perm, flip)

    walk(variables.get("params", variables), [])
    return plan


def state_dict_from_flax(
    variables: dict, renames: Iterable[Rename] = (), transposed: Sequence[str] = ()
) -> Dict[str, torch.Tensor]:
    """The torch ``state_dict`` of a network whose flax variables (numpy or
    JAX arrays) are given; see ``carry_plan`` for the mapping."""
    out = {}
    for name, (leaf, perm, flip) in carry_plan(variables, renames, transposed).items():
        a = np.asarray(leaf, np.float32)
        if flip:
            a = a[::-1, ::-1]
        out[name] = torch.tensor(np.ascontiguousarray(a.transpose(perm)))
    return out


def load_checked(module: nn.Module, state_dict: dict, what: str) -> nn.Module:
    """Load the module's parameters from ``state_dict`` (torch tensors or
    numpy arrays), raising ValueError if any is missing or has another
    shape. Keys the module does not have are ignored (checkpoints carry
    parameters the inference graph never reads, e.g. DINOv2's mask token)."""
    want = module.state_dict()
    missing = sorted(k for k in want if k not in state_dict)
    bad = {
        k: (tuple(state_dict[k].shape), tuple(want[k].shape))
        for k in want if k in state_dict and tuple(state_dict[k].shape) != tuple(want[k].shape)
    }
    if missing or bad:
        raise ValueError(
            f"{what} checkpoint mismatch: missing={missing[:8]} "
            f"shape_mismatch={dict(list(bad.items())[:8])}"
        )
    module.load_state_dict({k: torch.as_tensor(state_dict[k], dtype=torch.float32) for k in want})
    return module

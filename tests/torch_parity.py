"""Shared helpers for the port's parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages: JAX
arrays on one side, CPU torch tensors on the other. The JAX compositor runs
its Pallas kernels in interpret mode with the f32 wire (``wire8=False``)
and the f32 gradient-record sort (``sort_bf16=False``), so both sides run
the same algorithm.
"""
from __future__ import annotations

import numpy as np
import torch

torch.set_num_threads(2)  # tier-1 runs several pytest workers per box

W, H = 64, 48
CPU = torch.device("cpu")


def t(x, dtype=torch.float32) -> torch.Tensor:
    """numpy (or JAX) array -> CPU torch tensor."""
    return torch.as_tensor(np.array(x), dtype=dtype)


def n(x) -> np.ndarray:
    """torch tensor or JAX array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def scene(rng: np.random.Generator, n_g: int = 48, width: int = W, height: int = H):
    """Random gaussians in front of an identity camera (float32 numpy)."""
    f = 0.9 * width
    K = np.array([[f, 0, width / 2], [0, f, height / 2], [0, 0, 1]], np.float32)
    means = np.stack(
        [
            rng.uniform(-0.7, 0.7, n_g),
            rng.uniform(-0.5, 0.5, n_g),
            rng.uniform(1.0, 4.0, n_g),
        ],
        -1,
    ).astype(np.float32)
    return dict(
        means=means,
        quats=rng.normal(size=(n_g, 4)).astype(np.float32),
        scales=rng.uniform(0.02, 0.2, (n_g, 3)).astype(np.float32),
        opacities=rng.uniform(0.3, 0.95, n_g).astype(np.float32),
        colors=rng.uniform(0, 1, (n_g, 3)).astype(np.float32),
        viewmats=np.eye(4, dtype=np.float32)[None],
        Ks=K[None],
    )


def deep_stack(rng: np.random.Generator, n_g: int = 96):
    """A deep stack like tests/test_rasterize_pallas.py's: 96 gaussians at
    opacity 0.95 stacked in depth, wide enough (scale 1.0) that whole
    16-pixel tiles saturate and stop before their last chunk."""
    means = np.zeros((n_g, 3), np.float32)
    means[:, 0] = rng.uniform(-0.1, 0.1, n_g)
    means[:, 1] = rng.uniform(-0.1, 0.1, n_g)
    means[:, 2] = np.linspace(2.0, 6.0, n_g)
    K = np.array([[50.0, 0, W / 2], [0, 50.0, H / 2], [0, 0, 1]], np.float32)
    return dict(
        means=means,
        quats=np.tile(np.array([1, 0, 0, 0], np.float32), (n_g, 1)),
        scales=np.full((n_g, 3), 1.0, np.float32),
        opacities=np.full((n_g,), 0.95, np.float32),
        colors=rng.uniform(0, 1, (n_g, 3)).astype(np.float32),
        viewmats=np.eye(4, dtype=np.float32)[None],
        Ks=K[None],
    )


def assert_close_scaled(got, want, atol, err_msg=""):
    """|got - want| <= atol * max|want| elementwise (normalised tolerance
    for gradients whose magnitudes span many decades)."""
    got, want = n(got), n(want)
    scale = float(np.abs(want).max()) + 1e-12
    np.testing.assert_allclose(got / scale, want / scale, atol=atol, rtol=0, err_msg=err_msg)


def jax_hypotheses(key, valid, num_hyp: int, sample_size: int = 4) -> np.ndarray:
    """The JAX package's RANSAC sample indices [num_hyp, sample_size]
    (``gs_init_tpu/mdi/alignment/ransac.py``'s ``sample_idx``), rebuilt call
    for call so the port's RANSAC can be given the same hypotheses."""
    import jax
    import jax.numpy as jnp

    logits = jnp.where(jnp.asarray(valid), 0.0, -jnp.inf)
    keys = jax.random.split(key, num_hyp)
    draw = lambda k: jax.random.categorical(k, logits, shape=(sample_size,))
    return np.array(jax.vmap(draw)(keys))



def random_flax_variables(module, *args, seed: int = 0) -> dict:
    """Random variables for a flax ``module`` as nested dicts of numpy
    arrays (the form the port's ``state_dict_from_flax`` functions take).
    Shapes come from ``jax.eval_shape`` of its init, values from numpy (far
    quicker than running flax's initialisers op by op): kernels normal with
    variance 1/fan_in, biases normal(0, 0.1), norm scales and LayerScale
    1 + normal(0, 0.1), tokens and position embeddings normal(0, 1). No
    zero bias and no unit scale, so every leaf's carry-across shows."""
    import flax.linen as fnn
    import jax

    # The base class's init: a test may have replaced the net class's own.
    shapes = jax.eval_shape(lambda: fnn.Module.init(module, jax.random.PRNGKey(0), *args))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = path[-1].key
        if name == "kernel":
            x = rng.normal(0.0, 1.0 / np.sqrt(np.prod(s.shape[:-1])), s.shape)
        elif name in ("scale", "gamma"):
            x = 1.0 + rng.normal(0.0, 0.1, s.shape)
        elif name == "bias":
            x = rng.normal(0.0, 0.1, s.shape)
        else:
            x = rng.normal(0.0, 1.0, s.shape)
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def carry(module: torch.nn.Module, state_dict: dict) -> torch.nn.Module:
    """Load a carried-across state dict into ``module``, every parameter
    present and nothing left over, and put it in eval mode."""
    module.load_state_dict(state_dict, strict=True)
    return module.eval()

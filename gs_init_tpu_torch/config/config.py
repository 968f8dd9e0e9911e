"""Configuration — the port's own copy of ``gs_init_tpu/config/config.py``.

``Config`` and ``DefaultStrategyConfig`` keep the JAX package's field
names and defaults so a configuration carries over. This slice runs the
default training path; ``check_slice`` raises on settings that select code
not yet ported, naming the slice that brings it.

TPU-only knobs are accepted and have no effect here: the port always uses
the f32 16-column pair table and f32 gradient sums (``wire8``,
``sort_bf16``), has no table reordering (``reorder_table``), and is
always packed (``packed``, ``sparse_grad``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import List, Literal, Optional, Tuple


@dataclass(eq=False)
class DefaultStrategyConfig:
    """Grow/split/prune densification from screen-space gradient statistics."""

    name: Literal["default"] = "default"
    grow_grad2d: float = 0.0002
    grow_scale3d: float = 0.01
    grow_scale2d: float = 0.05
    prune_opa: float = 0.005
    prune_scale3d: float = 0.1
    prune_scale2d: float = 0.15
    refine_scale2d_stop_iter: int = 0
    refine_start_iter: int = 500
    refine_stop_iter: int = 15_000
    reset_every: int = 3000
    refine_every: int = 100
    pause_refine_after_reset: int = 0
    absgrad: bool = False
    revised_opacity: bool = False
    verbose: bool = False


@dataclass(eq=False)
class Config:
    # Data
    data_dir: str = "data/360_v2/garden"
    data_factor: int = 4
    result_dir: str = "results/garden"
    test_every: int = 8
    patch_size: Optional[int] = None
    global_scale: float = 1.0
    normalize_world_space: bool = True
    camera_model: Literal["pinhole", "ortho", "fisheye"] = "pinhole"
    data_prefetch: int = 2  # the port's Runner loads batches synchronously
    image_cache_gb: float = 2.0

    # Init
    init_type: Literal["sfm", "random", "monocular_depth"] = "sfm"
    init_num_pts: int = 100_000
    init_extent: float = 3.0
    init_opa: float = 0.1
    init_scale: float = 1.0
    # Monocular-depth init settings (JAX MonocularDepthInitConfig) arrive
    # with the mdi slice; None until then.
    mdi: Optional[object] = None

    # Training schedule
    max_steps: int = 30_000
    eval_steps: List[int] = field(default_factory=lambda: [7_000, 30_000])
    save_steps: List[int] = field(default_factory=lambda: [7_000, 30_000])
    save_ply: bool = False
    save_predictions: bool = False
    ply_steps: List[int] = field(default_factory=lambda: [7_000, 30_000])
    steps_scaler: float = 1.0

    batch_size: int = 1
    # Loss
    ssim_lambda: float = 0.2
    opacity_reg: float = 0.0
    scale_reg: float = 0.0
    depth_loss: bool = False
    depth_lambda: float = 1e-2
    random_bkgd: bool = False
    background_color: Optional[Tuple[float, float, float]] = None

    # Model
    sh_degree: int = 3
    sh_degree_interval: int = 1000
    max_gaussians: int = 1_000_000  # capacity buffer
    near_plane: float = 0.01
    far_plane: float = 1e10
    antialiased: bool = False
    packed: bool = True
    sparse_grad: bool = False

    # Rasterizer
    tile_size: int = 32
    pair_capacity: int = 4_194_304
    # Grow pair_capacity when pairs overflow it (the port's Runner grows;
    # the JAX Runner also shrinks, which recompiles there).
    auto_pair_capacity: bool = True
    chunk_size: int = 128
    reorder_table: bool = False
    sort_bf16: bool = True
    wire8: bool = True
    rasterizer_impl: Literal["auto", "pallas", "xla"] = "auto"

    # Devices
    mesh: str = "auto"
    shard_pixels: bool = False

    # Learning rates
    means_lr: float = 1.6e-4
    scales_lr: float = 5e-3
    opacities_lr: float = 5e-2
    quats_lr: float = 1e-3
    sh0_lr: float = 2.5e-3
    shN_lr: float = 2.5e-3 / 20

    # Pose optimization
    pose_opt: bool = False
    pose_opt_lr: float = 1e-5
    pose_opt_reg: float = 1e-6
    pose_noise: float = 0.0

    # Appearance optimization
    app_opt: bool = False
    app_embed_dim: int = 16
    app_opt_lr: float = 1e-3
    app_opt_reg: float = 1e-6
    app_test_opt_steps: int = 128
    app_test_opt_lr: float = 0.1
    use_bilateral_grid: bool = False
    bilateral_grid_shape: Tuple[int, int, int] = (16, 16, 8)
    tv_lambda: float = 10.0

    # Strategy
    strategy: object = field(default_factory=DefaultStrategyConfig)

    # Eval / render
    lpips_net: Literal["alex", "vgg"] = "alex"
    render_traj_path: Literal["interp", "ellipse_z", "ellipse_y", "spiral"] = "interp"
    compression: Optional[Literal["quantized", "png"]] = None

    # Logging / infra
    disable_viewer: bool = True
    non_blocking_viewer: bool = False
    port: int = 8080
    tb_every: int = 100
    profile_start: int = -1
    profile_steps: int = 3
    tb_save_image: bool = False
    ckpt: Optional[List[str]] = None
    seed: int = 42
    data_parallel: int = 1
    gaussian_shards: int = 1


# (condition, what it selects, the ROADMAP queue entry that ports it)
_LATER = (
    (lambda c: c.init_type == "monocular_depth", "monocular-depth init", "the mdi slice"),
    (lambda c: not isinstance(c.strategy, DefaultStrategyConfig), "the MCMC strategy", "the MCMC/aux slice"),
    (lambda c: c.pose_opt or c.pose_noise > 0, "pose optimization", "the MCMC/aux slice"),
    (lambda c: c.app_opt, "appearance optimization", "the MCMC/aux slice"),
    (lambda c: c.use_bilateral_grid, "the bilateral grid", "the MCMC/aux slice"),
    (lambda c: c.rasterizer_impl == "xla", "the dense rasterizer oracle", "the rasterize_ref slice"),
    (lambda c: c.patch_size, "random patch crops", "the eval/integration slice"),
    (lambda c: c.ckpt, "checkpoint loading", "the checkpoint slice"),
    (lambda c: c.save_ply, "PLY export", "the eval/integration slice"),
    (lambda c: c.compression is not None, "splat compression", "the eval/integration slice"),
    (lambda c: not c.disable_viewer, "the live viewer", "the eval/integration slice"),
    (lambda c: c.profile_start >= 0, "profiler capture", "the eval/integration slice"),
    (
        lambda c: c.data_parallel > 1 or c.gaussian_shards > 1 or c.shard_pixels
        or c.mesh not in ("auto", "off", "1x1"),
        "multi-device training", "the multi-GPU slice",
    ),
)


def check_slice(cfg: Config) -> None:
    """Raise NotImplementedError on settings this slice does not run."""
    for cond, what, later in _LATER:
        if cond(cfg):
            raise NotImplementedError(
                f"{what} is not ported to gs_init_tpu_torch yet ({later} in ROADMAP.md)"
            )


def to_dict(cfg) -> dict:
    """Recursively convert a config dataclass to a plain dict."""
    if dataclasses.is_dataclass(cfg) and not isinstance(cfg, type):
        return {f.name: to_dict(getattr(cfg, f.name)) for f in dataclasses.fields(cfg)}
    if isinstance(cfg, (list, tuple)):
        return [to_dict(v) for v in cfg]
    return cfg

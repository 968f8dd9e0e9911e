"""Configuration — the port's own copy of ``gs_init_tpu/config/config.py``.

``Config``, ``DefaultStrategyConfig`` and the monocular-depth-init
dataclasses (``MonocularDepthInitConfig`` and the ones it nests) keep the
JAX package's field names and defaults so a configuration carries over.
``MCMCStrategyConfig`` too. The port runs both strategies from SfM, random
or monocular-depth init (any of the five depth networks or the stub
predictor), with pose / appearance / bilateral-grid optimisation, patch
crops, checkpoints, PLY export, compression, the profiler window, the live
viewer, SAM segmentation and the init-cloud export, on one GPU or on a
multi-GPU mesh (``mesh``, ``shard_pixels``). ``data_parallel`` keeps its
only JAX meaning, a learning-rate batch factor (``engine/optim.py``);
``gaussian_shards`` is read nowhere, in either package. ``trace`` is the
port's own: its spans and counters (``trace.py``).

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
class MCMCStrategyConfig:
    """MCMC relocation densification (stochastic gaussian langevin moves)."""

    name: Literal["mcmc"] = "mcmc"
    cap_max: int = 1_000_000
    noise_lr: float = 5e5
    refine_start_iter: int = 500
    refine_stop_iter: int = 25_000
    refine_every: int = 100
    min_opacity: float = 0.005
    verbose: bool = False


@dataclass(eq=False)
class RansacConfig:
    inlier_threshold: float = 0.01
    max_iterations: int = 2500
    confidence: float = 0.999
    sample_size: int = 4
    # Accepted for configuration parity: every max_iterations hypothesis is
    # evaluated in one batch, so neither adaptive termination nor its floor
    # nor a batch size applies.
    min_iterations: int = 0
    hypothesis_batch: int = 256


@dataclass(eq=False)
class InterpolatedAlignmentConfig:
    prealign: Literal["ransac", "msac", "lstsqrs"] = "ransac"
    method: Literal["rbf", "delaunay"] = "delaunay"
    rbf_grid_width: int = 256
    scale_outlier_removal: bool = True
    smoothing: float = 0.001
    kernel: str = "thin_plate_spline"  # the only kernel ops/rbf.py has
    max_rbf_points: int = 5000  # cap on the dense O(M^3) TPS solve (-1 = all)
    lof_neighbors: int = 20
    lof_threshold: float = 1.5
    knn_median_neighbors: int = 8
    knn_median_threshold: float = 2.0


@dataclass(eq=False)
class SegmentationConfig:
    method: Optional[Literal["slic", "sam"]] = None
    slic_n_segments: int = 40
    slic_compactness: float = 0.01
    merge_gradient_threshold: float = 5e-4
    merge_min_sfm_points: int = 5
    region_margin: float = 10.0  # scaled by max(H, W) / 1297 at use
    propagate_mask: bool = False
    sam_variant: Literal["vit_b", "vit_l", "vit_h"] = "vit_h"
    sam_img_size: int = 1024
    sam_allow_random_weights: bool = False
    sam_use_normals: bool = True
    sam_degenerate_mask_thresh: float = 0.9
    sam_expansion_radius: int = 4
    sam_tiny_region_area_fraction: float = 1e-4


@dataclass(eq=False)
class DepthAlignmentConfig:
    method: Literal["lstsqrs", "ransac", "msac", "interpolate"] = "ransac"
    ransac: RansacConfig = field(default_factory=RansacConfig)
    interp: InterpolatedAlignmentConfig = field(default_factory=InterpolatedAlignmentConfig)
    segmentation: SegmentationConfig = field(default_factory=SegmentationConfig)
    # Images whose SfM points reproject validly below this fraction are skipped.
    min_valid_sfm_fraction: float = 0.25


@dataclass(eq=False)
class AdaptiveSubsamplingConfig:
    min_stride: int = 5
    max_stride: int = 15


@dataclass(eq=False)
class SfmPointsMaskConfig:
    enabled: bool = True
    patches_per_image_side: int = 20
    max_sfm_points_per_patch: int = 15


@dataclass(eq=False)
class DepthSubsamplingConfig:
    method: Literal["static", "adaptive"] = "static"
    factor: int = 10
    adaptive: AdaptiveSubsamplingConfig = field(default_factory=AdaptiveSubsamplingConfig)
    sfm_mask: SfmPointsMaskConfig = field(default_factory=SfmPointsMaskConfig)


@dataclass(eq=False)
class PointCloudPostprocessConfig:
    lof_outlier_removal: bool = False
    lof_neighbors: int = 40
    merge_subsample: bool = False
    merge_max_aspect_ratio: float = 1.1
    merge_extent_multiplier: float = 1.0
    merge_impl: Literal["native", "voxel"] = "native"


@dataclass(eq=False)
class MonocularDepthInitConfig:
    predictor: Literal[
        "stub", "depth_anything_v2", "metric3d", "moge", "unidepth", "depth_pro",
    ] = "metric3d"
    backbone: str = "vitl"
    metric: bool = True
    metric_variant: Literal["indoor", "outdoor"] = "indoor"
    alignment: DepthAlignmentConfig = field(default_factory=DepthAlignmentConfig)
    subsampling: DepthSubsamplingConfig = field(default_factory=DepthSubsamplingConfig)
    postprocess: PointCloudPostprocessConfig = field(default_factory=PointCloudPostprocessConfig)
    depth_gradient_mask: bool = False
    depth_gradient_threshold: float = 0.1
    include_sfm_points: bool = True
    noise_frac: float = 0.0
    # PLY export of the init cloud (pts_only exits after the write).
    pts_only: bool = False
    export_ply: bool = False
    pts_output_dir: Optional[str] = None
    pts_output_per_image: bool = False
    cache_dir: str = "__mono_depth_cache__"
    use_cache: bool = True
    scale_clamp_quantile: float = 0.0
    allow_random_weights: bool = False
    # Images per predictor call (one batch on the card); the stub predicts one at a time.
    predict_batch_size: int = 1


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
    data_prefetch: int = 2  # batches built this far ahead on a thread (0: in the loop)
    image_cache_gb: float = 2.0

    # Init
    init_type: Literal["sfm", "random", "monocular_depth"] = "sfm"
    init_num_pts: int = 100_000
    init_extent: float = 3.0
    init_opa: float = 0.1
    init_scale: float = 1.0
    mdi: MonocularDepthInitConfig = field(default_factory=MonocularDepthInitConfig)

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
    # Retune pair_capacity from observed pair counts: grow on overflow,
    # shrink when it is far too large (the eager step reads it per call).
    auto_pair_capacity: bool = True
    chunk_size: int = 128
    reorder_table: bool = False
    sort_bf16: bool = True
    wire8: bool = True
    rasterizer_impl: Literal["auto", "pallas", "xla"] = "auto"

    # Devices: "auto" (every process of a multi-GPU launch; one device
    # otherwise), "off" (one device) or "DxG" (data x gauss ranks).
    # shard_pixels shards tile-row bands of each image over the data axis
    # in place of cameras (parallel/shard.py).
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
    # Spans and counters (trace.py) over the run, reported to
    # <result_dir>/stats/trace.json; off, they cost a flag check.
    trace: bool = False
    tb_save_image: bool = False
    ckpt: Optional[List[str]] = None
    seed: int = 42
    data_parallel: int = 1  # learning-rate batch factor only (engine/optim.py)
    gaussian_shards: int = 1  # read nowhere, as in the JAX package

    def adjust_steps(self, factor: Optional[float] = None) -> None:
        """Scale every step schedule by ``steps_scaler`` (or ``factor``),
        the strategy's refine schedule included."""
        f = self.steps_scaler if factor is None else factor
        if f == 1.0:
            return
        self.eval_steps = [int(s * f) for s in self.eval_steps]
        self.save_steps = [int(s * f) for s in self.save_steps]
        self.ply_steps = [int(s * f) for s in self.ply_steps]
        self.max_steps = int(self.max_steps * f)
        self.sh_degree_interval = int(self.sh_degree_interval * f)
        s = self.strategy
        if isinstance(s, DefaultStrategyConfig):
            s.refine_start_iter = int(s.refine_start_iter * f)
            s.refine_stop_iter = int(s.refine_stop_iter * f)
            s.reset_every = int(s.reset_every * f)
            s.refine_every = int(s.refine_every * f)
        elif isinstance(s, MCMCStrategyConfig):
            s.refine_start_iter = int(s.refine_start_iter * f)
            s.refine_stop_iter = int(s.refine_stop_iter * f)
            s.refine_every = int(s.refine_every * f)
        else:
            raise ValueError(f"unknown strategy {s!r}")


def to_dict(cfg) -> dict:
    """Recursively convert a config dataclass to a plain dict."""
    if dataclasses.is_dataclass(cfg) and not isinstance(cfg, type):
        return {f.name: to_dict(getattr(cfg, f.name)) for f in dataclasses.fields(cfg)}
    if isinstance(cfg, (list, tuple)):
        return [to_dict(v) for v in cfg]
    return cfg

from .cli import apply_overrides, parse_cli
from .config import (
    AdaptiveSubsamplingConfig,
    Config,
    DefaultStrategyConfig,
    DepthAlignmentConfig,
    DepthSubsamplingConfig,
    InterpolatedAlignmentConfig,
    MCMCStrategyConfig,
    MonocularDepthInitConfig,
    PointCloudPostprocessConfig,
    RansacConfig,
    SegmentationConfig,
    SfmPointsMaskConfig,
    to_dict,
)

__all__ = [
    "AdaptiveSubsamplingConfig",
    "Config",
    "DefaultStrategyConfig",
    "DepthAlignmentConfig",
    "DepthSubsamplingConfig",
    "InterpolatedAlignmentConfig",
    "MCMCStrategyConfig",
    "MonocularDepthInitConfig",
    "PointCloudPostprocessConfig",
    "RansacConfig",
    "SegmentationConfig",
    "SfmPointsMaskConfig",
    "apply_overrides",
    "parse_cli",
    "to_dict",
]

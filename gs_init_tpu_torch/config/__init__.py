from .config import (
    Config,
    DefaultStrategyConfig,
    check_slice,
    to_dict,
)

__all__ = [
    "Config",
    "DefaultStrategyConfig",
    "check_slice",
    "to_dict",
]

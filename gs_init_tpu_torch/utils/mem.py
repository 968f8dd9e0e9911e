"""Device memory statistics over ``torch.cuda.memory_stats`` — port of
``gs_init_tpu/utils/mem.py``. On the CPU they are empty, as the JAX
package's are where the backend keeps no statistics."""
from __future__ import annotations

import logging

import torch

_LOGGER = logging.getLogger(__name__)


def device_memory_stats(device=None) -> dict:
    """bytes_in_use / peak / limit of a CUDA device; {} on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return {}
    stats = torch.cuda.memory_stats(dev)
    return {
        "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
        "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
        "bytes_limit": torch.cuda.get_device_properties(dev).total_memory,
    }


def format_memory_stats(device=None) -> str:
    s = device_memory_stats(device)
    if not s:
        return "device memory stats unavailable"
    gb = 1024**3
    return (
        f"in_use {s['bytes_in_use'] / gb:.2f}GB / "
        f"peak {s['peak_bytes_in_use'] / gb:.2f}GB / "
        f"limit {s['bytes_limit'] / gb:.2f}GB"
    )


def log_memory(tag: str = "", device=None) -> None:
    _LOGGER.info("[mem]%s %s", f" {tag}" if tag else "", format_memory_stats(device))

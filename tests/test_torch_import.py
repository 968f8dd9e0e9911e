"""The port stands alone: importing every module of ``gs_init_tpu_torch``
loads neither JAX nor anything of ``gs_init_tpu``, no source file of the
port (nor ``chip_smoke.py`` or ``chip_measure.py``) imports them, and the entry points default to
the card, raising where there is none rather than running on the CPU."""
import pathlib
import re
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(2)  # tier-1 runs several pytest workers per box

REPO = pathlib.Path(__file__).resolve().parents[1]
PKG = REPO / "gs_init_tpu_torch"
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|gs_init_tpu)(\.|\s|$)", re.M)

PROBE = """
import importlib, pkgutil, sys
import gs_init_tpu_torch
names = [m.name for m in pkgutil.walk_packages(gs_init_tpu_torch.__path__, "gs_init_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "gs_init_tpu"))
print(len(names), bad)
"""


def test_fresh_import_loads_no_jax():
    res = subprocess.run(
        [sys.executable, "-c", PROBE], cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stderr
    count, bad = res.stdout.strip().split(" ", 1)
    assert int(count) >= 20, res.stdout  # every subpackage was walked
    assert bad == "[]", bad


def test_ops_package_imports_its_submodules():
    """As ``gs_init_tpu/ops/__init__.py``: ``import gs_init_tpu_torch.ops``
    alone makes ``ops.sh``, ``ops.projection`` and ``ops.rasterize_ref``
    resolve."""
    probe = ("import gs_init_tpu_torch.ops as ops; "
             "print(ops.sh.__name__, ops.projection.__name__, ops.rasterize_ref.__name__)")
    res = subprocess.run([sys.executable, "-c", probe], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == [f"gs_init_tpu_torch.ops.{m}" for m in ("sh", "projection", "rasterize_ref")]


@pytest.mark.parametrize(
    "path",
    sorted(str(p.relative_to(REPO)) for p in PKG.rglob("*.py")) + ["chip_smoke.py", "chip_measure.py"],
)
def test_source_imports_neither_jax_nor_reference(path):
    assert not FORBIDDEN.search((REPO / path).read_text()), path


def test_entry_points_default_to_cuda(monkeypatch):
    from gs_init_tpu_torch.datasets.synthetic import make_scene
    from gs_init_tpu_torch.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_scene(n_gaussians=4, n_cams=1)
    assert resolve_device("cpu") == torch.device("cpu")

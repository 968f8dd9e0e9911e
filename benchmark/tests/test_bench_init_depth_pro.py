"""The Depth Pro init cell (``harness/init_depth_pro.py``) on the CPU at a
tiny size: it runs and comes out correct with its metrics, its traced run
reads the stages the CPU can give, and faults planted in the port come out
not correct by ``inv_gap``. Depth Pro is cut to a narrow network here
(``tiny_depth_pro.py``: width 64, 4 blocks, 64-px crops of a 256 input; the
published widths at 1536 are for the card). Run from the repository's root:

    python -m pytest benchmark/tests/test_bench_init_depth_pro.py -q
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import tiny  # noqa: E402
import tiny_depth_pro  # noqa: E402

CELL = "tiny-garden-depthpro.init"


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    root = tiny.make_copy(str(tmp_path_factory.mktemp("bench")), cells=("garden-depthpro.init",))
    path = os.path.join(root, "benchmark", "configs", "tiny-garden-depthpro.json")
    with open(path) as f:
        c = json.load(f)
    c["depth_pro"].update(tiny_depth_pro.group())
    c["argv"].remove("--mdi.backbone=vits")  # Depth Pro takes no backbone: the default stays
    c["settings"]["mdi.backbone"] = "vitl"
    with open(path, "w") as f:
        json.dump(c, f)
    return root


def run(root, fault="none", seed=7, trace=0, extra=()):
    cmd = [sys.executable, "-c", "import tiny_depth_pro; tiny_depth_pro.main()", fault, "--workload", CELL,
           "--seed", str(seed), "--seconds", "1", "--trace", str(trace), "--device", "cpu", *extra]
    env = dict(os.environ, PYTHONPATH=HERE, JAX_PLATFORMS="cpu")
    proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True, timeout=900, env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1]), proc.stderr


def test_cell_end_to_end(checkout):
    out, err = run(checkout, seed=2**31 + 37, extra=("--calibrate",))
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {"setup_s", "init_s_per_image"}
    assert set(out["checks"]) == {"inv_gap", "depth_gap", "align_gap", "mask_mismatch", "points_gap", "rgb_gap"}
    assert 0 < out["checks"]["inv_gap"]["value"] < 1e-5
    cal = json.loads(next(ln for ln in err.splitlines() if ln.startswith("calibration "))[len("calibration "):])
    assert cal["faults"]["merge_no_crop"]["inv_gap"] > 1e-2 and cal["faults"]["hooks_swapped"]["inv_gap"] > 1e-2
    assert "relu_zeroed" in err and "at_clip" in err


def test_traced_cell_reads_its_stages(checkout):
    """The traced line holds the predict and alignment seconds an image; the
    device times, the shares of the peak and the idle share need the card."""
    out, _ = run(checkout, seed=5, trace=1)
    m = out["metrics"]
    assert set(m) == {"init.predict_s", "init.align_unproject_s"}
    assert all(v["value"] > 0 for v in m.values())


@pytest.mark.parametrize("fault", ["merge_no_crop", "hooks_swapped"])
def test_fault_is_not_correct(checkout, fault):
    out, _ = run(checkout, fault=fault, seed=9)
    assert out["correct"] is False
    assert out["checks"]["inv_gap"]["value"] > out["checks"]["inv_gap"]["limit"]

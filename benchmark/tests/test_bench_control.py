"""The control of each cell's check, on the card at a tiny size: the plain
reference computed with TF32 matmuls and convolutions (the precision below
the configurations' float32) stands in for the program, and the check has to
come out not correct. On the cells' own sizes the control's readings are in
PERF.md (``run.py --calibrate``)."""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import tiny  # noqa: E402


@pytest.mark.card
@pytest.mark.parametrize("cell,number", [
    ("garden-default.train", "grad_diff_bulk"), ("garden-mcmc.train", "grad_diff_bulk"),
    ("garden-default.init", "depth_gap"),
])
def test_control_is_not_correct(card, tmp_path, cell, number):
    root = tiny.make_copy(str(tmp_path), cells=(cell,))
    cmd = [sys.executable, "benchmark/run.py", "--workload", "tiny-" + cell, "--seed", "2147483701",
           "--seconds", "2", "--trace", "0", "--control", "tf32"]
    proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True, timeout=900, env=dict(os.environ))
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] is False
    assert out["checks"][number]["value"] > out["checks"][number]["limit"]

"""``chip_measure.py trace-probe`` rehearsed on the CPU over a tiny copy of
a benchmark cell: windows with the port's tracer off and on in turns, the
readings of the traced windows, and its report written with every window's
spans."""
import json
import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "benchmark" / "tests"))
import tiny  # noqa: E402


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return tiny.make_copy(str(tmp_path_factory.mktemp("probe")), cells=("garden-default.train", "garden-mcmc.train"))


@pytest.mark.parametrize("cell", ["garden-default.train", "garden-mcmc.train"])
def test_trace_probe_rehearses_a_tiny_cell(cell, checkout, tmp_path):
    workload = "tiny-" + cell
    cmd = [sys.executable, "chip_measure.py", "trace-probe", "--workload", workload, "--seed", "2147483713",
           "--device", "cpu", "--root", checkout, "--out", str(tmp_path), "--window", "0.2", "--turns", "1"]
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=600,
                          env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    summary = json.loads(next(x for x in lines if x.startswith("SUMMARY "))[len("SUMMARY "):])
    assert summary["workload"] == workload and len(summary["off"]) == len(summary["on"]) == 2
    assert "cost_pct" in summary
    with open(tmp_path / f"probe-{workload}.json") as f:
        res = json.load(f)
    assert res["tracer"] and [w["on"] for w in res["windows"]] == [0, 1, 1, 0]
    for w in res["windows"]:
        assert w["steps"] >= 1 and w["rate"] > 0
        if w["on"]:
            assert w["host_ms"] > 0 and w["overflow_share"] == 0.0
            assert w["report"]["spans"]["train_step"]["n"] == w["steps"]
            assert {"tiles.pairs", "tiles.overflow"} <= set(w["report"]["counters"])
    assert res["setup_report"]["spans"]["runner.init_gaussians"]["n"] == 1
    assert set(res["profiles"]) == {"off", "on"}

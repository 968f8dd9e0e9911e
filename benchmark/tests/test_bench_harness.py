"""The benchmark's own tests, on the CPU at a tiny size (``tiny.py``), and on
the card for what only the card has (``card`` marker, decided in a
fixture). Run from the repository's root:

    python -m pytest benchmark/tests -q
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

CELLS = ("garden-default.train", "garden-mcmc.train", "garden-default.init")


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return tiny.make_copy(str(tmp_path_factory.mktemp("bench")))


def last_line(proc):
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_end_to_end(checkout, cell):
    """Each cell runs at a tiny size and prints a result line to the
    contract, its compared numbers last on standard error."""
    proc = tiny.run_cell(checkout, "tiny-" + cell, seed=2**31 + 11)
    out = last_line(proc)
    assert set(out) >= {"correct", "attempted", "failed", "metrics", "device"}
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    want = {"setup_s", "train_steps_per_s" if cell.endswith(".train") else "init_s_per_image"}
    assert set(out["metrics"]) == want
    for m in out["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert list(out)[-1] == "checks"
    tail = proc.stderr.strip().splitlines()[-len(out["checks"]):]
    assert all(line.startswith("check ") and "limit" in line for line in tail)


def test_same_seed_same_inputs(checkout):
    """The seed makes the inputs: two runs of one seed compare the same
    numbers, another seed other ones."""
    a = last_line(tiny.run_cell(checkout, "tiny-garden-mcmc.train", seed=5))
    b = last_line(tiny.run_cell(checkout, "tiny-garden-mcmc.train", seed=5))
    c = last_line(tiny.run_cell(checkout, "tiny-garden-mcmc.train", seed=6))
    for k in ("init_surface_median", "init_scale_gap"):
        assert a["checks"][k]["value"] == b["checks"][k]["value"]
    assert a["checks"]["init_scale_gap"]["value"] != c["checks"]["init_scale_gap"]["value"]


@pytest.mark.parametrize("fault,number", [
    ("unchanged", "change_gap"), ("half_batch", "loss_gap"), ("altered", "change_gap"),
])
def test_fault_is_not_correct(checkout, fault, number):
    """The timed path broken underneath: the check comes out not correct,
    by the number that catches that fault."""
    cmd = [sys.executable, "-c", "import faults; faults.main()", fault, "--workload",
           "tiny-garden-default.train", "--seed", "9", "--seconds", "1", "--trace", "0", "--device", "cpu"]
    env = dict(os.environ, PYTHONPATH=HERE, JAX_PLATFORMS="cpu")
    out = last_line(subprocess.run(cmd, cwd=checkout, capture_output=True, text=True, timeout=900, env=env))
    assert out["correct"] is False
    assert out["checks"][number]["value"] > out["checks"][number]["limit"]


def test_no_jax_module_loaded(checkout):
    """A fresh interpreter runs a cell through the harness and then finds no
    module whose top-level name is jax, jaxlib, flax or gs_init_tpu."""
    code = (
        "import sys, runpy\n"
        "sys.argv = ['benchmark/run.py', '--workload', 'tiny-garden-default.train', '--seed', '3',"
        " '--seconds', '1', '--trace', '0', '--device', 'cpu']\n"
        "try:\n    runpy.run_path('benchmark/run.py', run_name='__main__')\n"
        "except SystemExit as e:\n    assert not e.code, e.code\n"
        "bad = sorted({n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'flax', 'gs_init_tpu')})\n"
        "assert not bad, bad\n"
        "assert 'gs_init_tpu_torch' in sys.modules\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=checkout, capture_output=True, text=True,
                          timeout=900, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert proc.returncode == 0, proc.stderr[-4000:]


def test_forbidden_names_are_compared_whole():
    sys.path.insert(0, tiny.ROOT)
    from benchmark.harness import common

    saved = dict(sys.modules)
    try:
        sys.modules["gs_init_tpu_torch_fake"] = sys
        sys.modules["jaxtyping_fake"] = sys
        assert common.forbidden_modules() == [n for n in common.forbidden_modules() if n.split(".")[0] in
                                              common.FORBIDDEN]
        assert "gs_init_tpu_torch_fake" not in common.forbidden_modules()
        sys.modules["gs_init_tpu.ops"] = sys
        assert "gs_init_tpu.ops" in common.forbidden_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_new_configuration_found_by_name(checkout, tmp_path):
    """A configuration file and a cell added to a copy are found by name,
    with no edit to the harness."""
    import shutil

    root = str(tmp_path / "copy")
    shutil.copytree(checkout, root, symlinks=True)
    spec_path = os.path.join(root, "BENCHMARK.json")
    with open(spec_path) as f:
        spec = json.load(f)
    conf = dict(spec["configs"][0], name="tiny-other", file="benchmark/configs/tiny-other.json")
    with open(os.path.join(root, spec["configs"][0]["file"])) as f:
        c = json.load(f)
    c["name"] = "tiny-other"
    c["scene"]["cameras"] = 24
    with open(os.path.join(root, conf["file"]), "w") as f:
        json.dump(c, f)
    spec["configs"].append(conf)
    w = dict(spec["workloads"][0], name="tiny-other.train", config="tiny-other")
    spec["workloads"].append(w)
    for m in spec["end_to_end"] + spec["per_layer"]:
        if spec["workloads"][0]["name"] in m.get("workloads", []):
            m["workloads"].append(w["name"])
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    out = last_line(tiny.run_cell(root, "tiny-other.train", seed=4))
    assert out["correct"] is True and out["metrics"]["train_steps_per_s"]["value"] > 0


def test_refuses_without_a_card(checkout):
    """Without a CUDA device (``--device`` left at its default) a run exits
    non-zero and prints no result."""
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "tiny-garden-default.train",
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=checkout, capture_output=True,
                          text=True, timeout=300, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0 and proc.stdout.strip() == ""

"""The SAM-region and the stub init cells (``harness/init_sam.py``,
``harness/init_stub.py``) on the CPU at a tiny size: each runs and comes out
correct with its metrics, its traced run reads the SAM spans and counters,
and planted faults come out not correct. SAM is cut to ViT-B at 128 pixels
here (the published ViT-H at 1024 is for the card). Run from the
repository's root:

    python -m pytest benchmark/tests/test_bench_init_cells.py -q
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

SAM_CELL, STUB_CELL = "tiny-garden-sam.init", "tiny-garden-default.init-stub"
TINY_SAM = {"mdi.alignment.segmentation.sam_variant": "vit_b", "mdi.alignment.segmentation.sam_img_size": 128}


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    """A tiny copy with the SAM cell and the stub cell. The stub cell is not
    in BENCHMARK.json (its traffic and generator are): it is added here as a
    cell beside ``tiny-garden-default.init``, on the same configuration."""
    root = tiny.make_copy(str(tmp_path_factory.mktemp("bench")), cells=("garden-sam.init", "garden-default.init"))
    path = os.path.join(root, "benchmark", "configs", "tiny-garden-sam.json")
    with open(path) as f:
        c = json.load(f)
    c["argv"] += [f"--{k}={v}" for k, v in TINY_SAM.items()]
    c["settings"].update(TINY_SAM)
    c["amg"]["img_size"] = 128
    with open(path, "w") as f:
        json.dump(c, f)
    with open(os.path.join(tiny.BENCH, "traffic", "init-stub.json")) as f:
        t = json.load(f)
    t.update(chunk_images=2, sample_from=2, check_images=1, profile_images=1)
    with open(os.path.join(root, "benchmark", "traffic", "tiny-init-stub.json"), "w") as f:
        json.dump(t, f)
    spec_path = os.path.join(root, "BENCHMARK.json")
    with open(spec_path) as f:
        spec = json.load(f)
    init = next(w for w in spec["workloads"] if w["name"] == "tiny-garden-default.init")
    spec["workloads"].append(dict(init, name=STUB_CELL, traffic="tiny-init-stub"))
    for m in spec["end_to_end"] + spec["per_layer"]:
        if m["name"] in ("init_s_per_image", "init.align_unproject_s", "device.idle_share.init"):
            m["workloads"].append(STUB_CELL)
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    return root


def last_line(proc):
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", [SAM_CELL, STUB_CELL])
def test_cell_end_to_end(checkout, cell):
    out = last_line(tiny.run_cell(checkout, cell, seed=2**31 + 29))
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {"setup_s", "init_s_per_image"}
    assert all(m["value"] > 0 for m in out["metrics"].values())
    want = {"align_gap", "mask_mismatch", "points_gap", "rgb_gap"}
    if cell == SAM_CELL:
        want |= {"depth_gap", "normal_gap", "sam_embed_gap", "sam_logit_gap", "sam_iou_gap", "regions_mismatch"}
    assert set(out["checks"]) == want


def test_traced_sam_cell_reads_the_spans(checkout):
    """The traced run's line holds the SAM metrics the CPU can give (the
    device times and the share of the peak need CUDA events)."""
    out = last_line(tiny.run_cell(checkout, SAM_CELL, seed=5, trace=1))
    m = out["metrics"]
    assert m["init.segment_s"]["value"] > 0 and m["init.predict_s"]["value"] > 0
    assert m["init.region_align_s"]["value"] > 0 and "init.align_unproject_s" not in m
    # 1,024 prompts x 3 masks x 32 x 32 logits, IoU and stability a prompt, in float32.
    assert m["sam.host_mb"]["value"] == pytest.approx(1024 * 3 * (32 * 32 + 2) * 4 / 1e6, rel=0.01)
    assert "sam.encoder_ms" not in m and "sam_encoder_mfu" not in m


def test_traced_stub_cell_reads_its_stages(checkout):
    """The stub cell's traced line holds the alignment and unprojection's
    seconds an image (the idle share needs the card's profiler)."""
    out = last_line(tiny.run_cell(checkout, STUB_CELL, seed=2**31 + 31, trace=1))
    assert out["correct"] is True, out["checks"]
    assert set(out["metrics"]) == {"init.align_unproject_s"} and out["metrics"]["init.align_unproject_s"]["value"] > 0


@pytest.mark.parametrize("fault,number", [("sam_token0", "sam_logit_gap"), ("ransac_scale", "align_gap")])
def test_fault_is_not_correct(checkout, fault, number):
    """The timed path broken underneath: the check comes out not correct,
    by the number that catches that fault."""
    cell = SAM_CELL if fault.startswith("sam") else STUB_CELL
    cmd = [sys.executable, "-c", "import faults_init; faults_init.main()", fault, "--workload", cell,
           "--seed", "9", "--seconds", "1", "--trace", "0", "--device", "cpu"]
    env = dict(os.environ, PYTHONPATH=HERE, JAX_PLATFORMS="cpu")
    out = last_line(subprocess.run(cmd, cwd=checkout, capture_output=True, text=True, timeout=900, env=env))
    assert out["correct"] is False
    assert out["checks"][number]["value"] > out["checks"][number]["limit"]

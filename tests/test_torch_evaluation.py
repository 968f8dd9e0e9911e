"""Parity: the port's evaluation package (``gs_init_tpu_torch/evaluation``)
and TensorBoard event files (``utils/tb.py``) against the JAX package's.

Grid strings expand to the same combinations and run ids (a sweep started
by either package resumes in the other); planning marks the same runs done;
``evaluate_run`` rescores the same saved PNG canvases within 1e-6 (LPIPS
included, on random weights); per-patch metrics and results tables agree;
an event file written by the port is read by tensorboard's
``EventAccumulator`` and by ``gs_init_tpu.evaluation.tables`` with the
values tensorboardX writes, and the port reads tensorboardX's. The twin is
tests/test_evaluation.py.
"""
import json
import os

import numpy as np
import pytest

import gs_init_tpu.evaluation.patches as jpatches
import gs_init_tpu.evaluation.sweep as jsweep
import gs_init_tpu.evaluation.tables as jtables
import gs_init_tpu.ops.lpips as JL
from gs_init_tpu_torch.datasets.png import write_png
from gs_init_tpu_torch.evaluation import patches as ppatches
from gs_init_tpu_torch.evaluation import sweep as psweep
from gs_init_tpu_torch.evaluation import tables as ptables
from gs_init_tpu_torch.utils import tb as ptb
from test_torch_lpips import _weights, _write

GRIDS = [
    "{default,mcmc} --mdi.predictor={stub,depth_anything_v2} --sh_degree=2",
    "default --mdi.alignment.method=[ALL]",
    "mcmc --strategy.cap_max={1000,2000} --mdi.alignment.segmentation.method=[ALL]",
    "--max_steps={100,200}",
]


@pytest.mark.parametrize("grid", GRIDS)
def test_grids_and_run_ids_match_jax(grid):
    combos = psweep.parse_config_string(grid)
    assert combos == jsweep.parse_config_string(grid)
    for scene in ("garden", "room"):
        for c in combos:
            assert psweep.run_id_of(scene, c) == jsweep.run_id_of(scene, c)
            assert psweep.combo_name(c) == jsweep.combo_name(c)


def test_parse_errors_match_jax():
    for bad, err in (("default --bad", ValueError), ("default --k={a,b", ValueError), ("", ValueError)):
        for mod in (psweep, jsweep):
            with pytest.raises(err):
                mod.parse_config_string(bad)
    for mod in (psweep, jsweep):
        with pytest.raises(AttributeError):
            mod.all_values_of_param("nonexistent.path")
    assert psweep.all_values_of_param("mdi.predictor") == jsweep.all_values_of_param("mdi.predictor")


def _mark_done(run, eval_steps=()):
    os.makedirs(os.path.join(run.out_dir, "stats"), exist_ok=True)
    with open(os.path.join(run.out_dir, "run_id.json"), "w") as f:
        json.dump({"run_id": run.run_id}, f)
    with open(os.path.join(run.out_dir, "stats", "train_final.json"), "w") as f:
        json.dump({}, f)
    with open(os.path.join(run.out_dir, "cfg.json"), "w") as f:
        json.dump({"eval_steps": list(eval_steps)}, f)


def test_plan_sweep_resumes_across_packages(tmp_path):
    """A run completed under one package's plan counts as done in the
    other's; a stale one is backed up by either."""
    root = str(tmp_path / "out")
    cfgs = ["{default,mcmc}"]
    jruns = jsweep.plan_sweep("/data", ["garden", "room"], cfgs, root)
    pruns = psweep.plan_sweep("/data", ["garden", "room"], cfgs, root)
    assert [(r.run_id, r.out_dir, r.done) for r in pruns] == [(r.run_id, r.out_dir, r.done) for r in jruns]
    _mark_done(jruns[1], eval_steps=[5])
    with open(os.path.join(jruns[1].out_dir, "stats", "val_step5.json"), "w") as f:
        json.dump({}, f)
    assert [r.done for r in psweep.plan_sweep("/data", ["garden", "room"], cfgs, root)] == [False, True, False, False]
    assert [r.done for r in jsweep.plan_sweep("/data", ["garden", "room"], cfgs, root)] == [False, True, False, False]
    os.remove(os.path.join(jruns[1].out_dir, "stats", "val_step5.json"))
    assert not psweep.plan_sweep("/data", ["garden", "room"], cfgs, root)[1].done
    assert not os.path.exists(jruns[1].out_dir)  # backed up
    assert os.listdir(root + "_backup")


def test_train_command_launches_the_port(tmp_path):
    run = psweep.plan_sweep("/data", ["garden"], ["mcmc --sh_degree=2"], str(tmp_path / "out"))[0]
    cmd = psweep.train_command(run, "/data", ["--max_steps=10"])
    jcmd = jsweep.train_command(run, "/data", ["--max_steps=10"])
    assert cmd[1:3] == ["-m", "gs_init_tpu_torch.trainer"] and jcmd[2] == "gs_init_tpu.trainer"
    assert cmd[3:] == jcmd[3:]
    assert "--strategy.cap_max=6000000" in cmd


@pytest.fixture()
def saved_renders(tmp_path, monkeypatch):
    """Two eval canvases (gt | render) at step 10, written as PNG, and
    random LPIPS weights under GS_TPU_CHECKPOINT_DIR."""
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    convs, lins = _weights()
    _write(ckpt, "npz", convs, lins)
    monkeypatch.setenv("GS_TPU_CHECKPOINT_DIR", str(ckpt))
    JL._load_params.cache_clear()
    rng = np.random.default_rng(11)
    out = tmp_path / "run"
    (out / "renders").mkdir(parents=True)
    with open(out / "cfg.json", "w") as f:
        json.dump({"eval_steps": [10]}, f)
    gt = rng.uniform(0.2, 0.8, (48, 64, 3)).astype(np.float32)
    for i, sigma in enumerate((0.01, 0.2)):
        render = np.clip(gt + rng.normal(0, sigma, gt.shape), 0, 1)
        write_png(str(out / "renders" / f"val_10_{i:03d}.png"),
                  (np.concatenate([gt, render], axis=1) * 255).astype(np.uint8))
    yield str(out)
    JL._load_params.cache_clear()


def test_evaluate_run_matches_jax(saved_renders):
    want = jsweep.evaluate_run(saved_renders)
    jper = json.load(open(os.path.join(saved_renders, "results-10.json")))["per_image"]
    got = psweep.evaluate_run(saved_renders, device="cpu")
    res = json.load(open(os.path.join(saved_renders, "results-10.json")))
    assert set(got) == set(want) == {"psnr", "ssim", "lpips"}
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-6, abs=1e-6), k
    assert res["n_images"] == 2 and res["per_image"][0]["psnr"] > res["per_image"][1]["psnr"]
    for a, b in zip(res["per_image"], jper):
        for k in b:
            assert a[k] == pytest.approx(b[k], rel=1e-6, abs=1e-6), k
    with pytest.raises(FileNotFoundError):
        psweep.evaluate_run(saved_renders, step=99, device="cpu")


def test_patch_metrics_match_jax(saved_renders):
    prow = ppatches.analyze_renders(saved_renders, grid=(2, 3))
    jrow = jpatches.analyze_renders(saved_renders, grid=(2, 3))
    assert [(r["step"], r["view"]) for r in prow] == [(r["step"], r["view"]) for r in jrow] == [(10, 0), (10, 1)]
    for a, b in zip(prow, jrow):
        np.testing.assert_allclose(a["psnr"], b["psnr"], rtol=1e-6)
        np.testing.assert_allclose(a["ssim"], b["ssim"], rtol=1e-5, atol=1e-6)
    assert ppatches.patch_table(prow[0]["psnr"]) == jpatches.patch_table(jrow[0]["psnr"])
    small = ppatches.patch_metrics(*ppatches.split_canvas(np.zeros((8, 16, 3), np.uint8)), grid=(1, 1))
    assert np.isnan(small["ssim"]).all()


SCALARS = [("train/loss", 0.5, 0), ("train/num_GS", 120, 0), ("train/loss", 0.25, 100),
           ("train/num_GS", 150, 100), ("train/mem_peak_gb", 1.5, 100), ("val/psnr", 21.25, 200),
           ("val/lpips", 0.125, 200)]


def _fake_run(root, scene, preset, writer_cls, psnr):
    run = os.path.join(root, scene, f"{preset}_0123456789ab")
    os.makedirs(os.path.join(run, "stats"))
    with open(os.path.join(run, "stats", "val_step200.json"), "w") as f:
        json.dump({"psnr": psnr, "ssim": 0.5, "num_GS": 150}, f)
    w = writer_cls(os.path.join(run, "tb"))
    for tag, v, s in SCALARS:
        w.add_scalar(tag, v * (1 + psnr / 100), s)
    w.close()
    return run


def test_event_files_read_by_tensorboard_and_both_packages(tmp_path):
    from tensorboard.backend.event_processing import event_accumulator as ea
    from tensorboardX import SummaryWriter as XWriter

    port_run = _fake_run(str(tmp_path / "out"), "garden", "default", ptb.SummaryWriter, 20.0)
    x_run = _fake_run(str(tmp_path / "out"), "room", "default", XWriter, 20.0)
    acc = {}
    for run in (port_run, x_run):
        a = ea.EventAccumulator(os.path.join(run, "tb"), size_guidance={ea.SCALARS: 0})
        a.Reload()
        acc[run] = {tag: [(e.step, e.value) for e in a.Scalars(tag)] for tag in a.Tags()["scalars"]}
    assert acc[port_run] == acc[x_run] and len(acc[port_run]) == 5
    assert ptb.read_scalars(os.path.join(port_run, "tb")) == ptb.read_scalars(os.path.join(x_run, "tb")) \
        == acc[port_run]
    for run in (port_run, x_run):
        for step, n_tags in ((None, 3), (0, 2), (100, 3)):
            want = jtables.read_tb_scalars(run, jtables.DEFAULT_TB_TAGS, step=step)
            assert ptables.read_tb_scalars(run, ptables.DEFAULT_TB_TAGS, step=step) == want
            assert len(want) == n_tags
    jrows = sorted(jtables.collect_results(str(tmp_path / "out")), key=lambda r: r["scene"])
    prows = sorted(ptables.collect_results(str(tmp_path / "out")), key=lambda r: r["scene"])
    assert prows == jrows and prows[0]["tb_train/loss"] == pytest.approx(0.25 * 1.2)
    for metric in ("psnr", "tb_train/loss"):
        for fmt in ("markdown", "latex"):
            assert ptables.make_table(prows, metric, fmt) == jtables.make_table(jrows, metric, fmt)


def test_event_file_framing_is_checked(tmp_path):
    w = ptb.SummaryWriter(str(tmp_path))
    w.add_scalar("a", 1.0, 3)
    w.close()
    good = open(w.path, "rb").read()
    assert ptb.read_scalars(str(tmp_path)) == {"a": [(3, 1.0)]}
    with open(w.path, "ab") as f:  # a record cut short by a writer still running
        f.write(ptb._record(ptb._event(0.0, 4, tag="a", value=2.0))[:20])
    assert ptb.read_scalars(str(tmp_path)) == {"a": [(3, 1.0)]}
    bad = bytearray(good)
    bad[-6] ^= 0xFF  # inside the scalar's payload
    with open(w.path, "wb") as f:
        f.write(bytes(bad))
    with pytest.raises(ValueError, match="CRC"):
        ptb.read_scalars(str(tmp_path))
    assert ptb.crc32c(b"123456789") == 0xE3069283  # the CRC-32C check value

"""Parity: the port's LPIPS (``gs_init_tpu_torch/ops/lpips.py``) against
``gs_init_tpu.ops.lpips`` on the same random weights, written in each of the
three layouts both packages read (the npz of scripts/convert_lpips.py with
and without the lin calibration, the official LPIPS bundle, a torchvision
AlexNet state dict); the gating on a weights file; and the uncalibrated
branch's mean over channels. Values within rtol 1e-5 (f32 convolutions
summed in two orders). The twin is tests/test_lpips.py.
"""
import numpy as np
import pytest
import torch

import gs_init_tpu.ops.lpips as JL
import jax.numpy as jnp
from gs_init_tpu_torch.ops import lpips as PL
from torch_parity import t

SHAPES = [(11, 11, 3, 64), (5, 5, 64, 192), (3, 3, 192, 384), (3, 3, 384, 256), (3, 3, 256, 256)]
TV_IDX = [0, 3, 6, 8, 10]


def _weights(seed=7):
    rng = np.random.default_rng(seed)
    convs = [((rng.normal(size=s) * 0.05).astype(np.float32), rng.normal(0, 0.05, s[-1]).astype(np.float32))
             for s in SHAPES]
    lins = [rng.uniform(0, 0.1, s[-1]).astype(np.float32) for s in SHAPES]
    return convs, lins


def _write(path, layout, convs, lins):
    """Write the same weights in one of the layouts the loaders accept."""
    oihw = lambda w: torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))
    if layout.startswith("npz"):
        out = {}
        for i, (w, b) in enumerate(convs):
            out[f"conv{i}_w"], out[f"conv{i}_b"] = w, b
            if layout == "npz":
                out[f"lin{i}"] = lins[i]
        np.savez(path / "lpips_alex.npz", **out)
    elif layout == "lpips_bundle":
        sd = {}
        for k, (layer, (w, b)) in enumerate(zip(TV_IDX, convs)):
            sd[f"net.slice{k + 1}.{layer}.weight"] = oihw(w)
            sd[f"net.slice{k + 1}.{layer}.bias"] = torch.from_numpy(b)
            sd[f"lin{k}.model.1.weight"] = torch.from_numpy(lins[k]).reshape(1, -1, 1, 1)
        torch.save(sd, path / "lpips_alex.pth")
    else:  # torchvision alexnet
        sd = {}
        for layer, (w, b) in zip(TV_IDX, convs):
            sd[f"features.{layer}.weight"] = oihw(w)
            sd[f"features.{layer}.bias"] = torch.from_numpy(b)
        torch.save(sd, path / "alexnet-owt.pth")


@pytest.fixture()
def weights_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("GS_TPU_CHECKPOINT_DIR", str(tmp_path))
    JL._load_params.cache_clear()
    yield tmp_path
    JL._load_params.cache_clear()


@pytest.mark.parametrize("layout", ["npz", "npz_uncalibrated", "lpips_bundle", "torchvision"])
def test_lpips_matches_jax(weights_dir, layout):
    convs, lins = _weights()
    _write(weights_dir, layout, convs, lins)
    assert PL.lpips_available() and JL.lpips_available()
    rng = np.random.default_rng(3)
    x = rng.uniform(0, 1, (2, 64, 80, 3)).astype(np.float32)
    y = np.clip(x + rng.normal(0, 0.1, x.shape), 0, 1).astype(np.float32)
    for a, b in ((x, y), (x, x[::-1].copy()), (y, x)):
        want = float(JL.lpips(jnp.asarray(a), jnp.asarray(b)))
        got = float(PL.lpips(t(a), t(b)))
        assert got == pytest.approx(want, rel=1e-5, abs=1e-9), layout
    assert float(PL.lpips(t(x), t(x))) == pytest.approx(0.0, abs=1e-6)


def test_uncalibrated_branch_is_the_mean_over_channels(weights_dir):
    """Without lin weights the distance is the mean over channels, not a
    sum with unit weights: the calibrated value with every lin entry at
    1/channels equals it."""
    convs, _ = _weights()
    rng = np.random.default_rng(5)
    x = rng.uniform(0, 1, (1, 48, 64, 3)).astype(np.float32)
    y = rng.uniform(0, 1, (1, 48, 64, 3)).astype(np.float32)
    _write(weights_dir, "npz_uncalibrated", convs, None)
    uncal = float(PL.lpips(t(x), t(y)))
    (weights_dir / "lpips_alex.npz").unlink()
    _write(weights_dir, "npz", convs, [np.full(s[-1], 1.0 / s[-1], np.float32) for s in SHAPES])
    mean_lins = float(PL.lpips(t(x), t(y)))
    assert uncal == pytest.approx(mean_lins, rel=1e-5)
    (weights_dir / "lpips_alex.npz").unlink()
    _write(weights_dir, "npz", convs, [np.ones(s[-1], np.float32) for s in SHAPES])
    assert float(PL.lpips(t(x), t(y))) > 50 * uncal  # a sum over >= 64 channels


def test_unavailable_without_weights(tmp_path, monkeypatch):
    monkeypatch.setenv("GS_TPU_CHECKPOINT_DIR", str(tmp_path / "none"))
    monkeypatch.setattr("os.path.expanduser", lambda p: str(tmp_path / "nohome") if "~" in p else p)
    monkeypatch.chdir(tmp_path)
    assert not PL.lpips_available() and not JL.lpips_available()
    with pytest.raises(FileNotFoundError):
        PL.lpips(torch.zeros(1, 16, 16, 3), torch.zeros(1, 16, 16, 3))
    (tmp_path / "checkpoints").mkdir()
    (tmp_path / "checkpoints" / "alexnet-x.pt").write_bytes(b"")
    (tmp_path / "checkpoints" / "lpips_vgg.pth").write_bytes(b"")
    assert PL._find_weights() == JL._find_weights() == "checkpoints/alexnet-x.pt"


def test_a_bundle_without_its_convs_is_refused(weights_dir):
    torch.save({"lin0.model.1.weight": torch.zeros(1, 64, 1, 1)}, weights_dir / "lpips_alex.pth")
    with pytest.raises(ValueError, match="layout"):
        PL.lpips(torch.zeros(1, 32, 32, 3), torch.zeros(1, 32, 32, 3))

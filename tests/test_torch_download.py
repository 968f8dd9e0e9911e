"""The port's dataset downloader (``datasets/download.py``) on a zip that
the test writes and serves as a ``file://`` URL: nothing is fetched from
a network. The URL table is the JAX package's."""
import os
import zipfile

import pytest

from gs_init_tpu.datasets import download as J
from gs_init_tpu_torch.datasets import download as P


def _zip(tmp_path):
    src = tmp_path / "scene.zip"
    with zipfile.ZipFile(src, "w") as z:
        z.writestr("scene/images/a.txt", "hello")
        z.writestr("scene/sparse/0/cameras.txt", "# cameras")
    return src


def test_dataset_table_matches_jax():
    assert P.DATASETS == J.DATASETS


@pytest.mark.parametrize("keep_zip", [False, True])
def test_main_downloads_and_extracts_a_file_url(tmp_path, monkeypatch, keep_zip):
    src = _zip(tmp_path)
    monkeypatch.setitem(P.DATASETS, "local", [src.as_uri()])
    out = tmp_path / "data"
    P.main(["--dataset", "local", "--out", str(out)] + (["--keep_zip"] if keep_zip else []))
    assert (out / "scene" / "images" / "a.txt").read_text() == "hello"
    assert (out / "scene" / "sparse" / "0" / "cameras.txt").exists()
    assert (out / "scene.zip").exists() == keep_zip
    assert not (out / "scene.zip.part").exists()


def test_interrupted_download_leaves_no_partial_file(tmp_path):
    dst = tmp_path / "missing.zip"
    with pytest.raises(Exception):
        P.download_with_progress((tmp_path / "no_such.zip").as_uri(), str(dst))
    assert not os.path.exists(str(dst) + ".part") and not dst.exists()

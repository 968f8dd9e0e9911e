"""Dataset downloader CLI — the port's own copy of
``gs_init_tpu/datasets/download.py`` (the reference's
``datasets/download_dataset.py:12-46``: the MipNeRF-360, zipnerf and bilarf
zips), standard library only. A URL list entry may be any URL that
``urllib`` opens, ``file://`` included.

    python -m gs_init_tpu_torch.datasets.download --dataset mipnerf360 --out data/
"""
from __future__ import annotations

import argparse
import os
import sys
import urllib.request
import zipfile

DATASETS = {
    "mipnerf360": [
        "http://storage.googleapis.com/gresearch/refraw360/360_v2.zip",
        "https://storage.googleapis.com/gresearch/refraw360/360_extra_scenes.zip",
    ],
    "zipnerf": [
        f"https://storage.googleapis.com/gresearch/refraw360/zipnerf/{s}.zip"
        for s in ["berlin", "london", "nyc", "alameda"]
    ],
    "bilarf": ["https://huggingface.co/datasets/Yuehao/bilarf_data/resolve/main/bilarf_data.zip"],
}


def download_with_progress(url: str, dst: str) -> None:
    """Download ``url`` to ``dst`` through ``dst.part``; an interrupted
    partial file is removed (reference utils/download_with_tqdm.py:27-30)."""
    tmp = dst + ".part"
    try:
        def hook(blocks, bs, total):
            done = blocks * bs
            if total > 0:
                pct = min(100.0, 100.0 * done / total)
                sys.stdout.write(f"\r{os.path.basename(dst)}: {pct:5.1f}%")
                sys.stdout.flush()

        urllib.request.urlretrieve(url, tmp, reporthook=hook)
        os.replace(tmp, dst)
        sys.stdout.write("\n")
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", choices=sorted(DATASETS), required=True)
    ap.add_argument("--out", default="data")
    ap.add_argument("--keep_zip", action="store_true")
    ns = ap.parse_args(argv)
    os.makedirs(ns.out, exist_ok=True)
    for url in DATASETS[ns.dataset]:
        dst = os.path.join(ns.out, os.path.basename(url))
        if not os.path.exists(dst):
            print(f"downloading {url}")
            download_with_progress(url, dst)
        print(f"extracting {dst}")
        with zipfile.ZipFile(dst) as z:
            z.extractall(ns.out)
        if not ns.keep_zip:
            os.unlink(dst)


if __name__ == "__main__":
    main()

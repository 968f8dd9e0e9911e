"""Frozen copies of the port's per-image monocular-depth init core
(``gs_init_tpu_torch/mdi/points_from_depth.py``, ``subsampling.py``,
``alignment/ransac.py``, ``alignment/lstsqrs.py``), unchanged, so that a
later change to the port cannot move the benchmark's yardstick."""

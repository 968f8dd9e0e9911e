"""Sweeps, per-patch metrics and results tables — port of ``gs_init_tpu/evaluation/``."""

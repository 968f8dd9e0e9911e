"""Monocular-depth initialisation — port of ``gs_init_tpu/mdi/``."""

"""The nerfbaselines-style Method adapter — port of ``gs_init_tpu/integration/``."""

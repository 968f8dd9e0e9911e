"""PyTorch + CUDA port of gs_init_tpu for the NVIDIA H100.

Mirrors ``gs_init_tpu``'s module layout so each function has an obvious
counterpart. The JAX package stays the reference; this package imports
neither JAX nor anything of ``gs_init_tpu``. Plain tensor code is PyTorch;
the Pallas tile compositor (forward and backward) is hand-written CUDA C++
under ``csrc/``, built with ``nvcc`` at first use (see ``kernels.py``).

Entry points run on ``device="cuda"`` unless the caller asks for the CPU,
where every kernel wrapper uses its plain PyTorch version.
"""

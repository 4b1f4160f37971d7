"""PyTorch/CUDA port of the ``repro`` package (the JAX reference), module
for module: ``repro/core/ga.py`` becomes ``repro_torch/core/ga.py``.  It
imports torch, numpy and the standard library, never JAX or ``repro``.
The kernels are hand-written CUDA for Hopper under ``repro_torch/csrc``."""

"""Port of ``repro/kernels``: hand-written CUDA kernels for Hopper
(``repro_torch/csrc``), their wrappers (``ops``), plain versions, oracles
(``ref``) and the implementation-variant registry (``registry``).  Kernel
libraries are built at first use (``build``), never at import."""

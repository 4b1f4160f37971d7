"""Port of ``repro/kernels/rmsnorm.py``: the hand-written CUDA RMSNorm
(``repro_torch/csrc/rmsnorm.cu``, launched by :func:`launch`) and, beside
it, its plain PyTorch version :func:`rmsnorm_plain` — the oracle the tests
and ``chip_smoke.py`` hold the kernel against.

``out = x * rsqrt(mean(x^2) + eps) * (1 + scale)``, f32 statistics, output
in x's dtype; x is (N, d) with d a multiple of 8, any N.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

__all__ = ["rmsnorm_plain", "launch", "DTYPE_CODES"]

#: dtype codes of the C interface
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def rmsnorm_plain(x: torch.Tensor, scale: torch.Tensor, *,
                  eps: float = 1e-6) -> torch.Tensor:
    """The kernel's function in plain PyTorch ops (any shape ``(..., d)``)."""
    xf = x.to(torch.float32)
    inv = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * inv * (1.0 + scale.to(torch.float32))).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _fn():
    """The C entry point, typed (built and loaded at first use)."""
    lib = build.library("rmsnorm")
    fn = lib.rmsnorm_fwd
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def launch(x2: torch.Tensor, scale: torch.Tensor, out: torch.Tensor,
           eps: float) -> None:
    """Launch the kernel on the current stream: ``x2``/``out`` (N, d)
    contiguous and 16-byte aligned on one CUDA device, ``scale`` (d,)
    contiguous.  Raises if the C entry point reports a CUDA error."""
    n, d = x2.shape
    err = _fn()(x2.data_ptr(), scale.data_ptr(), out.data_ptr(), n, d,
                float(eps), DTYPE_CODES[x2.dtype], DTYPE_CODES[scale.dtype],
                torch.cuda.current_stream(x2.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rmsnorm kernel launch failed: cudaError {err} "
                           f"(x {tuple(x2.shape)} {x2.dtype})")

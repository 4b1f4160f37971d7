"""Port of ``repro/kernels/rmsnorm.py``: the hand-written CUDA RMSNorm
(``repro_torch/csrc/rmsnorm.cu``, launched by :func:`launch`) and, beside
it, its plain PyTorch version :func:`rmsnorm_plain` — the oracle the tests
and ``chip_smoke.py`` hold the kernel against.

``out = x * rsqrt(mean(x^2) + eps) * (1 + scale)``, f32 statistics, output
in x's dtype; x is (N, d) with d a multiple of 8, any N.

The kernel has variants: an instance for each width the model paths use
(``INSTANCES``: each row held in registers from load to store) and a
generic loop for any other d, each at ``lanes`` lanes a row.
:func:`select_variant` picks one from the inputs' width and dtype, and
:func:`launch` hands it to the C entry point, which refuses a variant the
inputs do not fit.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

__all__ = ["rmsnorm_plain", "launch", "select_variant", "variant_name",
           "DTYPE_CODES", "INSTANCES"]

#: dtype codes of the C interface
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: the widths with a row-in-registers instance (0 in a variant: the
#: generic loop)
INSTANCES = (128, 1024, 2560)


def rmsnorm_plain(x: torch.Tensor, scale: torch.Tensor, *,
                  eps: float = 1e-6) -> torch.Tensor:
    """The kernel's function in plain PyTorch ops (any shape ``(..., d)``)."""
    xf = x.to(torch.float32)
    inv = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * inv * (1.0 + scale.to(torch.float32))).to(x.dtype)


def select_variant(x: torch.Tensor) -> tuple[int, int]:
    """The kernel variant ``(instance, lanes)`` for rows ``x`` (..., d):
    the instance for d (0: the generic loop) and the lanes a row, the
    largest power of two no larger than 32 or the 16-byte vectors in a row
    (8 bf16 or 4 f32 a vector).  Pure: reads dtype and width only, so it
    runs on CPU tensors too.  Raises for d not a multiple of 8."""
    d = x.shape[-1]
    if d <= 0 or d % 8 != 0:
        raise ValueError(f"rmsnorm kernel takes d a multiple of 8, got {d}")
    vectors = d // (16 // x.element_size())
    lanes = 1 << (min(32, vectors).bit_length() - 1)
    return (d if d in INSTANCES else 0), lanes


def variant_name(variant: tuple[int, int]) -> str:
    """``"d128_l16"`` (the d = 128 instance at 16 lanes a row),
    ``"generic_l8"`` (the generic loop at 8 lanes a row), ..."""
    instance, lanes = variant
    return f"{f'd{instance}' if instance else 'generic'}_l{lanes}"


@functools.lru_cache(maxsize=None)
def _fn():
    """The C entry point, typed (built and loaded at first use)."""
    lib = build.library("rmsnorm")
    fn = lib.rmsnorm_fwd
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def launch(x2: torch.Tensor, scale: torch.Tensor, out: torch.Tensor,
           eps: float, *, variant: tuple[int, int]) -> None:
    """Launch the kernel's ``variant`` on the current stream: ``x2``/``out``
    (N, d) contiguous and 16-byte aligned on one CUDA device, ``scale``
    (d,) contiguous and 16-byte aligned.  Raises if the C entry point
    reports a CUDA error (or refuses the variant for these inputs)."""
    n, d = x2.shape
    instance, lanes = variant
    err = _fn()(x2.data_ptr(), scale.data_ptr(), out.data_ptr(), n, d,
                float(eps), DTYPE_CODES[x2.dtype], DTYPE_CODES[scale.dtype],
                lanes, instance,
                torch.cuda.current_stream(x2.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rmsnorm kernel launch failed: cudaError {err} "
                           f"(variant {variant_name(variant)}, x "
                           f"{tuple(x2.shape)} {x2.dtype})")

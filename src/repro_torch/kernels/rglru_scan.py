"""Port of ``repro/kernels/rglru_scan.py``: the hand-written CUDA RG-LRU
scan (``repro_torch/csrc/rglru_scan.cu``, launched by :func:`launch`) and,
beside it, its plain PyTorch version :func:`rglru_scan_plain` — the oracle
the tests and ``chip_smoke.py`` hold the kernel against.

``h_t = exp(log_a_t) * h_{t-1} + b_t`` over (B, S, D), f32 state and
output.  The kernel starts from h_0 = 0; the wrapper folds a nonzero
initial state into ``b[:, 0]``.

The kernel fills its ring of stages by one of two routes (``ROUTES``):
``"tma"`` (TMA copies; (batch, seq) strides that are multiples of 16 bytes
and 16-byte aligned bases) or ``"cp_async"`` (4-byte ``cp.async`` copies;
any strides).  :func:`select_route` picks one from the inputs' strides and
alignment, and :func:`launch` hands that choice to the C entry point, which
refuses a route the inputs do not fit rather than switching to another.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import build

__all__ = ["rglru_scan_plain", "launch", "select_route", "ROUTES"]

#: the kernel's routes, by their codes in the C entry point
ROUTES = {"cp_async": 0, "tma": 1}


def rglru_scan_plain(log_a: torch.Tensor, b: torch.Tensor,
                     h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's function as a step loop in f32: (B,S,D) -> (B,S,D),
    starting from ``h0`` (B, D), zero when None."""
    la, bf = log_a.float(), b.float()
    h = torch.zeros(la.shape[0], la.shape[2], dtype=torch.float32,
                    device=la.device) if h0 is None else h0.float()
    out = torch.empty_like(bf)
    for t in range(la.shape[1]):
        h = torch.exp(la[:, t]) * h + bf[:, t]
        out[:, t] = h
    return out


def _tma_aligned(t: torch.Tensor) -> bool:
    """f32 with unit stride along D, (batch, seq) strides that are positive
    multiples of 16 bytes, and a 16-byte aligned base: what TMA needs."""
    return (t.dtype == torch.float32 and t.stride(2) == 1
            and t.data_ptr() % 16 == 0
            and all(s > 0 and s % 4 == 0 for s in t.stride()[:2]))


def select_route(log_a: torch.Tensor, b: torch.Tensor) -> str:
    """The kernel route for these (B, S, D) inputs: ``"tma"`` or
    ``"cp_async"``.  Pure: reads dtype, strides and data pointers only, so
    it runs on CPU tensors too."""
    return "tma" if _tma_aligned(log_a) and _tma_aligned(b) else "cp_async"


@functools.lru_cache(maxsize=None)
def _fn():
    """The C entry point, typed (built and loaded at first use)."""
    fn = build.library("rglru_scan").rglru_scan_fwd
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                   + [ctypes.c_longlong] * 4 + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def launch(log_a: torch.Tensor, b: torch.Tensor, out: torch.Tensor, *,
           route: str) -> None:
    """Launch the kernel's ``route`` on the current stream: one launch, no
    scratch.  ``log_a``/``b``: f32 (B, S, D) with unit stride along D on
    one CUDA device; ``out`` f32 (B, S, D) contiguous.  Raises if the C
    entry point reports a CUDA error (or refuses the route for these
    inputs)."""
    bsz, s, d = log_a.shape
    err = _fn()(log_a.data_ptr(), b.data_ptr(), out.data_ptr(), bsz, s, d,
                log_a.stride(0), log_a.stride(1), b.stride(0), b.stride(1),
                ROUTES[route],
                torch.cuda.current_stream(out.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rglru_scan kernel launch failed: cudaError {err} "
                           f"(route {route}, log_a {tuple(log_a.shape)})")

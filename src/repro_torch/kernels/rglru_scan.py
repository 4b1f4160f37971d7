"""Port of ``repro/kernels/rglru_scan.py``: the hand-written CUDA RG-LRU
scan (``repro_torch/csrc/rglru_scan.cu``, launched by :func:`launch`) and,
beside it, its plain PyTorch version :func:`rglru_scan_plain` — the oracle
the tests and ``chip_smoke.py`` hold the kernel against.

``h_t = exp(log_a_t) * h_{t-1} + b_t`` over (B, S, D), f32 state and
output.  The kernel starts from h_0 = 0; the wrapper folds a nonzero
initial state into ``b[:, 0]``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import build

__all__ = ["rglru_scan_plain", "launch"]

#: channels of one tile of the kernel (``kThreads`` in ``rglru_scan.cu``)
TILE_CHANNELS = 128


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


@functools.lru_cache(maxsize=None)
def _lib():
    """The C entry points, typed (built and loaded at first use)."""
    lib = build.library("rglru_scan")
    lib.rglru_scan_tiles.argtypes = [ctypes.c_int] * 3
    lib.rglru_scan_tiles.restype = ctypes.c_longlong
    fn = lib.rglru_scan_fwd
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                   + [ctypes.c_longlong] * 4 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def launch(log_a: torch.Tensor, b: torch.Tensor, out: torch.Tensor) -> None:
    """Launch the kernel on the current stream.  ``log_a``/``b``: f32
    (B, S, D) with unit stride along D on one CUDA device; ``out`` f32
    (B, S, D) contiguous.  Allocates the kernel's look-back scratch (its
    flags zeroed).  Raises if the C entry point reports a CUDA error."""
    bsz, s, d = log_a.shape
    lib = _lib()
    tiles = lib.rglru_scan_tiles(bsz, s, d)
    scratch = torch.empty(3 * tiles * TILE_CHANNELS, dtype=torch.float32,
                          device=out.device)
    flags = torch.zeros(tiles + 1, dtype=torch.int32, device=out.device)
    err = lib.rglru_scan_fwd(
        log_a.data_ptr(), b.data_ptr(), out.data_ptr(), scratch.data_ptr(),
        flags.data_ptr(), bsz, s, d, log_a.stride(0), log_a.stride(1),
        b.stride(0), b.stride(1),
        torch.cuda.current_stream(out.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rglru_scan kernel launch failed: cudaError {err} "
                           f"(log_a {tuple(log_a.shape)})")

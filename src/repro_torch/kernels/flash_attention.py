"""Port of ``repro/kernels/flash_attention.py``: the hand-written CUDA
flash-attention forward (``repro_torch/csrc/flash_attention.cu``, launched
by :func:`launch`) and, beside it, its plain PyTorch version
:func:`flash_attention_plain` — the oracle the tests and ``chip_smoke.py``
hold the kernel against.

Both take the model layout: q (B, Sq, Hq, D), k/v (B, Sk, Hkv, D), Hq a
multiple of Hkv (query head h reads KV head h // (Hq // Hkv)), and return
(B, Sq, Hq, D) in q's dtype.  The causal mask is top-left aligned
(key col <= query row) even when Sq != Sk, as in the reference.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

__all__ = ["flash_attention_plain", "launch", "NEG_INF", "DTYPE_CODES"]

NEG_INF = -1e30
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool, scale: float) -> torch.Tensor:
    """Materialized-softmax attention in f32, the kernel's function."""
    group = q.shape[2] // k.shape[2]
    qh = q.to(torch.float32).transpose(1, 2)
    kh = k.to(torch.float32).repeat_interleave(group, dim=2).transpose(1, 2)
    vh = v.to(torch.float32).repeat_interleave(group, dim=2).transpose(1, 2)
    s = torch.matmul(qh, kh.transpose(-1, -2)) * scale
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        mask = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, vh).transpose(1, 2).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _fn():
    """The C entry point, typed (built and loaded at first use)."""
    lib = build.library("flash_attention")
    fn = lib.flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + [ctypes.c_longlong] * 9
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           out: torch.Tensor, *, causal: bool, scale: float) -> None:
    """Launch the kernel on the current stream.  q/k/v: strided tensors
    with a contiguous last dim on one CUDA device; ``out`` (B, Sq, Hq, D)
    contiguous.  Raises if the C entry point reports a CUDA error."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    strides = [s for t in (q, k, v) for s in t.stride()[:3]]
    err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                b, hq, hkv, sq, sk, d, *strides, float(scale), int(causal),
                DTYPE_CODES[q.dtype],
                torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"flash_attention kernel launch failed: cudaError {err} "
            f"(q {tuple(q.shape)}, k {tuple(k.shape)}, {q.dtype})")

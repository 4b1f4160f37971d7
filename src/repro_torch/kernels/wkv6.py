"""Port of ``repro/kernels/wkv6.py``: the hand-written CUDA WKV-6
recurrence (``repro_torch/csrc/wkv6.cu``, launched by :func:`launch`) and,
beside it, its plain PyTorch version :func:`wkv6_plain` — the oracle the
tests and ``chip_smoke.py`` hold the kernel against.

Per (batch, head) with a D x D state that starts at zero::

    y_t = r_t^T (S_{t-1} + (u * k_t) outer v_t)
    S_t = diag(exp(log_w_t)) S_{t-1} + k_t outer v_t

over r/k/v/log_w (B, S, H, D) and u (H, D); y is (B, S, H, D) f32.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

__all__ = ["wkv6_plain", "launch", "HEAD_DIMS"]

#: head dims the kernel is instantiated for
HEAD_DIMS = (16, 32, 64)


def wkv6_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               log_w: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The kernel's function as a step loop in f32 (model layout)."""
    rf, kf, vf, lwf = (t.float() for t in (r, k, v, log_w))
    uf = u.float()                                        # (H, D)
    b, s, h, d = rf.shape
    state = torch.zeros(b, h, d, d, dtype=torch.float32, device=rf.device)
    out = torch.empty_like(vf)
    for t in range(s):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]  # (B,H,D,D)
        out[:, t] = torch.einsum("bhk,bhkv->bhv", rf[:, t],
                                 state + uf[:, :, None] * kv)
        state = torch.exp(lwf[:, t])[..., None] * state + kv
    return out


@functools.lru_cache(maxsize=None)
def _fn():
    """The C entry point, typed (built and loaded at first use)."""
    fn = build.library("wkv6").wkv6_fwd
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                   + [ctypes.c_longlong] * 12 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def launch(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           log_w: torch.Tensor, u: torch.Tensor, out: torch.Tensor) -> None:
    """Launch the kernel on the current stream.  r/k/v/log_w: f32
    (B, S, H, D) with unit stride along D on one CUDA device; u f32 (H, D)
    contiguous; ``out`` f32 (B, S, H, D) contiguous.  Raises if the C entry
    point reports a CUDA error."""
    b, s, h, d = r.shape
    strides = [st for t in (r, k, v, log_w) for st in t.stride()[:3]]
    err = _fn()(r.data_ptr(), k.data_ptr(), v.data_ptr(), log_w.data_ptr(),
                u.data_ptr(), out.data_ptr(), b, s, h, d, *strides,
                torch.cuda.current_stream(out.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"wkv6 kernel launch failed: cudaError {err} "
                           f"(r {tuple(r.shape)})")

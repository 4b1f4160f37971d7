"""Port of ``repro/kernels/ops.py``: the public kernel wrappers.

Each wrapper checks device, dtype, shape and layout, allocates the output
and launches its hand-written CUDA kernel on the current stream — only for
a CUDA tensor.  A tensor that lies on the CPU takes the kernel's plain
PyTorch version (the tests run there); any other device raises.  Nothing
catches a failed build or launch.

Each wrapper counts its launches in a plain integer attribute
(``flash_attention.launches``, ``rmsnorm.launches``), incremented where the
kernel is launched and nowhere else, so a run can show that it went through
the kernels.

Layout logic against the reference: the kernel indexes heads through
strides, so the reference's GQA head flattening (``ops.py:44-47``) and its
sequence padding to block multiples are gone; the RMSNorm kernel masks the
ragged row edge itself, so the reference's row-block halving
(``ops.py:110-112``) is gone too.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import rmsnorm as _rn

__all__ = ["flash_attention", "rmsnorm", "reset_launch_counts",
           "launch_counts"]

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def _route(*tensors: torch.Tensor) -> str:
    """"plain" for CPU tensors, "cuda" for CUDA tensors; raise otherwise."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cpu":
        return "plain"
    if dev.type == "cuda":
        return "cuda"
    raise ValueError(f"no kernel for device {dev}: the wrappers take CUDA "
                     f"tensors (kernel) or CPU tensors (plain version)")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q: (B,Sq,Hq,D); k/v: (B,Sk,Hkv,D) -> (B,Sq,Hq,D), scale 1/sqrt(D)."""
    b, sq, hq, d = q.shape
    if k.ndim != 4 or k.shape != v.shape or k.shape[0] != b \
            or k.shape[3] != d or hq % k.shape[2] != 0:
        raise ValueError(f"flash_attention: bad shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    scale = 1.0 / math.sqrt(d)
    if _route(q, k, v) == "plain":
        return _fa.flash_attention_plain(q, k, v, causal=causal, scale=scale)
    if not (q.dtype == k.dtype == v.dtype and q.dtype in _KERNEL_DTYPES):
        raise ValueError(f"flash_attention kernel takes f32 or bf16 q/k/v of "
                         f"one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if d % 8 != 0 or not 8 <= d <= 256:
        raise ValueError(f"flash_attention kernel takes head dims that are "
                         f"multiples of 8 up to 256, got {d}")
    if b * hq > 65535:
        raise ValueError(f"flash_attention kernel takes B*Hq <= 65535, "
                         f"got {b * hq}")
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    out = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device)
    _fa.launch(q, k, v, out, causal=causal, scale=scale)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *,
            eps: float = 1e-6) -> torch.Tensor:
    """x: (..., d); scale: (d,) -> x's shape and dtype."""
    d = x.shape[-1]
    if scale.shape != (d,):
        raise ValueError(f"rmsnorm: scale {tuple(scale.shape)} does not "
                         f"match x {tuple(x.shape)}")
    if _route(x, scale) == "plain":
        return _rn.rmsnorm_plain(x, scale, eps=eps)
    if x.dtype not in _KERNEL_DTYPES or scale.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"rmsnorm kernel takes f32 or bf16, got x "
                         f"{x.dtype}, scale {scale.dtype}")
    if d % 8 != 0:
        raise ValueError(f"rmsnorm kernel takes d a multiple of 8, got {d}")
    x2 = x.reshape(-1, d)
    if not x2.is_contiguous() or x2.data_ptr() % 16 != 0:
        x2 = x2.contiguous() if not x2.is_contiguous() else x2.clone()
    out = torch.empty_like(x2)
    if x2.shape[0] > 0:
        _rn.launch(x2, scale.contiguous(), out, eps)
        rmsnorm.launches += 1
    return out.reshape(x.shape)


rmsnorm.launches = 0


def reset_launch_counts() -> None:
    """Set every wrapper's launch count to 0."""
    flash_attention.launches = 0
    rmsnorm.launches = 0


def launch_counts() -> dict[str, int]:
    return {"flash_attention": flash_attention.launches,
            "rmsnorm": rmsnorm.launches}

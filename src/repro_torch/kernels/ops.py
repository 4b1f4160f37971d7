"""Port of ``repro/kernels/ops.py``: the public kernel wrappers.

Each wrapper checks device, dtype, shape and layout, allocates the output
and launches its hand-written CUDA kernel on the current stream — only for
a CUDA tensor.  A tensor that lies on the CPU takes the kernel's plain
PyTorch version (the tests run there); any other device raises.  Nothing
catches a failed build or launch.

Each wrapper counts its launches in a plain integer attribute
(``flash_attention.launches``, ``rmsnorm.launches``,
``rglru_scan.launches``, ``wkv6.launches``), incremented where the kernel
is launched and nowhere else (under one lock: launches may come from
several threads), so a run can show that it went through the kernels.
A wrapper called while its thread captures a CUDA graph
(:mod:`repro_torch.core.device_program`) launches nothing then: the
capture records the count (:func:`recording_launches`), and each replay
of the graph adds it (:func:`replay_launches`), as each replay launches
the kernel.  ``flash_attention.launches_by_path`` splits its count over the
kernel's paths (``"wgmma"``, ``"mma"``, ``"scalar"``),
``rmsnorm.launches_by_variant`` over the RMSNorm kernel's variants
(``"d128_l16"``: the instance for d = 128 at 16 lanes a row;
``"generic_l8"``: the generic loop at 8 lanes a row; ...) and
``rglru_scan.launches_by_route`` over the RG-LRU kernel's load routes
(``"tma"``, ``"cp_async"``).

Layout logic against the reference: the kernel indexes heads through
strides, so the reference's GQA head flattening (``ops.py:44-47``) and its
sequence padding to block multiples are gone; the RMSNorm kernel masks the
ragged row edge itself, so the reference's row-block halving
(``ops.py:110-112``) is gone too; the scan kernels mask ragged S and D and
index (B, S[, H], D) through strides, so the reference's time padding
(``ops.py:75-76,93-97``), its ``d_block`` fallback (``:77-78``) and its
head flattening for WKV are gone.  The RG-LRU ``h0`` fold into ``b[:, 0]``
(``ops.py:71-72``) stays here.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import rglru_scan as _rg
from repro_torch.kernels import rmsnorm as _rn
from repro_torch.kernels import wkv6 as _wk

__all__ = ["flash_attention", "rglru_scan", "rmsnorm", "wkv6",
           "reset_launch_counts", "launch_counts", "recording_launches",
           "replay_launches"]

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
#: guards the launch counts: the planner's overlapped prepares launch from
#: several threads
_COUNT_LOCK = threading.Lock()
#: ``record``: the launches a capture on this thread has recorded
_CAPTURING = threading.local()


def _apply(wrapper, split: Optional[str], key: Optional[str]) -> None:
    wrapper.launches += 1
    if split is not None:
        counts = getattr(wrapper, split)
        counts[key] = counts.get(key, 0) + 1


def _count(wrapper, split: Optional[str] = None,
           key: Optional[str] = None) -> None:
    """One launch of ``wrapper``'s kernel (by ``split[key]``); recorded
    instead while this thread captures a graph."""
    record = getattr(_CAPTURING, "record", None)
    if record is not None:
        record.append((wrapper, split, key))
        return
    with _COUNT_LOCK:
        _apply(wrapper, split, key)


@contextlib.contextmanager
def recording_launches():
    """Within the block, this thread's launches are recorded into the
    list it yields, not counted: a graph capture, whose replays count
    them (:func:`replay_launches`)."""
    prev = getattr(_CAPTURING, "record", None)
    _CAPTURING.record = record = []
    try:
        yield record
    finally:
        _CAPTURING.record = prev


def replay_launches(record) -> None:
    """Count the launches a captured graph's replay made."""
    if record:
        with _COUNT_LOCK:
            for item in record:
                _apply(*item)


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
    path = _fa.select_path(q, k, v)
    _fa.launch(q, k, v, out, causal=causal, scale=scale, path=path)
    _count(flash_attention, "launches_by_path", path)
    return out


flash_attention.launches = 0
flash_attention.launches_by_path = dict.fromkeys(_fa.PATHS, 0)


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
    variant = _rn.select_variant(x)   # raises unless d % 8 == 0
    x2, scale = _aligned_rows(x.reshape(-1, d)), _aligned_rows(scale)
    out = torch.empty_like(x2)
    if x2.shape[0] > 0:
        _rn.launch(x2, scale, out, eps, variant=variant)
        _count(rmsnorm, "launches_by_variant", _rn.variant_name(variant))
    return out.reshape(x.shape)


rmsnorm.launches = 0
rmsnorm.launches_by_variant = {}


def _aligned_rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous with a 16-byte aligned base (a copy only where it
    is needed)."""
    if not t.is_contiguous():
        return t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _f32_rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` in f32 with unit stride along its last dim (a copy only where
    it is needed)."""
    x = x if x.dtype == torch.float32 else x.float()
    return x if x.stride(-1) == 1 else x.contiguous()


def rglru_scan(log_a: torch.Tensor, b: torch.Tensor,
               h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """log_a, b: (B,S,D); h0: (B,D) or None -> states h (B,S,D) f32."""
    if log_a.ndim != 3 or b.shape != log_a.shape or (
            h0 is not None and h0.shape != (log_a.shape[0], log_a.shape[2])):
        raise ValueError(f"rglru_scan: bad shapes log_a {tuple(log_a.shape)} "
                         f"b {tuple(b.shape)} h0 "
                         f"{None if h0 is None else tuple(h0.shape)}")
    if _route(log_a, b, *(() if h0 is None else (h0,))) == "plain":
        return _rg.rglru_scan_plain(log_a, b, h0)
    la, bb = _f32_rows(log_a), _f32_rows(b)
    if h0 is not None:                    # fold h0 into b[:, 0]
        bb = bb.clone()
        bb[:, 0] += torch.exp(la[:, 0]) * h0.float()
    out = torch.empty(la.shape, dtype=torch.float32, device=la.device)
    if out.numel() > 0:
        route = _rg.select_route(la, bb)
        _rg.launch(la, bb, out, route=route)
        _count(rglru_scan, "launches_by_route", route)
    return out


rglru_scan.launches = 0
rglru_scan.launches_by_route = dict.fromkeys(_rg.ROUTES, 0)


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         log_w: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """r/k/v/log_w: (B,S,H,D); u: (H,D) -> y (B,S,H,D) f32."""
    if r.ndim != 4 or not r.shape == k.shape == v.shape == log_w.shape \
            or u.shape != r.shape[2:]:
        raise ValueError(f"wkv6: bad shapes r {tuple(r.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)} log_w "
                         f"{tuple(log_w.shape)} u {tuple(u.shape)}")
    if _route(r, k, v, log_w, u) == "plain":
        return _wk.wkv6_plain(r, k, v, log_w, u)
    d = r.shape[3]
    if d not in _wk.HEAD_DIMS:
        raise ValueError(f"wkv6 kernel takes head dims {_wk.HEAD_DIMS}, "
                         f"got {d}")
    if r.shape[0] > 65535:
        raise ValueError(f"wkv6 kernel takes B <= 65535, got {r.shape[0]}")
    r, k, v, log_w = map(_f32_rows, (r, k, v, log_w))
    u = u.float().contiguous()
    out = torch.empty(r.shape, dtype=torch.float32, device=r.device)
    if out.numel() > 0:
        _wk.launch(r, k, v, log_w, u, out)
        _count(wkv6)
    return out


wkv6.launches = 0

_COUNTED = (flash_attention, rmsnorm, rglru_scan, wkv6)


def reset_launch_counts() -> None:
    """Set every wrapper's launch count to 0."""
    for fn in _COUNTED:
        fn.launches = 0
    flash_attention.launches_by_path = dict.fromkeys(_fa.PATHS, 0)
    rmsnorm.launches_by_variant = {}
    rglru_scan.launches_by_route = dict.fromkeys(_rg.ROUTES, 0)


def launch_counts() -> dict[str, int]:
    return {fn.__name__: fn.launches for fn in _COUNTED}

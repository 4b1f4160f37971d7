"""Port of ``repro/kernels/flash_attention.py``: the hand-written CUDA
flash-attention forward (``repro_torch/csrc/flash_attention.cu``, launched
by :func:`launch`) and, beside it, its plain PyTorch version
:func:`flash_attention_plain` — the oracle the tests and ``chip_smoke.py``
hold the kernel against.

Both take the model layout: q (B, Sq, Hq, D), k/v (B, Sk, Hkv, D), Hq a
multiple of Hkv (query head h reads KV head h // (Hq // Hkv)), and return
(B, Sq, Hq, D) in q's dtype.  The causal mask is top-left aligned
(key col <= query row) even when Sq != Sk, as in the reference.

The kernel has three paths (``PATHS``): ``"wgmma"`` (TMA and wgmma,
warp-specialised; bf16, head dim 64/128), ``"mma"`` (mma.sync; bf16, head
dim 32) and ``"scalar"`` (anything else).  :func:`select_path` picks
one from the inputs' dtype, head dim, strides and alignment, and
:func:`launch` hands that choice to the C entry point, which refuses a path
the inputs do not fit rather than switching to another.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

__all__ = ["flash_attention_plain", "launch", "select_path",
           "block_rel_err", "NEG_INF", "DTYPE_CODES", "PATHS"]

NEG_INF = -1e30
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: the kernel's paths, by their codes in the C entry point
PATHS = {"scalar": 0, "mma": 1, "wgmma": 2}
#: head dims each tensor-core path is built for
_WGMMA_DIMS = (64, 128)
_MMA_DIMS = (32,)


def _tma_aligned(t: torch.Tensor) -> bool:
    """Unit stride along D, every (batch, seq, head) stride a multiple of 16
    bytes and the base 16-byte aligned: what TMA (and 16-byte cp.async)
    need."""
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all((s * t.element_size()) % 16 == 0 for s in t.stride()[:3]))


def select_path(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The kernel path for these inputs: ``"wgmma"``, ``"mma"`` or
    ``"scalar"``.  Pure: reads dtype, head dim, strides and data pointers
    only, so it runs on CPU tensors too."""
    d = q.shape[-1]
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16) \
            or not all(map(_tma_aligned, (q, k, v))):
        return "scalar"
    if d in _WGMMA_DIMS:
        return "wgmma"
    return "mma" if d in _MMA_DIMS else "scalar"


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


def block_rel_err(got: torch.Tensor, want: torch.Tensor,
                  rows: int = 128) -> float:
    """Worst ||got - want|| / ||want|| over the (batch, head, ``rows``
    query rows) blocks of (B, S, H, D) outputs: how far the kernel is from
    :func:`flash_attention_plain`, scaled to each block.  Late causal rows
    average many values and are small, so a fault confined to them can sit
    inside an element-wise tolerance and still show here."""
    got, want = got.float(), want.float()
    worst = 0.0
    for r0 in range(0, got.shape[1], rows):
        diff = (got[:, r0:r0 + rows] - want[:, r0:r0 + rows]).norm(dim=(1, 3))
        ref = want[:, r0:r0 + rows].norm(dim=(1, 3)).clamp_min(1e-30)
        worst = max(worst, (diff / ref).max().item())
    return worst


@functools.lru_cache(maxsize=None)
def _fn():
    """The C entry point, typed (built and loaded at first use)."""
    lib = build.library("flash_attention")
    fn = lib.flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + [ctypes.c_longlong] * 9
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           out: torch.Tensor, *, causal: bool, scale: float,
           path: str) -> None:
    """Launch the kernel's ``path`` on the current stream.  q/k/v: strided
    tensors with a contiguous last dim on one CUDA device; ``out``
    (B, Sq, Hq, D) contiguous.  Raises if the C entry point reports a CUDA
    error (or refuses the path for these inputs)."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    strides = [s for t in (q, k, v) for s in t.stride()[:3]]
    err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                b, hq, hkv, sq, sk, d, *strides, float(scale), int(causal),
                DTYPE_CODES[q.dtype], PATHS[path],
                torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"flash_attention kernel launch failed: cudaError {err} "
            f"(path {path}, q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"{q.dtype})")

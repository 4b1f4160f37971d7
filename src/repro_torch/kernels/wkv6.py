"""Port of ``repro/kernels/wkv6.py``: the hand-written CUDA WKV-6
recurrence (``repro_torch/csrc/wkv6.cu``, launched by :func:`launch`) and,
beside it, its plain PyTorch version :func:`wkv6_plain` — the oracle the
tests and ``chip_smoke.py`` hold the kernel against.

Per (batch, head) with a D x D state that starts at zero::

    y_t = r_t^T (S_{t-1} + (u * k_t) outer v_t)
    S_t = diag(exp(log_w_t)) S_{t-1} + k_t outer v_t

over r/k/v/log_w (B, S, H, D) and u (H, D); y is (B, S, H, D) f32.

:func:`wkv6_chunked_plain` is a plain PyTorch twin of the kernel's
chunk-parallel algorithm, step for step, so that the CPU tests can hold the
algorithm (not only the function) against the reference.  Nothing on the
main path calls it.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

__all__ = ["wkv6_plain", "wkv6_chunked_plain", "launch", "HEAD_DIMS",
           "CHUNK", "SUB_CHUNK"]

#: head dims the kernel is instantiated for
HEAD_DIMS = (16, 32, 64)
#: time steps of one chunk (one block of the chunk-local kernels) and of
#: one sub-chunk (``kChunk`` / ``kSub`` in ``wkv6.cu``)
CHUNK = 64
SUB_CHUNK = 16


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


def _sub_chunk(state, r, k, v, lw, u):
    """One sub-chunk of L steps from ``state`` (..., D, D); r/k/v/lw
    (..., L, D), u broadcastable to (..., 1, D).  Returns (y (..., L, D),
    the state after the sub-chunk).  Every exponent taken is <= 0: the
    cumulated decays are local to the sub-chunk and enter only as
    differences later minus earlier."""
    c = torch.cumsum(lw, dim=-2)                  # inclusive, <= 0
    c_prev = c - lw                               # exclusive
    c_last = c[..., -1:, :]
    r_dec = r * torch.exp(c_prev)                 # r_t e^{c'_t - beta}
    k_dec = k * torch.exp(c_last - c)             # k_s e^{c_L - c_s}
    y = r_dec @ state                             # the carried-in state
    # pairwise within the sub-chunk: s < t by e^{c'_t - c_s}, s = t the bonus
    n = lw.shape[-2]
    t_idx = torch.arange(n, device=lw.device)
    lower = (t_idx[None, :] < t_idx[:, None])[..., None]   # (L, L, 1): s < t
    expo = torch.where(lower, c_prev[..., :, None, :] - c[..., None, :, :],
                       torch.zeros((), device=lw.device))
    pair = (r[..., :, None, :] * k[..., None, :, :]
            * torch.exp(expo) * lower).sum(-1)   # (..., L, L)
    bonus = (r * u * k).sum(-1)
    pair = pair + torch.diag_embed(bonus)
    y = y + pair @ v
    state = torch.exp(c_last).transpose(-1, -2) * state \
        + k_dec.transpose(-1, -2) @ v
    return y, state


def wkv6_chunked_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       log_w: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The kernel's chunk-parallel algorithm in plain PyTorch (f32).

    (a) each chunk of :data:`CHUNK` steps scans its sub-chunks of
    :data:`SUB_CHUNK` from a zero state: its state increment A_c and its
    decay g_c = exp(sum of its log_w);  (b) the state pass
    S_{c+1} = g_c * S_c + A_c over the chunks in order;  (c) each chunk
    scans its sub-chunks again from S_c, writing y.  Steps past S are
    padded with (r, k, v, log_w) = 0, which leaves the state as it is."""
    rf, kf, vf, lwf = (t.float() for t in (r, k, v, log_w))
    b, s, h, d = rf.shape
    nc = -(-s // CHUNK)
    pad = nc * CHUNK - s

    def chunks(t):  # (B, S, H, D) -> (B, H, nc, n_sub, L, D)
        t = torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad))
        return t.permute(0, 2, 1, 3).reshape(b, h, nc, CHUNK // SUB_CHUNK,
                                             SUB_CHUNK, d)
    rc, kc, vc, lwc = map(chunks, (rf, kf, vf, lwf))
    uf = u.float()[None, :, None, None, :]        # (1, H, 1, 1, D)
    n_sub = CHUNK // SUB_CHUNK
    # (a) chunk-local increments, every chunk at once
    inc = torch.zeros(b, h, nc, d, d, dtype=torch.float32, device=rf.device)
    for j in range(n_sub):
        _, inc = _sub_chunk(inc, rc[:, :, :, j], kc[:, :, :, j],
                            vc[:, :, :, j], lwc[:, :, :, j], uf)
    decay = torch.exp(lwc.sum(dim=(3, 4)))        # (B, H, nc, D), <= 1
    # (b) the state pass: entering[c] = the state entering chunk c
    entering = torch.zeros_like(inc)
    for c in range(1, nc):
        entering[:, :, c] = decay[:, :, c - 1, :, None] \
            * entering[:, :, c - 1] + inc[:, :, c - 1]
    # (c) outputs, every chunk at once from its entering state
    state, ys = entering, []
    for j in range(n_sub):
        y, state = _sub_chunk(state, rc[:, :, :, j], kc[:, :, :, j],
                              vc[:, :, :, j], lwc[:, :, :, j], uf)
        ys.append(y)
    y = torch.stack(ys, dim=3).reshape(b, h, nc * CHUNK, d)[:, :, :s]
    return y.permute(0, 2, 1, 3).contiguous()


@functools.lru_cache(maxsize=None)
def _fn():
    """The C entry point, typed (built and loaded at first use)."""
    fn = build.library("wkv6").wkv6_fwd
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
                   + [ctypes.c_longlong] * 12 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def launch(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           log_w: torch.Tensor, u: torch.Tensor, out: torch.Tensor) -> None:
    """Launch the kernel on the current stream.  r/k/v/log_w: f32
    (B, S, H, D) with unit stride along D on one CUDA device; u f32 (H, D)
    contiguous; ``out`` f32 (B, S, H, D) contiguous.  Allocates the chunk
    states and decays the kernel passes between its launches.  Raises if
    the C entry point reports a CUDA error."""
    b, s, h, d = r.shape
    nc = -(-s // CHUNK)
    states = torch.empty(b * h * max(nc - 1, 1) * d * d, dtype=torch.float32,
                         device=out.device)
    decay = torch.empty(b * h * max(nc - 1, 1) * d, dtype=torch.float32,
                        device=out.device)
    strides = [st for t in (r, k, v, log_w) for st in t.stride()[:3]]
    err = _fn()(r.data_ptr(), k.data_ptr(), v.data_ptr(), log_w.data_ptr(),
                u.data_ptr(), out.data_ptr(), states.data_ptr(),
                decay.data_ptr(), b, s, h, d, *strides,
                torch.cuda.current_stream(out.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"wkv6 kernel launch failed: cudaError {err} "
                           f"(r {tuple(r.shape)})")

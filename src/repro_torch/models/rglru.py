"""Port of ``repro/models/rglru.py``: the Griffin / RecurrentGemma recurrent
block, conv1d + RG-LRU gated recurrence, in its ``step`` form (the
reference's ``rglru_impl="step"``, what ``REFERENCE_PLAN`` runs).

RG-LRU (arXiv:2402.19427)::

    r_t = sigmoid(W_a x_t)                    (recurrence gate, block-diag)
    i_t = sigmoid(W_x x_t)                    (input gate, block-diag)
    log a_t = -c * softplus(Lambda) * r_t     (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The time scan is the submodule :class:`LinearRecurrence`, whose ``forward``
is one ``torch._higher_order_ops.scan`` over time-major coefficients, so
the export frontend isolates it as a scan region; the permutes to and from
time-major stay outside it.  The reference's ``assoc``/``chunked`` scans
and the decode state (``RGLRUState``) are not ported: the hand-written
kernel takes the scan's place, and the initial state is zero.
"""
from __future__ import annotations

from typing import Mapping

import torch
import torch.nn.functional as F
from torch import nn
from torch._higher_order_ops.scan import scan

from repro_torch.models.layers import cast, dense_init

__all__ = ["LinearRecurrence", "conv1d_causal", "rglru_block", "rglru_init"]

_C = 8.0


def rglru_init(cfg, generator: torch.Generator) -> dict[str, torch.Tensor]:
    """The shapes and distributions of the reference's ``rglru_init``, f32
    on the CPU: projections (in, out), a depthwise conv of width
    ``conv1d_width``, block-diagonal gates of ``n_heads`` blocks and the
    recurrence's ``lam`` uniform in [0.4, 0.8]."""
    d, dr, nh = cfg.d_model, cfg.d_rnn_resolved, cfg.n_heads
    dh = dr // nh
    return {
        "w_branch": dense_init((d, dr), generator),       # gelu branch
        "w_in": dense_init((d, dr), generator),           # recurrent branch
        "w_out": dense_init((dr, d), generator),
        "w_conv": torch.randn(cfg.conv1d_width, dr, generator=generator) * 0.1,
        "b_conv": torch.zeros(dr),
        "w_a": dense_init((nh, dh, dh), generator),
        "b_a": torch.zeros(dr),
        "w_x": dense_init((nh, dh, dh), generator),
        "b_x": torch.zeros(dr),
        "lam": torch.rand(dr, generator=generator) * 0.4 + 0.4,
    }


def _gates(x: torch.Tensor, p: Mapping, cfg) -> tuple[torch.Tensor, torch.Tensor]:
    """Block-diagonal gate projections.  x: (..., d_rnn)."""
    nh = cfg.n_heads
    shape = x.shape
    xh = x.reshape(*shape[:-1], nh, shape[-1] // nh)
    r = torch.einsum("...hd,hde->...he", xh,
                     cast(p["w_a"], x.dtype)).reshape(shape)
    i = torch.einsum("...hd,hde->...he", xh,
                     cast(p["w_x"], x.dtype)).reshape(shape)
    f32 = torch.float32
    r = torch.sigmoid(cast(r, f32) + cast(p["b_a"], f32))
    i = torch.sigmoid(cast(i, f32) + cast(p["b_x"], f32))
    return r, i


def _coeffs(x: torch.Tensor, p: Mapping, cfg) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (log_a, b) with h_t = a_t h_{t-1} + b_t, all f32."""
    r, i = _gates(x, p, cfg)
    log_a = -_C * F.softplus(cast(p["lam"], torch.float32)) * r  # <= 0
    a2 = torch.exp(2.0 * log_a)
    b = torch.sqrt(torch.clamp(1.0 - a2, min=1e-12)) \
        * (i * cast(x, torch.float32))
    return log_a, b


class LinearRecurrence(nn.Module):
    """``h_t = exp(log_a_t) h_{t-1} + b_t`` from ``h_0 = 0`` over time-major
    (S, B, D) coefficients -> states (S, B, D): one ``scan``, a submodule so
    that its region holds the scan alone."""

    def forward(self, log_a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        def step(h, xs):
            la, bt = xs
            h = torch.exp(la) * h + bt
            return h, h.clone()        # a scan's ys may not alias its carry

        h0 = torch.zeros(log_a.shape[1:], dtype=log_a.dtype,
                         device=log_a.device)
        _, hs = scan(step, h0, (log_a, b))
        return hs


def conv1d_causal(x: torch.Tensor, w: torch.Tensor,
                  bias: torch.Tensor) -> torch.Tensor:
    """Causal depthwise conv.  x: (B,S,dr); w: (width, dr); f32 sums."""
    width, s = w.shape[0], x.shape[1]
    prefix = torch.zeros(x.shape[0], width - 1, x.shape[2], dtype=x.dtype,
                         device=x.device)
    xp = torch.cat([prefix, x], dim=1)
    f32 = torch.float32
    out = cast(xp[:, :s], f32) * cast(w[width - 1], f32)
    for i in range(1, width):
        out = out + cast(xp[:, i:i + s], f32) * cast(w[width - 1 - i], f32)
    return cast(out + cast(bias, f32), x.dtype)


def rglru_block(x: torch.Tensor, p: Mapping, cfg,
                recurrence: LinearRecurrence) -> torch.Tensor:
    """x: (B,S,d_model) -> (B,S,d_model), from a zero state.  ``p`` holds
    the reference's ``rglru`` parameters; the compute dtype is x's."""
    dt = x.dtype
    branch = F.gelu(x @ cast(p["w_branch"], dt), approximate="tanh")
    u = conv1d_causal(x @ cast(p["w_in"], dt), p["w_conv"], p["b_conv"])
    log_a, b = _coeffs(u, p, cfg)
    hs = recurrence(log_a.transpose(0, 1), b.transpose(0, 1)).transpose(0, 1)
    return (cast(hs, dt) * branch) @ cast(p["w_out"], dt)

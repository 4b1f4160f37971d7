"""Port of ``repro/models/rglru.py``: the Griffin / RecurrentGemma recurrent
block, conv1d + RG-LRU gated recurrence, with its decode state.

RG-LRU (arXiv:2402.19427)::

    r_t = sigmoid(W_a x_t)                    (recurrence gate, block-diag)
    i_t = sigmoid(W_x x_t)                    (input gate, block-diag)
    log a_t = -c * softplus(Lambda) * r_t     (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Scan implementations (``ExecPlan.rglru_impl``), as in the reference:

* ``step``    -- the submodule :class:`LinearRecurrence`, whose ``forward``
  is one ``torch._higher_order_ops.scan`` over time-major coefficients, so
  the export frontend isolates it as a scan region (the permutes to and
  from time-major stay outside it) and the registry can bind the RG-LRU
  kernel there.  A prefill starts it from the zeros it builds itself, which
  the registry folds away; decode passes the carried state.
* ``assoc``   -- ``torch._higher_order_ops.associative_scan`` in its
  ``generic`` mode (log depth), ``h0`` folded into the first step.
* ``chunked`` -- a loop over time chunks with the associative scan inside;
  falls back to ``assoc`` when the chunk does not divide the sequence.

:func:`rglru_block` returns ``(y, RGLRUState(h, conv))``: the last state of
the scan and the trailing ``conv1d_width - 1`` conv inputs, what a decode
step continues from.
"""
from __future__ import annotations

from typing import Mapping, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch._higher_order_ops.associative_scan import associative_scan

from repro_torch.models.layers import (cast, cdtype, dense_init,
                                      remat_safe_scan)
from repro_torch.models.plan import ExecPlan

__all__ = ["LinearRecurrence", "RGLRUState", "conv1d_causal", "rglru_block",
           "rglru_init", "rglru_scan"]

_C = 8.0


class RGLRUState(NamedTuple):
    h: torch.Tensor      # (B, d_rnn) recurrence state, f32
    conv: torch.Tensor   # (B, width - 1, d_rnn) trailing conv inputs


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


#: the parameters the reference reads in f32 whatever the compute dtype
F32_LEAVES = ("w_conv", "b_conv", "b_a", "b_x", "lam")


def _gates(x: torch.Tensor, p: Mapping, cfg) -> tuple[torch.Tensor, torch.Tensor]:
    """Block-diagonal gate projections.  x: (..., d_rnn).  Under a mesh's
    rules they run in ``local_map`` on each rank's batch rows, the heads
    split over ``model`` where it divides them (:func:`model_divides`) and
    whole where it does not: a channel shard over ``model`` need not split
    into the heads (10 of 256 over 16 ranks at RecurrentGemma-2B's width),
    which a DTensor view cannot do (XLA reshards it implicitly), so there
    each rank projects every head."""
    from repro_torch.runtime.pspec import (dividing_axes, local_map,
                                           model_divides)

    def project(xx, w_a, w_x):
        shape = xx.shape
        xh = xx.reshape(*shape[:-1], w_a.shape[0], -1)   # this rank's heads
        return (torch.einsum("...hd,hde->...he", xh, w_a).reshape(shape),
                torch.einsum("...hd,hde->...he", xh, w_x).reshape(shape))

    b_axes = dividing_axes(x.shape[0], (("pod", "data"), ("data",)))
    hax = "model" if model_divides(cfg.n_heads) else None
    sx = (b_axes if len(b_axes) > 1 else (b_axes[0] if b_axes else None),
          *(None,) * (x.dim() - 2), hax)
    w = (hax, None, None)
    r, i = local_map(project, (sx, w, w), [sx, sx], x,
                     cast(p["w_a"], x.dtype), cast(p["w_x"], x.dtype))
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


# --- the three scan implementations ----------------------------------------


class LinearRecurrence(nn.Module):
    """``h_t = exp(log_a_t) h_{t-1} + b_t`` over time-major (S, B, D)
    coefficients from ``h0`` (B, D) -> (states (S, B, D), last state
    (B, D)): one ``scan``, a submodule so that its region holds the scan
    alone.  ``h0=None`` starts from zeros built here (the registry's
    ``zero_init``)."""

    def forward(self, log_a: torch.Tensor, b: torch.Tensor,
                h0: Optional[torch.Tensor] = None) -> tuple:
        def step(h, xs):
            la, bt = xs
            h = torch.exp(la) * h + bt
            return h, h.clone()        # a scan's ys may not alias its carry

        if h0 is None:
            h0 = torch.zeros(log_a.shape[1:], dtype=log_a.dtype,
                             device=log_a.device)
        h_last, hs = remat_safe_scan(step, h0, (log_a, b))
        return hs, h_last


def _combine(c1, c2):
    la1, b1 = c1
    la2, b2 = c2
    return la1 + la2, torch.exp(la2) * b1 + b2


def _fold_h0(log_a: torch.Tensor, b: torch.Tensor,
             h0: torch.Tensor) -> torch.Tensor:
    """``b`` with ``exp(log_a[:, 0]) * h0`` added to its first step."""
    first = b[:, :1] + torch.exp(log_a[:, :1]) * h0[:, None]
    return torch.cat([first, b[:, 1:]], dim=1)


def _scan_assoc(log_a: torch.Tensor, b: torch.Tensor,
                h0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Log-depth associative scan over the time axis (dim 1) of (B, S, D)
    coefficients; ``h0`` folded into the first step."""
    _, hs = associative_scan(_combine, (log_a, _fold_h0(log_a, b, h0)),
                             dim=1, combine_mode="generic")
    return hs, hs[:, -1]


def _scan_chunked(log_a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor,
                  chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Time chunks of ``chunk`` steps in order, an associative scan inside
    each, the state carried between them; ``assoc`` when the chunk does
    not divide S."""
    s = b.shape[1]
    c = min(chunk, s)
    if s % c != 0:
        return _scan_assoc(log_a, b, h0)
    h, outs = h0, []
    for t in range(0, s, c):
        hs, h = _scan_assoc(log_a[:, t:t + c], b[:, t:t + c], h)
        outs.append(hs)
    return torch.cat(outs, dim=1), h


def _rglru_scan_local(log_a: torch.Tensor, b: torch.Tensor,
                      h0: Optional[torch.Tensor], plan: ExecPlan,
                      recurrence: LinearRecurrence) -> tuple:
    """The plan's ``rglru_impl`` on (B, S, D) coefficients."""
    if plan.rglru_impl == "step":
        hs, h_last = recurrence(log_a.transpose(0, 1), b.transpose(0, 1), h0)
        return hs.transpose(0, 1), h_last
    if h0 is None:
        h0 = torch.zeros(b.shape[0], b.shape[2], dtype=b.dtype,
                         device=b.device)
    if plan.rglru_impl == "assoc":
        return _scan_assoc(log_a, b, h0)
    if plan.rglru_impl == "chunked":
        return _scan_chunked(log_a, b, h0, plan.rglru_chunk)
    raise ValueError(f"unknown rglru_impl {plan.rglru_impl!r}")


def rglru_scan(log_a: torch.Tensor, b: torch.Tensor, h0: Optional[torch.Tensor],
               plan: ExecPlan, recurrence: LinearRecurrence
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, S, D) coefficients from ``h0`` (B, D; zeros when None) -> (states
    (B, S, D), last state (B, D)) by the plan's ``rglru_impl``; ``step`` runs
    ``recurrence`` over time-major views.  Channels are independent: under
    a mesh's rules the scan runs on each rank's shard inside ``local_map``
    (B over ``(pod, data)``, channels over ``model``), as the reference's
    ``shard_map`` does, so nothing reshards mid-scan."""
    from repro_torch.runtime.pspec import dividing_axes, local_map

    bsz, _, dr = log_a.shape
    b_axes = dividing_axes(bsz, (("pod", "data"), ("data",)))
    d_axes = dividing_axes(dr, (("model",),))
    if not b_axes and not d_axes:
        return _rglru_scan_local(log_a, b, h0, plan, recurrence)
    bspec = b_axes if len(b_axes) > 1 else (b_axes[0] if b_axes else None)
    dspec = d_axes[0] if d_axes else None
    s3, s2 = (bspec, None, dspec), (bspec, dspec)
    if h0 is None:
        return local_map(
            lambda la, bb: _rglru_scan_local(la, bb, None, plan, recurrence),
            (s3, s3), [s3, s2], log_a, b)
    return local_map(
        lambda la, bb, h: _rglru_scan_local(la, bb, h, plan, recurrence),
        (s3, s3, s2), [s3, s2], log_a, b, h0)


# --- conv1d (causal depthwise) ----------------------------------------------


def conv1d_causal(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                  prefix: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Causal depthwise conv.  x: (B,S,dr); w: (width, dr); ``prefix``
    (B, width-1, dr): the carried inputs before x (zeros when None); f32
    sums."""
    width, s = w.shape[0], x.shape[1]
    if prefix is None:
        prefix = torch.zeros(x.shape[0], width - 1, x.shape[2],
                             dtype=x.dtype, device=x.device)
    xp = torch.cat([cast(prefix, x.dtype), x], dim=1)
    f32 = torch.float32
    out = cast(xp[:, :s], f32) * cast(w[width - 1], f32)
    for i in range(1, width):
        out = out + cast(xp[:, i:i + s], f32) * cast(w[width - 1 - i], f32)
    return cast(out + cast(bias, f32), x.dtype)


# --- full block ---------------------------------------------------------------


def rglru_block(x: torch.Tensor, p: Mapping, cfg, plan: ExecPlan,
                recurrence: LinearRecurrence,
                state: Optional[RGLRUState] = None
                ) -> tuple[torch.Tensor, RGLRUState]:
    """x: (B,S,d_model) -> ((B,S,d_model), the new state for a decode
    continuation), from ``state`` (zero when None).  ``p`` holds the
    reference's ``rglru`` parameters; the compute dtype is the plan's."""
    dt = cdtype(plan)
    width = cfg.conv1d_width
    branch = F.gelu(x @ cast(p["w_branch"], dt), approximate="tanh")
    u_raw = x @ cast(p["w_in"], dt)
    prefix = state.conv if state is not None else None
    u = conv1d_causal(u_raw, p["w_conv"], p["b_conv"], prefix)
    log_a, b = _coeffs(u, p, cfg)
    hs, h_last = rglru_scan(log_a, b, state.h if state is not None else None,
                            plan, recurrence)
    y = (cast(hs, dt) * branch) @ cast(p["w_out"], dt)
    if prefix is None:
        prefix = torch.zeros(x.shape[0], width - 1, u_raw.shape[2],
                             dtype=dt, device=x.device)
    new_conv = torch.cat([cast(prefix, dt), u_raw], dim=1)[:, -(width - 1):]
    return y, RGLRUState(h_last, new_conv)

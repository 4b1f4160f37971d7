"""Port of ``repro/models/layers.py``: initializers (``dense_init``,
``embed_init``, ``mlp_init``), RMSNorm (``rmsnorm_ref``, ``rmsnorm_fused``,
the ``rmsnorm`` dispatch and the :class:`RMSNorm` submodule around it),
``layernorm`` and its :class:`LayerNorm` submodule, rotary embeddings, the
gated MLP (``mlp_ref``, ``mlp_fused``, the ``mlp`` dispatch), embeddings,
logits and the two cross-entropy forms.

Every layer has a ``ref`` implementation and, where the reference has one,
an offloaded form the :class:`~repro_torch.models.plan.ExecPlan` selects.
Matrix products run in the plan's compute dtype (:func:`cdtype`), with
each weight cast at its use as in the reference; norms keep f32 statistics.
The reference's sharding constraints (``_ff_constrain``, ``constrain``)
have no single-device counterpart and are left out.

Casts to the dtype a tensor already has are skipped: under ``torch.export``
a no-op ``.float()`` returns the same tensor, and later uses of the input
would then read the cast's node, leaking the residual stream into the norm's
region.
"""
from __future__ import annotations

import contextlib
import math
from typing import Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch._higher_order_ops.scan import scan

from repro_torch.models.plan import REFERENCE_PLAN, ExecPlan

__all__ = ["LayerNorm", "RMSNorm", "apply_rope", "cast", "cdtype",
           "cross_entropy_chunked", "cross_entropy_full", "dense_init",
           "embed_init", "embed_tokens",
           "layernorm", "logits_from_hidden", "mlp", "mlp_fused", "mlp_init",
           "mlp_ref", "plan_for", "rmsnorm", "rmsnorm_fused", "rmsnorm_ref",
           "rope_freqs"]


def cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x.to(dtype)``, or ``x`` itself when it has that dtype already."""
    return x if x.dtype == dtype else x.to(dtype)


def cdtype(plan: ExecPlan) -> torch.dtype:
    """The plan's compute dtype as a torch dtype."""
    return getattr(torch, plan.compute_dtype)


def plan_for(x: torch.Tensor, plan: Optional[ExecPlan]) -> ExecPlan:
    """``plan``, or, when None, ``REFERENCE_PLAN`` computing in ``x``'s
    dtype (what a bare block or sublayer runs)."""
    if plan is not None:
        return plan
    return REFERENCE_PLAN.replace(compute_dtype=str(x.dtype).split(".")[-1])


# ---------------------------------------------------------------------------
# initializers (f32 on the CPU, drawn from an explicit generator)
# ---------------------------------------------------------------------------


def dense_init(shape: tuple, generator: torch.Generator,
               in_axis: int = -2) -> torch.Tensor:
    """The reference's ``dense_init``: a normal truncated to +-2 std, scaled
    by 1/sqrt(fan_in), f32 on the CPU."""
    w = nn.init.trunc_normal_(torch.empty(shape), std=1.0, a=-2.0, b=2.0,
                              generator=generator)
    return w / math.sqrt(shape[in_axis])


def embed_init(shape: tuple, generator: torch.Generator) -> torch.Tensor:
    """The reference's ``embed_init``: N(0, 0.02), f32 on the CPU."""
    return torch.randn(shape, generator=generator) * 0.02


def mlp_init(d_model: int, d_ff: int,
             generator: torch.Generator) -> dict[str, torch.Tensor]:
    return {"w_gate": dense_init((d_model, d_ff), generator),
            "w_up": dense_init((d_model, d_ff), generator),
            "w_down": dense_init((d_ff, d_model), generator)}


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor,
                eps: float) -> torch.Tensor:
    """Reference: upcast, normalize, scale (separate ops)."""
    xf = cast(x, torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return cast(normed * (1.0 + cast(scale, torch.float32)), x.dtype)


def rmsnorm_fused(x: torch.Tensor, scale: torch.Tensor,
                  eps: float) -> torch.Tensor:
    """One fused expression, numerically the reference's."""
    xf = cast(x, torch.float32)
    inv = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return cast(xf * inv * (1.0 + cast(scale, torch.float32)), x.dtype)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float,
            plan: ExecPlan) -> torch.Tensor:
    if plan.norm_impl == "fused":
        return rmsnorm_fused(x, scale, eps)
    return rmsnorm_ref(x, scale, eps)


class RMSNorm(nn.Module):
    """RMSNorm over the last dim with the reference's ``(1 + scale)``
    weighting (``weight`` starts at zero = unit scale).  A submodule, so the
    export frontend sees it as one region; its body is the plan's
    :func:`rmsnorm` (the reference form when no plan is given)."""

    def __init__(self, dim: int, eps: float = 1e-6, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(dim, dtype=dtype, device=device))
        self.eps = eps

    def forward(self, x: torch.Tensor,
                plan: Optional[ExecPlan] = None) -> torch.Tensor:
        return rmsnorm(x, self.weight, self.eps, plan or REFERENCE_PLAN)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float) -> torch.Tensor:
    xf = cast(x, torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return cast(y * cast(scale, torch.float32) + cast(bias, torch.float32),
                x.dtype)


class LayerNorm(nn.Module):
    """:func:`layernorm` over the last dim with ``weight`` (starts at one)
    and ``bias`` (zero), both read in f32.  A submodule, so the export
    frontend sees it as one region (x, weight, bias): the ``rmsnorm``
    record matches it by name, and the kernel's binder, which takes (x,
    scale), refuses it."""

    def __init__(self, dim: int, eps: float = 1e-6, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, dtype=dtype, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, dtype=dtype, device=device))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layernorm(x, self.weight, self.bias, self.eps)


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)  # (head_dim/2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: (..., S)."""
    if theta <= 0:
        return x
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)
    angles = cast(positions[..., :, None, None], torch.float32) * freqs
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = torch.chunk(cast(x, torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return cast(out, x.dtype)


# ---------------------------------------------------------------------------
# gated MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------


def _act(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")
    if kind == "relu_sq":
        return torch.square(F.relu(x))
    raise ValueError(kind)


def mlp_ref(x: torch.Tensor, p: Mapping[str, torch.Tensor], act: str,
            plan: ExecPlan) -> torch.Tensor:
    """Reference: three separate matmuls, (in, out) weights."""
    dt = cdtype(plan)
    g = x @ cast(p["w_gate"], dt)
    u = x @ cast(p["w_up"], dt)
    return (_act(g, act) * u) @ cast(p["w_down"], dt)


def mlp_fused(x: torch.Tensor, p: Mapping[str, torch.Tensor], act: str,
              plan: ExecPlan) -> torch.Tensor:
    """Fused: gate and up as one matmul."""
    dt = cdtype(plan)
    wgu = cast(torch.cat([p["w_gate"], p["w_up"]], dim=1), dt)
    g, u = torch.chunk(x @ wgu, 2, dim=-1)
    return (_act(g, act) * u) @ cast(p["w_down"], dt)


def mlp(x: torch.Tensor, p: Mapping[str, torch.Tensor], act: str,
        plan: ExecPlan) -> torch.Tensor:
    if plan.mlp_impl == "fused":
        return mlp_fused(x, p, act, plan)
    return mlp_ref(x, p, act, plan)


# ---------------------------------------------------------------------------
# embedding + logits + losses
# ---------------------------------------------------------------------------


def embed_tokens(tokens: torch.Tensor, table: torch.Tensor, plan: ExecPlan,
                 scale: bool) -> torch.Tensor:
    x = cast(F.embedding(tokens, table), cdtype(plan))
    if scale:   # sqrt(d) rounded to the compute dtype first, as jnp does
        x = x * torch.full((), math.sqrt(table.shape[1]), dtype=x.dtype,
                           device=x.device)
    return x


def logits_from_hidden(h: torch.Tensor, table: torch.Tensor, plan: ExecPlan,
                       softcap: float) -> torch.Tensor:
    out = h @ cast(table, cdtype(plan)).T
    if softcap > 0:
        out = torch.tanh(out / softcap) * softcap
    return out


def cross_entropy_full(logits: torch.Tensor,
                       labels: torch.Tensor) -> torch.Tensor:
    """Reference loss: the full (B,S,V) f32 log-softmax.  Returns the
    per-token nll (B,S); the caller applies the loss mask."""
    lp = torch.log_softmax(cast(logits, torch.float32), dim=-1)
    return -torch.gather(lp, -1, labels[..., None].long())[..., 0]


def cross_entropy_chunked(h: torch.Tensor, table: torch.Tensor,
                          labels: torch.Tensor, plan: ExecPlan,
                          softcap: float) -> torch.Tensor:
    """Memory-lean loss: logsumexp and the label logit over vocab chunks of
    ``plan.loss_vocab_chunk`` rows, never the f32 (B,S,V) tensor.  The last
    chunk may be ragged: it is the table's remaining rows (the reference
    pads it with columns masked to -inf, which add nothing)."""
    v = table.shape[0]
    chunk = min(plan.loss_vocab_chunk, v)
    labels = labels.long()
    m = torch.full(labels.shape, -math.inf, device=h.device)
    ssum = torch.zeros(labels.shape, device=h.device)
    lbl_logit = torch.zeros(labels.shape, device=h.device)
    for c0 in range(0, v, chunk):
        tchunk = table[c0:c0 + chunk]
        lg = cast(h @ cast(tchunk, h.dtype).T, torch.float32)  # (B,S,<=chunk)
        if softcap > 0:
            lg = torch.tanh(lg / softcap) * softcap
        new_m = torch.maximum(m, lg.amax(dim=-1))
        ssum = ssum * torch.exp(m - new_m) \
            + torch.exp(lg - new_m[..., None]).sum(dim=-1)
        m = new_m
        rel = labels - c0
        in_chunk = (rel >= 0) & (rel < lg.shape[-1])
        picked = torch.gather(lg, -1, rel.clamp(0, lg.shape[-1] - 1)[..., None])
        lbl_logit = torch.where(in_chunk, picked[..., 0], lbl_logit)
    return m + torch.log(ssum) - lbl_logit


def _same(t: torch.Tensor) -> torch.Tensor:
    return t


def remat_safe_scan(combine_fn, init, xs) -> tuple:
    """``torch._higher_order_ops.scan`` that also runs inside an activation
    checkpoint.  Under autograd a scan traces its joint forward and
    backward; the saved-tensor hooks of an enclosing checkpoint
    (``transformer._maybe_remat``) would reach into that trace and recompute
    the layer on its fake tensors, which fails.  So while autograd records,
    the scan saves its tensors as they are (identity hooks above the
    checkpoint's): its residuals are kept, and the rest of the layer is
    recomputed as the policy says.  Without grad (a forward, an export) it
    is the plain ``scan``."""
    hooks = torch.autograd.graph.saved_tensors_hooks(_same, _same) \
        if torch.is_grad_enabled() else contextlib.nullcontext()
    with hooks:
        return scan(combine_fn, init, xs)

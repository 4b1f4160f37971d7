"""Port of ``repro/models/layers.py``: ``rmsnorm_ref`` (and the ``RMSNorm``
submodule around it), ``apply_rope`` and ``mlp_ref``.

Casts to the dtype a tensor already has are skipped: under ``torch.export``
a no-op ``.float()`` returns the same tensor, and later uses of the input
would then read the cast's node, leaking the residual stream into the norm's
region.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["RMSNorm", "apply_rope", "cast", "mlp_ref", "rmsnorm_ref",
           "rope_freqs"]


def cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x.to(dtype)``, or ``x`` itself when it has that dtype already."""
    return x if x.dtype == dtype else x.to(dtype)


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor,
                eps: float) -> torch.Tensor:
    """Reference: upcast, normalize, scale (separate ops)."""
    xf = cast(x, torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return cast(normed * (1.0 + cast(scale, torch.float32)), x.dtype)


class RMSNorm(nn.Module):
    """RMSNorm over the last dim with the reference's ``(1 + scale)``
    weighting (``weight`` starts at zero = unit scale).  A submodule, so the
    export frontend sees it as one region."""

    def __init__(self, dim: int, eps: float = 1e-6, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(dim, dtype=dtype, device=device))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rmsnorm_ref(x, self.weight, self.eps)


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


def _act(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")
    if kind == "relu_sq":
        return torch.square(F.relu(x))
    raise ValueError(kind)


def mlp_ref(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
            w_down: torch.Tensor, act: str) -> torch.Tensor:
    """Reference gated MLP: three separate matmuls, (in, out) weights."""
    return (_act(x @ w_gate, act) * (x @ w_up)) @ w_down

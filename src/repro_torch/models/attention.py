"""Port of ``repro/models/attention.py``: ``project_qkv`` and
``attend_naive`` (the reference path), with ``Attention`` — the submodule
the export frontend isolates as the attention site.

``Attention`` takes (q, k, v) after RoPE and qk-norm, with K and V at their
own head count (B, S, Hkv, D): the GQA head repeat happens inside it, so
the site's inputs are exactly (q, k, v) and a kernel can do GQA by index.
The causal mask is top-left aligned (key col <= query row), as in the
reference.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.models.layers import apply_rope, cast

__all__ = ["Attention", "NEG_INF", "attend_naive", "project_qkv"]

NEG_INF = -1e30


def project_qkv(x: torch.Tensor, blk: nn.Module, cfg,
                positions: torch.Tensor) -> tuple:
    """Three projections, qk-norm (``blk.q_norm``/``blk.k_norm`` modules)
    and RoPE, in the reference's order (``project_q`` then
    ``project_kv``).  Returns q (B,S,Hq,D), k and v (B,S,Hkv,D)."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = (x @ blk.wq).reshape(b, s, cfg.n_heads, hd)
    if cfg.qk_norm:
        q = blk.q_norm(q)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = (x @ blk.wk).reshape(b, s, cfg.n_kv_heads, hd)
    v = (x @ blk.wv).reshape(b, s, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        k = blk.k_norm(k)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attend_naive(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 causal: bool = True) -> torch.Tensor:
    """Materialized (Sq, Sk) scores in f32, probabilities in q's dtype."""
    b, sq, hq, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    qh = q.transpose(1, 2)
    kh = torch.repeat_interleave(k, hq // hkv, dim=2).transpose(1, 2)
    vh = torch.repeat_interleave(v, hq // hkv, dim=2).transpose(1, 2)
    scores = torch.matmul(cast(qh, torch.float32),
                          cast(kh, torch.float32).transpose(-1, -2))
    scores = scores * (1.0 / math.sqrt(hd))
    if causal:
        mask = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril()
        scores = torch.where(mask, scores, NEG_INF)
    probs = cast(torch.softmax(scores, dim=-1), q.dtype)
    return torch.matmul(probs, vh).transpose(1, 2)


class Attention(nn.Module):
    """Causal GQA attention core: (q, k, v) -> (B, Sq, Hq, D)."""

    def forward(self, q: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor) -> torch.Tensor:
        return attend_naive(q, k, v, causal=True)

"""Port of ``repro/models/transformer.py``: :class:`DenseBlock`, one dense
decoder block in full-sequence mode — the counterpart of
``_dense_block_full`` under ``REFERENCE_PLAN`` (RMSNorm, qk-norm, RoPE,
causal GQA attention, SwiGLU MLP, two residuals).  The rest of the model
(embedding, layer stack, LM head, caches) comes with later slices.

``RMSNorm`` and ``Attention`` are submodules, so the export frontend
isolates them as regions; the projection and MLP weights sit on the block
in the reference's (in, out) layout.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from repro_torch.models.attention import Attention, project_qkv
from repro_torch.models.layers import RMSNorm, mlp_ref

__all__ = ["DenseBlock", "INIT_STD"]

#: weight init std: Qwen3's published ``initializer_range``
INIT_STD = 0.02


class DenseBlock(nn.Module):
    """One pre-norm dense decoder block at ``cfg``'s widths.

    Runs on ``cuda`` unless ``device="cpu"`` is asked for (raises when CUDA
    is wanted and absent).  Weights are drawn from ``generator`` (a CPU
    ``torch.Generator``; seed 0 when None) as N(0, INIT_STD), the two
    projections that write into the residual stream (``wo``, ``w_down``) as
    N(0, INIT_STD / sqrt(2 * n_layers)) — the GPT-2 / Megatron scaled init,
    which keeps a block's outputs where bf16 resolves the verifier's 1e-2;
    norm scales start at zero, the reference's unit ``(1 + scale)``
    weighting.
    """

    def __init__(self, cfg, *, dtype: torch.dtype = torch.float32,
                 device=None, generator: Optional[torch.Generator] = None):
        from repro_torch.core.frontends.export_frontend import resolve_device

        super().__init__()
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.cfg = cfg
        d, hd, ff = cfg.d_model, cfg.resolved_head_dim, cfg.d_ff
        nq, nkv = cfg.n_heads, cfg.n_kv_heads

        def weight(*shape, std=INIT_STD):
            w = torch.randn(*shape, generator=generator) * std
            return nn.Parameter(w.to(device=dev, dtype=dtype))

        out_std = INIT_STD / math.sqrt(2 * max(cfg.n_layers, 1))

        def norm(dim):
            return RMSNorm(dim, cfg.norm_eps, dtype=dtype, device=dev)

        self.ln1 = norm(d)
        self.wq, self.wk = weight(d, nq * hd), weight(d, nkv * hd)
        self.wv, self.wo = weight(d, nkv * hd), weight(nq * hd, d, std=out_std)
        if cfg.qk_norm:
            self.q_norm, self.k_norm = norm(hd), norm(hd)
        self.attn = Attention()
        self.ln2 = norm(d)
        self.w_gate, self.w_up = weight(d, ff), weight(d, ff)
        self.w_down = weight(ff, d, std=out_std)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, _ = x.shape
        positions = torch.arange(s, device=x.device)
        q, k, v = project_qkv(self.ln1(x), self, self.cfg, positions)
        x = x + self.attn(q, k, v).reshape(b, s, -1) @ self.wo
        return x + mlp_ref(self.ln2(x), self.w_gate, self.w_up, self.w_down,
                           self.cfg.mlp_act)

"""Port of ``repro/kernels/ref.py``: the simplest torch formulations of the
reference oracles, in the reference's own layouts, for the tests.  (The
RG-LRU and WKV-6 oracles come with their kernels in a later slice.)"""
from __future__ import annotations

import torch

__all__ = ["flash_attention_ref", "rmsnorm_ref"]


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool, scale: float,
                        group: int = 1) -> torch.Tensor:
    """q: (BHq, Sq, D); k/v: (BHkv, Sk, D); Hq = Hkv*group (interleaved)."""
    if group > 1:
        k = torch.repeat_interleave(k, group, dim=0)
        v = torch.repeat_interleave(v, group, dim=0)
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        mask = torch.arange(sk)[None, :] <= torch.arange(sq)[:, None]
        s = torch.where(mask[None].to(s.device), s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor, *,
                eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + scale.float())).to(x.dtype)

"""Port of ``repro/kernels/ref.py``: the simplest torch formulations of the
reference oracles, in the reference's own layouts, for the tests and the
registry's ``fused_torch`` scan variants (materialized softmax, per-step
scans)."""
from __future__ import annotations

import torch

__all__ = ["flash_attention_ref", "rglru_scan_ref", "rmsnorm_ref",
           "wkv6_ref"]


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
        mask = torch.arange(sk, device=s.device)[None, :] \
            <= torch.arange(sq, device=s.device)[:, None]
        s = torch.where(mask[None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def rglru_scan_ref(log_a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = exp(log_a_t) h_{t-1} + b_t, h_0 = 0.  (B,S,D) -> (B,S,D) f32."""
    la, bf = log_a.float(), b.float()
    h = torch.zeros(la.shape[0], la.shape[2], dtype=torch.float32,
                    device=la.device)
    hs = []
    for t in range(la.shape[1]):
        h = torch.exp(la[:, t]) * h + bf[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1) if hs else torch.zeros_like(bf)


def wkv6_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             log_w: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Step-scan oracle.  r/k/v/log_w: (BH,S,D); u: (BH,1,D) -> y (BH,S,D) f32."""
    rf, kf, vf, lwf = (a.float() for a in (r, k, v, log_w))
    uf = u.float()[:, 0]                                   # (BH, D)
    s = torch.zeros(r.shape[0], r.shape[2], v.shape[2], dtype=torch.float32,
                    device=r.device)
    ys = []
    for t in range(r.shape[1]):
        rt, kt, vt, lwt = rf[:, t], kf[:, t], vf[:, t], lwf[:, t]
        kv = kt[:, :, None] * vt[:, None, :]               # (BH,D,D)
        at = s + uf[:, :, None] * kv
        ys.append(torch.einsum("bk,bkv->bv", rt, at))
        s = torch.exp(lwt)[:, :, None] * s + kv
    return torch.stack(ys, dim=1) if ys else torch.zeros_like(vf)


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor, *,
                eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + scale.float())).to(x.dtype)

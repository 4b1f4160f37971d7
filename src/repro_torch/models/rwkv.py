"""Port of ``repro/models/rwkv.py``: the RWKV-6 "Finch" block
(arXiv:2404.05892), data-dependent decay time-mix and squared-relu
channel-mix, both with token shift.

Per head (head dim D), state S in R^{DxD}::

    y_t = (S_{t-1} + (u * k_t) outer v_t)^T r_t
    S_t = diag(w_t) S_{t-1} + k_t outer v_t

with w_t = exp(-exp(w0 + lora_w(x_t))) in (0, 1), data-dependent.

Region implementations (``ExecPlan.wkv_impl``), as in the reference:

* ``step``    -- one ``scan`` over time (the oracle; decode runs one step);
* ``chunked`` -- one ``scan`` over chunks of ``wkv_chunk`` steps, the
  intra-chunk closed form with log-space decays inside; the step form over
  flattened (batch * head) operands when the chunk does not divide S.

Either scan runs inside the submodule :class:`WKVRecurrence`, so the
export frontend isolates it as one ``loop`` region a layer (a prefill does
not unroll its steps).  Under a mesh's rules the chunked form runs inside
``local_map`` over (batch * head), as the reference's ``shard_map`` does,
and the Finch lerp's (5 * R) projection is pinned whole before its split.
The chunked body keeps the reference's split ``exp(cs_prev) * exp(-cs)``:
it overflows f32 under strong decay over a chunk, a gap of the reference
(``ROADMAP.md`` §3) kept as it is.
"""
from __future__ import annotations

from typing import Mapping, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import layers as L
from repro_torch.models.plan import ExecPlan
from repro_torch.runtime.pspec import constrain, model_divides

__all__ = ["F32_LEAVES", "RWKVState", "WKVRecurrence", "channel_mix",
           "rwkv_init", "time_mix", "wkv_chunked", "wkv_step_scan"]

_LORA_R = 64       # decay lora rank
_DD_R = 32         # ddlerp lora rank

#: the parameters the reference reads in f32 whatever the compute dtype
F32_LEAVES = ("w0", "w_lora_b", "u", "ln_x_scale", "ln_x_bias")


class RWKVState(NamedTuple):
    wkv: torch.Tensor       # (B, H, Dk, Dv) recurrence state, f32
    shift_tm: torch.Tensor  # (B, d) previous token (time-mix)
    shift_cm: torch.Tensor  # (B, d) previous token (channel-mix)


def rwkv_init(cfg, generator: torch.Generator) -> dict[str, torch.Tensor]:
    """The shapes and distributions of the reference's ``rwkv_init``, f32
    on the CPU."""
    d, hd = cfg.d_model, cfg.rwkv_head_dim
    nh = d // hd

    def dense(*shape):
        return L.dense_init(shape, generator)

    def normal(*shape, std):
        return torch.randn(shape, generator=generator) * std

    return {
        # time-mix
        "mu_base": torch.full((d,), 0.5),
        "mu_rkvwg": torch.full((5, d), 0.5),
        "dd_w1": dense(d, 5 * _DD_R),
        "dd_w2": normal(5, _DD_R, d, std=0.01),
        "wr": dense(d, d), "wk": dense(d, d), "wv": dense(d, d),
        "wg": dense(d, d), "wo": dense(d, d),
        "w0": torch.full((d,), -6.0),   # decay bias: w ~ exp(-exp(-6))
        "w_lora_a": dense(d, _LORA_R),
        "w_lora_b": normal(_LORA_R, d, std=0.01),
        "u": normal(nh, hd, std=0.1),   # bonus
        "ln_x_scale": torch.ones(d),    # per-head groupnorm
        "ln_x_bias": torch.zeros(d),
        # channel-mix
        "cm_mu_k": torch.full((d,), 0.5),
        "cm_mu_r": torch.full((d,), 0.5),
        "cm_wk": dense(d, cfg.d_ff),
        "cm_wv": dense(cfg.d_ff, d),
        "cm_wr": dense(d, d),
    }


def _token_shift(x: torch.Tensor, prev: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    """x_{t-1} along dim 1; position 0 takes ``prev`` (or zeros)."""
    first = prev[:, None] if prev is not None else torch.zeros_like(x[:, :1])
    return torch.cat([L.cast(first, x.dtype), x[:, :-1]], dim=1)


def _ddlerp(x: torch.Tensor, sx: torch.Tensor, p: Mapping) -> tuple:
    """Finch data-dependent lerp: the 5 mixed inputs for r, k, v, w, g."""
    dt = x.dtype
    dx = sx - x
    xxx = x + dx * L.cast(p["mu_base"], dt)
    z = torch.tanh(xxx @ L.cast(p["dd_w1"], dt))
    # under a mesh the 5 * R dim is pinned whole first: its split into (5,
    # R) cannot keep a shard over "model" (XLA reshards it implicitly)
    z = constrain(z, "batch", None, None)
    z = z.reshape(*x.shape[:-1], 5, _DD_R)
    adj = torch.einsum("...fr,frd->...fd", z, L.cast(p["dd_w2"], dt))
    mix = L.cast(p["mu_rkvwg"], dt) + adj                       # (...,5,d)
    return tuple(x + dx * mix[..., i, :] for i in range(5))


# ---------------------------------------------------------------------------
# the wkv recurrence: step (oracle) and chunked, one scan each
# ---------------------------------------------------------------------------


def _wkv_step(s, rkvw, u):
    """The step body over (B, H, D) slices (or flattened (BH, D) ones);
    ``u`` (H, D) (or (BH, D)), broadcast against the leading dims."""
    rt, kt, vt, lwt = rkvw
    kv = kt[..., :, None] * vt[..., None, :]
    y = (rt[..., None, :] @ (s + u[..., None] * kv))[..., 0, :]
    return torch.exp(lwt)[..., None] * s + kv, y


def _wkv_chunk(s_in, rkvw, u):
    """The chunk body over (BH, c, D) blocks; ``u`` (BH, D).  With cs the
    inclusive cumsum of log_w within the chunk:

    * inter: y_t += r_t . exp(cs_{t-1}) @ S_in (decay from the chunk's entry);
    * intra: y_t += sum_{s<t} (r_t . exp(cs_{t-1}) . exp(-cs_s) k_s) v_s;
    * bonus: y_t += (r_t . u . k_t) v_t;
    * S_out = exp(cs_C) S_in + sum_s exp(cs_C - cs_s) k_s v_s.
    """
    rt, kt, vt, lwt = rkvw
    c = rt.shape[1]
    cs = torch.cumsum(lwt, dim=1)
    cs_prev = cs - lwt
    r_dec = rt * torch.exp(cs_prev)
    y_inter = r_dec @ s_in
    k_dec = kt * torch.exp(-cs)
    scores = r_dec @ k_dec.transpose(1, 2)
    tri = torch.ones(c, c, dtype=torch.bool, device=rt.device).tril(-1)
    scores = torch.where(tri[None], scores,
                         torch.zeros((), dtype=scores.dtype,
                                     device=scores.device))
    y_intra = scores @ vt
    y_diag = torch.sum(rt * u[:, None] * kt, dim=-1, keepdim=True) * vt
    y = y_inter + y_intra + y_diag
    cs_last = cs[:, -1:]
    k_tail = kt * torch.exp(cs_last - cs)
    s_new = torch.exp(cs_last[:, 0])[..., None] * s_in \
        + k_tail.transpose(1, 2) @ vt
    return s_new, y


class WKVRecurrence(nn.Module):
    """One ``scan``: ``forward(xs, u, s0, chunked)`` -> (final state, ys)
    with ``xs = (r, k, v, log_w)`` stacked on dim 0 in the order the scan
    walks them: steps (xs (S, B, H, D) with s0 (B, H, D, D) and u (H, D), or
    flattened heads: xs (S, BH, D), s0 (BH, D, D), u (BH, D)), or with
    ``chunked`` chunks (xs (n, BH, c, D), s0 and u flattened)."""

    def forward(self, xs: tuple, u: torch.Tensor, s0: torch.Tensor,
                chunked: bool = False) -> tuple:
        return L.remat_safe_scan(_wkv_chunk if chunked else _wkv_step,
                                 s0, xs, (u,))


def _wkv_step_heads(r, k, v, log_w, u, s0,
                    recurrence: WKVRecurrence) -> tuple:
    xs = tuple(a.transpose(0, 1) for a in (r, k, v, log_w))
    s_t, ys = recurrence(xs, u, s0)
    return ys.transpose(0, 1), s_t


def wkv_step_scan(r, k, v, log_w, u, s0, recurrence: WKVRecurrence) -> tuple:
    """The sequential oracle.  r, k, v, log_w (B, S, H, D); u (H, D); s0
    (B, H, D, D) -> (y (B, S, H, D), final state (B, H, D, D)).  Under a
    mesh's rules on each rank's (batch, head) rows, as
    :func:`wkv_chunked`."""
    return _on_local_heads(
        lambda *a: _wkv_step_heads(*a, recurrence), r, k, v, log_w, u, s0)


def _wkv_chunked_bh(rf, kf, vf, lwf, uf, s0f, chunk: int,
                    recurrence: WKVRecurrence) -> tuple:
    """The chunked form on flattened (BH, S, D) operands (``uf`` (BH, D),
    ``s0f`` (BH, D, D)), one scan; the step form when ``chunk`` does not
    divide S.  Returns (y (BH, S, D), final state (BH, D, D))."""
    bh, s, d = rf.shape
    c = min(chunk, s)
    if s % c != 0:
        xs = tuple(a.transpose(0, 1) for a in (rf, kf, vf, lwf))
        s_t, ys = recurrence(xs, uf, s0f)
        return ys.transpose(0, 1), s_t
    n = s // c
    xs = tuple(a.reshape(bh, n, c, d).transpose(0, 1)
               for a in (rf, kf, vf, lwf))             # (n, BH, c, D)
    s_t, ys = recurrence(xs, uf, s0f, chunked=True)
    return ys.transpose(0, 1).reshape(bh, s, d), s_t


def _wkv_chunked_heads(r, k, v, log_w, u, s0, chunk: int,
                       recurrence: WKVRecurrence) -> tuple:
    """:func:`_wkv_chunked_bh` over (B, S, H, D) operands (u (H, D), s0
    (B, H, D, D)), heads flattened to (B*H) and back."""
    b, s, h, d = r.shape

    def flat(a):                                  # (B,S,H,D) -> (BH,S,D)
        return a.transpose(1, 2).reshape(b * h, s, d)

    rf, kf, vf, lwf = map(flat, (r, k, v, log_w))
    uf = u[None].expand(b, h, d).reshape(b * h, d)
    s0f = s0.reshape(b * h, d, d)
    yf, s_t = _wkv_chunked_bh(rf, kf, vf, lwf, uf, s0f, chunk, recurrence)
    return yf.reshape(b, h, s, d).transpose(1, 2), s_t.reshape(b, h, d, d)


def wkv_chunked(r, k, v, log_w, u, s0, chunk: int,
                recurrence: WKVRecurrence) -> tuple:
    """The chunked form over flattened (batch * head) operands, the
    reference's ``wkv_chunked``.  Heads are independent: under a mesh's
    rules the scan runs on each rank's (batch, head) rows inside
    ``local_map`` (B by the batch axes, H by ``model`` where it divides:
    the reference's (B*H) rows over the mesh), with no collective and no
    DTensor reshape of a sharded dim; unsharded without rules."""
    return _on_local_heads(
        lambda *a: _wkv_chunked_heads(*a, chunk, recurrence),
        r, k, v, log_w, u, s0)


def _on_local_heads(fn, r, k, v, log_w, u, s0) -> tuple:
    """``fn(r, k, v, log_w, u, s0)`` -> (y, final state); under a mesh's
    rules inside ``local_map`` (B by the batch axes, H by ``model`` where
    it divides), itself without rules."""
    from repro_torch.runtime.pspec import current_rules, local_map

    rules = current_rules()
    if rules is None:
        return fn(r, k, v, log_w, u, s0)
    b, _, h, _ = r.shape
    hax = "model" if model_divides(h) else None
    bax = rules.resolve("batch", b)
    s4 = (bax, None, hax, None)
    st = (bax, hax, None, None)
    return local_map(fn, (s4,) * 4 + ((hax, None), st), [s4, st],
                     r, k, v, log_w, u, s0)


# ---------------------------------------------------------------------------
# the block's two halves
# ---------------------------------------------------------------------------


def _groupnorm_heads(y: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     nh: int, eps: float = 64e-5) -> torch.Tensor:
    """The per-head group norm of (B, S, d); under a mesh's rules whose
    ``model`` axis does not divide the heads, in ``local_map`` on each
    rank's batch rows (:func:`_channels_whole`)."""
    from repro_torch.runtime.pspec import current_rules, local_map

    def norm(yy, sc, bi):
        b, s, d = yy.shape
        f32 = torch.float32
        yh = L.cast(yy.reshape(b, s, nh, d // nh), f32)
        mu = torch.mean(yh, dim=-1, keepdim=True)
        var = torch.var(yh, dim=-1, keepdim=True, correction=0)
        yh = (yh - mu) * torch.rsqrt(var + eps)
        return yh.reshape(b, s, d) * L.cast(sc, f32) + L.cast(bi, f32)

    if model_divides(nh):
        return norm(y, scale, bias)
    spec = (current_rules().resolve("batch", y.shape[0]), None, None)
    return local_map(norm, (spec, (None,), (None,)), spec, y, scale, bias)


def _channels_whole(t: torch.Tensor, nh: int) -> torch.Tensor:
    """``t`` (B, S, d) with its channels replicated under a mesh's rules
    whose ``model`` axis does not divide the ``nh`` heads (40 of 64 at
    RWKV-6-3B's width over 16 ranks; :func:`model_divides`)."""
    return t if model_divides(nh) else constrain(t, "batch", None, None)


def time_mix(x: torch.Tensor, p: Mapping, cfg, plan: ExecPlan,
             state: Optional[RWKVState], recurrence: WKVRecurrence) -> tuple:
    """Returns (y, new wkv state, last x)."""
    dt, f32 = L.cdtype(plan), torch.float32
    b, s, d = x.shape
    hd = cfg.rwkv_head_dim
    nh = d // hd
    sx = _token_shift(x, state.shift_tm if state is not None else None)
    xr, xk, xv, xw, xg = _ddlerp(x, sx, p)

    def heads(a, w):
        return L.cast(_channels_whole(a @ L.cast(w, dt), nh).reshape(
            b, s, nh, hd), f32)

    rr, kk, vv = heads(xr, p["wr"]), heads(xk, p["wk"]), heads(xv, p["wv"])
    g = F.silu(xg @ L.cast(p["wg"], dt))
    w_pre = L.cast(p["w0"], f32) + (
        L.cast(torch.tanh(xw @ L.cast(p["w_lora_a"], dt)), f32)
        @ L.cast(p["w_lora_b"], f32))
    log_w = -torch.exp(torch.clamp(w_pre, -8.0, 2.0))   # <= 0, bounded
    log_w = _channels_whole(log_w, nh).reshape(b, s, nh, hd)
    u = L.cast(p["u"], f32)
    s0 = state.wkv if state is not None else torch.zeros(
        b, nh, hd, hd, dtype=f32, device=x.device)
    if plan.wkv_impl == "chunked":
        y, s_t = wkv_chunked(rr, kk, vv, log_w, u, s0, plan.wkv_chunk,
                             recurrence)
    else:
        y, s_t = wkv_step_scan(rr, kk, vv, log_w, u, s0, recurrence)
    y = _groupnorm_heads(y.reshape(b, s, d), p["ln_x_scale"], p["ln_x_bias"],
                         nh)
    out = (L.cast(y, dt) * g) @ L.cast(p["wo"], dt)
    return out, s_t, x[:, -1]


def channel_mix(x: torch.Tensor, p: Mapping, cfg, plan: ExecPlan,
                state: Optional[RWKVState]) -> tuple:
    """Returns (y, last x)."""
    dt = L.cdtype(plan)
    sx = _token_shift(x, state.shift_cm if state is not None else None)
    dx = sx - x
    xk = x + dx * L.cast(p["cm_mu_k"], dt)
    xr = x + dx * L.cast(p["cm_mu_r"], dt)
    kk = torch.square(F.relu(xk @ L.cast(p["cm_wk"], dt)))
    y = torch.sigmoid(xr @ L.cast(p["cm_wr"], dt)) \
        * (kk @ L.cast(p["cm_wv"], dt))
    return y, x[:, -1]

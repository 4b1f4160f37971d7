"""Port of ``repro/models/attention.py``: GQA/MQA attention — parameters
(``attn_init``), projections with RoPE and qk-norm (``project_q``,
``project_kv``, ``project_qkv`` with ``qkv_fused`` and ``qkv_bias``), the
region implementations the :class:`~repro_torch.models.plan.ExecPlan`
selects (``attend_naive``: materialized scores, the reference path;
``attend_chunked``: online softmax over KV chunks; ``attend_local_banded``
for local attention longer than its window), one-token decode against a
:class:`KVCache` (``attend_decode``, ``cache_update``, ring or linear) and
the ``attend`` dispatcher.

``attend_chunked`` trains through :class:`_Flash`, the reference's
``_flash`` ``custom_vjp`` as a ``torch.autograd.Function``: its forward
saves (q, k, v, out, logsumexp) and its backward recomputes the
probabilities chunk by chunk, so no (Sq, chunk) score tensor is kept for
the backward.  Under a mesh's rules it runs ``_Flash`` on each rank's
(batch, head) rows inside ``local_map``, so attention has no collective
but the closing gather of its heads; the score tensors of
``attend_naive`` are pinned by ``_score_axes``, as in the reference.

:class:`Attention` is the submodule the export frontend isolates as the
attention site.  It takes exactly (q, k, v) after RoPE and qk-norm, with K
and V at their own head count (B, S, Hkv, D): positions, the mask and the
GQA head repeat are built inside it, so a kernel can do GQA by index.  The
causal mask is top-left aligned (key col <= query row), as in the
reference; ``causal=False`` drops it (the enc-dec family).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
from torch import nn

from repro_torch.models import layers as L
from repro_torch.models.plan import ExecPlan
from repro_torch.runtime.pspec import (axis_gather_whole, axis_index,
                                       constrain, current_rules, local_map,
                                       model_divides)

__all__ = ["Attention", "KVCache", "NEG_INF", "attend", "attend_chunked",
           "attend_decode", "attend_local_banded", "attend_naive",
           "attn_init", "cache_axes", "cache_update", "project_kv", "project_q",
           "project_qkv"]

NEG_INF = -1e30


class KVCache(NamedTuple):
    k: torch.Tensor  # (B, S_cache, Hkv, D)
    v: torch.Tensor  # (B, S_cache, Hkv, D)


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------


def attn_init(cfg, generator: torch.Generator) -> dict[str, torch.Tensor]:
    """The reference's ``attn_init``: (in, out) projections by
    ``dense_init``, zero biases and zero qk-norm scales, f32 on the CPU."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    nq, nkv = cfg.n_heads, cfg.n_kv_heads
    p = {"wq": L.dense_init((d, nq * hd), generator),
         "wk": L.dense_init((d, nkv * hd), generator),
         "wv": L.dense_init((d, nkv * hd), generator),
         "wo": L.dense_init((nq * hd, d), generator)}
    if cfg.qkv_bias:
        p.update(bq=torch.zeros(nq * hd), bk=torch.zeros(nkv * hd),
                 bv=torch.zeros(nkv * hd))
    if cfg.qk_norm:
        p.update(q_norm=torch.zeros(hd), k_norm=torch.zeros(hd))
    return p


# ---------------------------------------------------------------------------
# projections: ``blk`` holds wq/wk/wv (and bq/bk/bv) and the q_norm/k_norm
# RMSNorm submodules, as a DenseBlock does
# ---------------------------------------------------------------------------


def project_q(x: torch.Tensor, blk: nn.Module, cfg, plan: ExecPlan,
              positions: torch.Tensor) -> torch.Tensor:
    dt = L.cdtype(plan)
    b, s, _ = x.shape
    q = x @ L.cast(blk.wq, dt)
    if cfg.qkv_bias:
        q = q + L.cast(blk.bq, dt)
    q = q.reshape(b, s, cfg.n_heads, cfg.resolved_head_dim)
    if cfg.qk_norm:
        q = blk.q_norm(q, plan)
    return L.apply_rope(q, positions, cfg.rope_theta)


def project_kv(x: torch.Tensor, blk: nn.Module, cfg, plan: ExecPlan,
               positions: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    dt = L.cdtype(plan)
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    k = x @ L.cast(blk.wk, dt)
    v = x @ L.cast(blk.wv, dt)
    if cfg.qkv_bias:
        k = k + L.cast(blk.bk, dt)
        v = v + L.cast(blk.bv, dt)
    k = k.reshape(b, s, cfg.n_kv_heads, hd)
    v = v.reshape(b, s, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        k = blk.k_norm(k, plan)
    return L.apply_rope(k, positions, cfg.rope_theta), v


def project_qkv(x: torch.Tensor, blk: nn.Module, cfg, plan: ExecPlan,
                positions: torch.Tensor) -> tuple:
    """Three matmuls (ref) or one fused qkv matmul (offloaded).  Returns q
    (B,S,Hq,D), k and v (B,S,Hkv,D)."""
    if not plan.qkv_fused:
        q = project_q(x, blk, cfg, plan, positions)
        k, v = project_kv(x, blk, cfg, plan, positions)
        return q, k, v
    dt = L.cdtype(plan)
    b, s, _ = x.shape
    hd, nq, nkv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    qkv = x @ L.cast(torch.cat([blk.wq, blk.wk, blk.wv], dim=1), dt)
    if cfg.qkv_bias:
        qkv = qkv + L.cast(torch.cat([blk.bq, blk.bk, blk.bv]), dt)
    q, k, v = torch.split(qkv, [nq * hd, nkv * hd, nkv * hd], dim=-1)
    q = q.reshape(b, s, nq, hd)
    k = k.reshape(b, s, nkv, hd)
    v = v.reshape(b, s, nkv, hd)
    if cfg.qk_norm:
        q = blk.q_norm(q, plan)
        k = blk.k_norm(k, plan)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def cache_axes(n_kv_heads: int) -> tuple:
    """Logical axes of a (B, Sc, Hkv, D) KV-cache entry: heads over
    ``model`` when they divide it, else the cache sequence (what
    ``runtime.sharding._axes_for_state`` gives, so a prefill's caches need
    no reshard)."""
    rules = current_rules()
    if rules is None:
        return ("batch", None, "kv_heads", None)
    if n_kv_heads % rules.axis_sizes.get("model", 1) == 0:
        return ("batch", None, "kv_heads", None)
    return ("batch", "kv_seq", None, None)


def _score_axes(n_heads: int) -> tuple:
    """Sharding of (B, H, Sq, ...) score-like tensors: heads over
    ``model`` when divisible, else sequence-parallel on Sq; the
    reference's, whose table has no ``heads`` entry (so heads resolve to
    unsharded)."""
    rules = current_rules()
    if rules is None:
        return ("batch", "heads", None)
    if n_heads % rules.axis_sizes.get("model", 1) == 0:
        return ("batch", "heads", None)
    return ("batch", None, "seq_sp")


def _group(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """(B,S,Hq,D) -> (B,S,Hkv,G,D)."""
    b, s, hq, d = q.shape
    return q.reshape(b, s, n_kv, hq // n_kv, d)


def _repeat_kv(k: torch.Tensor, group: int) -> torch.Tensor:
    """(B,S,Hkv,D) -> (B,S,Hq,D) by repeating kv heads (GQA)."""
    return torch.repeat_interleave(k, group, dim=2) if group > 1 else k


def _mask(pos_q: torch.Tensor, pos_k: torch.Tensor, causal: bool,
          window: int) -> torch.Tensor:
    mask = torch.ones(pos_q.shape[0], pos_k.shape[0], dtype=torch.bool,
                      device=pos_q.device)
    if causal:
        mask = mask & (pos_k[None, :] <= pos_q[:, None])
    if window > 0:
        mask = mask & (pos_k[None, :] > pos_q[:, None] - window)
    return mask


# ---------------------------------------------------------------------------
# naive full attention (reference)
# ---------------------------------------------------------------------------


def attend_naive(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 pos_q: torch.Tensor, pos_k: torch.Tensor, causal: bool,
                 window: int, plan: ExecPlan) -> torch.Tensor:
    """Materialized (Sq, Sk) scores in f32, probabilities in the compute
    dtype."""
    hq, hd = q.shape[2], q.shape[3]
    group = hq // k.shape[2]
    ax = _score_axes(hq)
    qh = constrain(q.transpose(1, 2), ax[0], ax[1], ax[2], None)
    kh = _repeat_kv(k, group).transpose(1, 2)
    vh = _repeat_kv(v, group).transpose(1, 2)
    scores = torch.matmul(L.cast(qh, torch.float32),
                          L.cast(kh, torch.float32).transpose(-1, -2))
    scores = constrain(scores * (1.0 / math.sqrt(hd)),
                       ax[0], ax[1], ax[2], None)
    scores = torch.where(_mask(pos_q, pos_k, causal, window), scores, NEG_INF)
    probs = L.cast(torch.softmax(scores, dim=-1), L.cdtype(plan))
    return torch.matmul(probs, L.cast(vh, probs.dtype)).transpose(1, 2)


# ---------------------------------------------------------------------------
# chunked (flash-style) attention with a custom backward
#
# Plain autograd through the online-softmax loop would keep every chunk's
# (Sq, ck) scores for the backward.  ``_Flash`` saves (q, k, v, out,
# logsumexp) and its backward recomputes the probabilities chunk by chunk
# (the reference's ``_flash_fwd`` / ``_flash_bwd``, attention.py:216-293).
# ---------------------------------------------------------------------------


def _flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               causal: bool, window: int, ck: int, out_dtype: torch.dtype,
               sk_valid: int) -> tuple[torch.Tensor, torch.Tensor]:
    """q: (BH, Sq, D); k/v: (BH, Sk, D), Sk a multiple of ``ck`` (keys past
    ``sk_valid`` are padding).  Returns (out in ``out_dtype``, logsumexp
    (BH, Sq) f32)."""
    bh, sq, hd = q.shape
    pq = torch.arange(sq, device=q.device)
    scale = 1.0 / math.sqrt(hd)
    m = torch.full((bh, sq), NEG_INF, device=q.device)
    l = torch.zeros((bh, sq), device=q.device)
    acc = torch.zeros((bh, sq, hd), device=q.device)
    for c0 in range(0, k.shape[1], ck):
        k_j, v_j = k[:, c0:c0 + ck], v[:, c0:c0 + ck]
        pk = torch.arange(c0, c0 + ck, device=q.device)
        s = torch.matmul(L.cast(q, torch.float32),
                         L.cast(k_j, torch.float32).transpose(1, 2)) * scale
        keep = _mask(pq, pk, causal, window) & (pk < sk_valid)[None, :]
        s = torch.where(keep[None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.matmul(L.cast(p, k_j.dtype), v_j)
        acc = acc * corr[..., None] + L.cast(pv, torch.float32)
        m = m_new
    l = torch.clamp(l, min=1e-37)
    return L.cast(acc / l[..., None], out_dtype), m + torch.log(l)


def _flash_bwd(q, k, v, out, lse, dout, causal: bool, window: int, ck: int,
               sk_valid: int) -> tuple:
    """(dq, dk, dv) in the inputs' dtypes, from the saved forward and the
    output cotangent, one KV chunk at a time in f32."""
    sq, hd = q.shape[1], q.shape[2]
    pq = torch.arange(sq, device=q.device)
    scale = 1.0 / math.sqrt(hd)
    q32, do = L.cast(q, torch.float32), L.cast(dout, torch.float32)
    delta = torch.sum(do * L.cast(out, torch.float32), dim=-1)   # (BH,Sq)
    dq = torch.zeros_like(q32)
    dks, dvs = [], []
    for c0 in range(0, k.shape[1], ck):
        k_j = L.cast(k[:, c0:c0 + ck], torch.float32)
        v_j = L.cast(v[:, c0:c0 + ck], torch.float32)
        pk = torch.arange(c0, c0 + ck, device=q.device)
        s = torch.matmul(q32, k_j.transpose(1, 2)) * scale
        keep = _mask(pq, pk, causal, window) & (pk < sk_valid)[None, :]
        s = torch.where(keep[None], s, NEG_INF)
        p = torch.exp(s - lse[..., None])                        # (BH,Sq,ck)
        dvs.append(torch.matmul(p.transpose(1, 2), do))
        dp = torch.matmul(do, v_j.transpose(1, 2))
        ds = p * (dp - delta[..., None]) * scale
        dq = dq + torch.matmul(ds, k_j)
        dks.append(torch.matmul(ds.transpose(1, 2), q32))
    return (L.cast(dq, q.dtype), L.cast(torch.cat(dks, dim=1), k.dtype),
            L.cast(torch.cat(dvs, dim=1), v.dtype))


class _Flash(torch.autograd.Function):
    """Flattened-head flash attention with the recomputing backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, ck, out_dtype, sk_valid):
        out, lse = _flash_fwd(q, k, v, causal, window, ck, out_dtype,
                              sk_valid)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, window, ck, sk_valid)
        return out

    @staticmethod
    def backward(ctx, dout):
        return _flash_bwd(*ctx.saved_tensors, dout, *ctx.args) \
            + (None,) * 5


def _flash(q, k, v, causal: bool, window: int, ck: int,
           out_dtype: torch.dtype, sk_valid: int) -> torch.Tensor:
    """:class:`_Flash` when a gradient is wanted, else its forward alone
    (what a planned, ``no_grad`` program exports)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _Flash.apply(q, k, v, causal, window, ck, out_dtype, sk_valid)
    return _flash_fwd(q, k, v, causal, window, ck, out_dtype, sk_valid)[0]


def _flash_heads(q, kh, vh, causal: bool, window: int, ck: int,
                 out_dtype: torch.dtype, sk: int) -> torch.Tensor:
    """:func:`_flash` over (B, S, H, D) operands, heads flattened to (B*H,
    S, D) and back."""
    b, sq, hq, hd = q.shape
    qf = q.transpose(1, 2).reshape(b * hq, sq, hd)
    kf = kh.transpose(1, 2).reshape(b * hq, -1, hd)
    vf = vh.transpose(1, 2).reshape(b * hq, -1, hd)
    out = _flash(qf, kf, vf, causal, window, ck, out_dtype, sk)
    return out.reshape(b, hq, sq, hd).transpose(1, 2)


def attend_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   pos_q: torch.Tensor, pos_k: torch.Tensor, causal: bool,
                   window: int, plan: ExecPlan) -> torch.Tensor:
    """Online softmax over KV chunks of ``plan.attn_kv_chunk`` keys, heads
    flattened to (B*H, S, D).  Positions must be aranges (true for every
    full-sequence caller); a ragged last chunk is padded and its padded
    keys masked, as in the reference.  K and V are repeated to the query
    heads before the flattening, so autograd of the repeat sums each
    group's dk/dv.

    Under a mesh's rules the (B, H) rows split over the whole mesh, as the
    reference's ``shard_map`` over flattened (B*H) does, with no
    collective inside attention: in a local body, B by the batch axes and
    H by ``model`` (each rank its block of ceil(H / model) heads, the last
    ones padded with nothing to compute, where the reference pads B*H to
    the mesh); the output heads are all-gathered over ``model``, which
    the reference's closing ``constrain`` does.  No DTensor reshapes a
    sharded dim here (torch 2.11's DTensor refuses some of those
    reshapes' backward)."""
    b, sq, hq, hd = q.shape
    sk = k.shape[1]
    group = hq // k.shape[2]
    ck = min(plan.attn_kv_chunk, sk)
    pad = (-sk) % ck
    kh, vh = _repeat_kv(k, group), _repeat_kv(v, group)

    def pad_keys(t):
        return torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad)) if pad else t

    # anchor the entry and the exit on the TP-natural head sharding
    hax = _score_axes(hq)[1]
    q = constrain(q, "batch", None, hax, None)
    kh = constrain(kh, "batch", None, hax, None)
    vh = constrain(vh, "batch", None, hax, None)
    dtype = L.cdtype(plan)
    rules = current_rules()
    if rules is None:
        return _flash_heads(q, pad_keys(kh), pad_keys(vh), causal, window,
                            ck, dtype, sk)
    m = rules.axis_sizes.get("model", 1)
    per = -(-hq // m)

    def body(qi, ki, vi):
        # the ragged last chunk is padded here, on the rank's plain
        # tensors: torch 2.11's DTensor pad (``constant_pad_nd``) leaves a
        # spec of one placement on the two-axis mesh, which the backward's
        # later ops cannot propagate (ROADMAP §3 item 23)
        ki, vi = pad_keys(ki), pad_keys(vi)
        lo = (axis_index("model") if m > 1 else 0) * per
        hi = min(lo + per, hq)
        out = _flash_heads(qi[:, :, lo:hi], ki[:, :, lo:hi], vi[:, :, lo:hi],
                           causal, window, ck, dtype, sk)
        if hi - lo < per:                      # the padding heads: nothing
            out = torch.nn.functional.pad(out, (0, 0, 0, per - (hi - lo)))
        if m > 1:
            out = axis_gather_whole(out, "model", 2)[:, :, :hq]
        return out

    spec = (rules.resolve("batch", b), None, None, None)
    # q, k and v, whole over model, each serve the rank's heads only
    out = local_map(body, (spec, spec, spec), spec, q, kh, vh,
                    grad_sums=(("model",),) * 3)
    return constrain(out, "batch", None, hax, None)


# ---------------------------------------------------------------------------
# banded local attention (sub-quadratic)
# ---------------------------------------------------------------------------


def attend_local_banded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        pos_q: torch.Tensor, pos_k: torch.Tensor, window: int,
                        plan: ExecPlan) -> torch.Tensor:
    """Each query chunk of ``window`` attends its own and the previous KV
    chunk only: exact for causal local attention (query p sees (p - w,
    p]); ragged lengths take the chunked path.  Under a mesh's rules the
    band runs in ``local_map`` on each rank's batch rows, split over
    ``model`` as the reference's program splits it:

    * by heads where ``model`` divides the KV heads (the same share of the
      work as the reference's split of the chunks);
    * else by chunks where the rules put the chunk axis on ``seq_sp`` (the
      reference's ``constrain`` of its chunks; its rule drops a mesh axis
      that does not divide them): each rank takes its n / model chunks
      with the KV chunk before them, and the output is gathered over
      ``model``;
    * else every chunk and head whole on each rank (2 chunks over 16 ranks
      at RecurrentGemma-2B's 4096 tokens: the reference's rank computes
      them all too).

    DTensor cannot view a sequence split into chunks that do not divide
    ``seq_sp``, and where they do, its strategy search over the chunked
    einsums on the three-axis mesh ran past 15 minutes: hence the body."""
    b, sq, hq, hd = q.shape
    w = window
    if sq % w != 0 or k.shape[1] != sq:
        return attend_chunked(q, k, v, pos_q, pos_k, True, window, plan)
    rules = current_rules()
    if rules is None:
        return _banded(q, k, v, pos_q, pos_k, w, plan)
    bax = rules.resolve("batch", b)
    heads = model_divides(k.shape[2])
    sp = None if heads else rules.resolve("seq_sp", sq // w)
    if not isinstance(sp, str) or rules.axis_sizes[sp] == 1:
        spec = (bax, None, "model" if heads else None, None)
        return local_map(
            lambda qq, kk, vv: _banded(qq, kk, vv, pos_q, pos_k, w, plan),
            (spec, spec, spec), spec, q, k, v)
    span = sq // rules.axis_sizes[sp]          # this rank's chunks' tokens

    def body(qq, kk, vv):
        lo = axis_index(sp) * span
        prev = None
        if lo:
            prev = (kk[:, lo - w:lo], vv[:, lo - w:lo], pos_k[lo - w:lo])
        out = _banded(qq[:, lo:lo + span], kk[:, lo:lo + span],
                      vv[:, lo:lo + span], pos_q[lo:lo + span],
                      pos_k[lo:lo + span], w, plan, prev)
        return axis_gather_whole(out, sp, 1)

    spec = (bax, None, None, None)
    # q, k and v, whole over ``sp``, each serve the rank's chunks only
    return local_map(body, (spec, spec, spec), spec, q, k, v,
                     grad_sums=((sp,),) * 3)


def _banded(q, k, v, pos_q, pos_k, w: int, plan: ExecPlan,
            prev: Optional[tuple] = None) -> torch.Tensor:
    """The band over whole chunks of ``w``; ``prev`` (k, v, positions) is
    the KV chunk before the first (none: zeros at masked positions)."""
    b, sq, hq, hd = q.shape
    nkv = k.shape[2]
    n = sq // w
    qc = _group(q, nkv).reshape(b, n, w, nkv, hq // nkv, hd)
    qc = constrain(qc, "batch", "seq_sp", None, None, None, None)  # SP chunks
    kc = k.reshape(b, n, w, nkv, hd)
    vc = v.reshape(b, n, w, nkv, hd)
    if prev is None:
        k0, v0 = torch.zeros_like(kc[:, :1]), torch.zeros_like(vc[:, :1])
    else:
        k0, v0 = (t.reshape(b, 1, w, nkv, hd) for t in prev[:2])
    k_prev = torch.cat([k0, kc[:, :-1]], dim=1)
    v_prev = torch.cat([v0, vc[:, :-1]], dim=1)
    kk = torch.cat([k_prev, kc], dim=2)  # (B,n,2w,Hkv,D)
    vv = torch.cat([v_prev, vc], dim=2)
    pq = pos_q.reshape(n, w)
    pk = pos_k.reshape(n, w)
    p0 = (torch.full_like(pk[:1], torch.iinfo(torch.int32).max)
          if prev is None else prev[2].reshape(1, w))
    pk_prev = torch.cat([p0, pk[:-1]], dim=0)
    pkk = torch.cat([pk_prev, pk], dim=1)  # (n, 2w)
    s = torch.einsum("bnqhgd,bnkhd->bnhgqk", L.cast(qc, torch.float32),
                     L.cast(kk, torch.float32)) * (1.0 / math.sqrt(hd))
    mask = (pkk[:, None, :] <= pq[:, :, None]) \
        & (pkk[:, None, :] > pq[:, :, None] - w)
    s = torch.where(mask[None, :, None, None], s, NEG_INF)
    p = L.cast(torch.softmax(s, dim=-1), L.cdtype(plan))
    out = torch.einsum("bnhgqk,bnkhd->bnqhgd", p, L.cast(vv, p.dtype))
    return out.reshape(b, sq, hq, hd)


# ---------------------------------------------------------------------------
# decode (one new token against a cache)
# ---------------------------------------------------------------------------


def attend_decode(q1: torch.Tensor, cache: KVCache, cache_len: torch.Tensor,
                  window: int, plan: ExecPlan, ring: bool) -> torch.Tensor:
    """q1: (B,1,Hq,D); cache.k/v: (B,Sc,Hkv,D); ``cache_len`` a device
    scalar (no host sync).  Returns (B,1,Hq,D).  ``ring``: the cache is a
    ring buffer of ``window`` slots (local attention); otherwise a linear
    buffer whose first ``cache_len`` entries are valid."""
    b, _, hq, hd = q1.shape
    sc, nkv = cache.k.shape[1], cache.k.shape[2]
    qg = _group(q1, nkv)[:, 0]  # (B,Hkv,G,D)
    s = torch.einsum("bhgd,bkhd->bhgk", L.cast(qg, torch.float32),
                     L.cast(cache.k, torch.float32)) * (1.0 / math.sqrt(hd))
    idx = torch.arange(sc, device=q1.device)
    if ring:
        # valid entries: the min(cache_len, window) most recent slots
        age = torch.remainder(cache_len - 1 - idx, sc)  # 0 = newest
        valid = age < torch.clamp(cache_len, max=sc)
    else:
        valid = idx < cache_len
        if window > 0:
            valid = valid & (idx > cache_len - 1 - window)
    s = torch.where(valid[None, None, None], s, NEG_INF)
    p = L.cast(torch.softmax(s, dim=-1), L.cdtype(plan))
    out = torch.einsum("bhgk,bkhd->bhgd", p, L.cast(cache.v, p.dtype))
    return out.reshape(b, 1, hq, hd)


def cache_update(cache: KVCache, k1: torch.Tensor, v1: torch.Tensor,
                 cache_len: torch.Tensor, ring: bool) -> KVCache:
    """Write one token's k/v (B,1,Hkv,D) at its slot (``cache_len``, or
    ``cache_len % Sc`` in a ring), in place; returns the same cache."""
    sc = cache.k.shape[1]
    slot = torch.remainder(cache_len, sc) if ring else cache_len
    slot = slot.reshape(1).long()
    cache.k.index_copy_(1, slot, L.cast(k1, cache.k.dtype))
    cache.v.index_copy_(1, slot, L.cast(v1, cache.v.dtype))
    return cache


# ---------------------------------------------------------------------------
# dispatcher and the attention site
# ---------------------------------------------------------------------------


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           pos_q: torch.Tensor, pos_k: torch.Tensor, *, causal: bool,
           attn_kind: str, window: int, plan: ExecPlan) -> torch.Tensor:
    if attn_kind == "local" and causal and q.shape[1] > window:
        return attend_local_banded(q, k, v, pos_q, pos_k, window, plan)
    win = window if attn_kind == "local" else 0
    if plan.attn_impl == "chunked":
        return attend_chunked(q, k, v, pos_q, pos_k, causal, win, plan)
    return attend_naive(q, k, v, pos_q, pos_k, causal, win, plan)


class Attention(nn.Module):
    """GQA attention core over a full sequence: (q, k, v) -> (B, Sq, Hq,
    D), the plan's :func:`attend` at positions ``arange`` (the reference
    form in q's dtype when no plan is given).  ``causal`` (default) masks
    keys after each query, top-left aligned; an enc-dec model's encoder
    self-attention and cross-attention set it False."""

    def __init__(self, attn_kind: str = "full", window: int = 0,
                 causal: bool = True):
        super().__init__()
        self.attn_kind = attn_kind
        self.window = window
        self.causal = causal

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                plan: Optional[ExecPlan] = None) -> torch.Tensor:
        pos_q = torch.arange(q.shape[1], device=q.device)
        pos_k = torch.arange(k.shape[1], device=k.device)
        return attend(q, k, v, pos_q, pos_k, causal=self.causal,
                      attn_kind=self.attn_kind, window=self.window,
                      plan=L.plan_for(q, plan))

"""Port of ``repro/models/transformer.py`` for the dense and VLM families:
the decoder-only LM's parameters (:class:`LMParams`, drawn as the
reference's ``init_params`` draws them), ``embed_inputs`` (with the VLM
projector), ``head_table``, ``lm_logits``, ``forward_full``, ``lm_loss``
(forward), ``prefill`` and ``decode_step``; plus :class:`RecurrentSublayer`,
a hybrid model's RG-LRU sublayer from a zero state (the counterpart of
``_rglru_sublayer_full``).

Layers are an ``nn.ModuleList`` of :class:`DenseBlock`, not stacked leaves,
and the decode state is ``{"kv": [KVCache per layer], "cache_len": int32
device scalar}``; a decode step writes each cache in place (the
reference's donated state) and returns the same caches with ``cache_len +
1``.  The MoE, hybrid, SSM and enc-dec families raise
``NotImplementedError`` (``ROADMAP.md`` queue 1 item 9 lists them).  The
plan's ``remat``, ``gather_mode`` and ``gather_dtype`` knobs shape the
reference's training step and sharding; a forward here reads none of them.

``RMSNorm``, ``Attention`` and the RG-LRU's ``LinearRecurrence`` are
submodules, so the export frontend isolates them as regions; the
projection and MLP weights sit on the block in the reference's (in, out)
layout.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from repro_torch.models import layers as L
from repro_torch.models.attention import (Attention, KVCache, attend_decode,
                                          attn_init, cache_update,
                                          project_qkv)
from repro_torch.models.plan import ExecPlan
from repro_torch.models.rglru import LinearRecurrence, rglru_block, rglru_init

__all__ = ["DenseBlock", "INIT_STD", "LMParams", "RecurrentSublayer",
           "check_family", "decode_step", "embed_inputs", "forward_full",
           "head_table", "init_params", "lm_logits", "lm_loss", "prefill"]

#: weight init std of the ``scaled`` block init: Qwen3's published
#: ``initializer_range``
INIT_STD = 0.02

#: families not ported yet -> the part of ``ROADMAP.md`` queue 1 item 9
#: that brings them
_UNPORTED = {
    "hybrid": "rglru.py decode state and the hybrid family",
    "ssm": "rwkv.py and the SSM family",
    "moe": "moe.py and the MoE family",
    "encdec": "whisper.py and the enc-dec family",
}


def check_family(cfg) -> None:
    """Raise ``NotImplementedError`` unless ``cfg`` is a dense or VLM
    decoder this port runs (never treat another family as dense)."""
    family = "moe" if cfg.moe is not None else cfg.family
    if family in _UNPORTED:
        raise NotImplementedError(
            f"{cfg.arch_id}: the {family} family is not ported yet "
            f"(ROADMAP.md queue 1 item 9: {_UNPORTED[family]})")
    if family not in ("dense", "vlm"):
        raise ValueError(f"{cfg.arch_id}: unknown family {family!r}")


class DenseBlock(nn.Module):
    """One pre-norm dense decoder block at ``cfg``'s widths.

    Runs on ``cuda`` unless ``device="cpu"`` is asked for (raises when CUDA
    is wanted and absent).  Weights are drawn from ``generator`` (a CPU
    ``torch.Generator``; seed 0 when None).  ``init="reference"`` draws
    them as the reference's ``attn_init`` and ``mlp_init`` do (truncated
    normal / sqrt(fan_in), zero biases), what a whole model uses.
    ``init="scaled"`` draws N(0, INIT_STD), the two projections that write
    into the residual stream (``wo``, ``w_down``) N(0, INIT_STD /
    sqrt(2 * n_layers)) — the GPT-2 / Megatron scaled init, which keeps a
    lone block's outputs where bf16 resolves the verifier's 1e-2.  Norm
    scales start at zero, the reference's unit ``(1 + scale)`` weighting.

    ``forward(x)`` is the full-sequence block under the plan (the
    reference form in x's dtype when none is given); with
    ``cache_capacity`` it also returns the layer's :class:`KVCache`
    (prefill).  :meth:`decode` is one token against that cache.
    """

    def __init__(self, cfg, *, dtype: torch.dtype = torch.float32,
                 device=None, generator: Optional[torch.Generator] = None,
                 init: str = "scaled"):
        from repro_torch.core.frontends.export_frontend import resolve_device

        super().__init__()
        if cfg.moe is not None:
            check_family(cfg)
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.cfg = cfg
        d, hd, ff = cfg.d_model, cfg.resolved_head_dim, cfg.d_ff
        nq, nkv = cfg.n_heads, cfg.n_kv_heads

        def param(w):
            return nn.Parameter(w.to(device=dev, dtype=dtype))

        if init == "scaled":
            out_std = INIT_STD / math.sqrt(2 * max(cfg.n_layers, 1))

            def weight(*shape, std=INIT_STD):
                return torch.randn(*shape, generator=generator) * std

            w = {"wq": weight(d, nq * hd), "wk": weight(d, nkv * hd),
                 "wv": weight(d, nkv * hd), "wo": weight(nq * hd, d,
                                                         std=out_std)}
            w.update(w_gate=weight(d, ff), w_up=weight(d, ff),
                     w_down=weight(ff, d, std=out_std))
            if cfg.qkv_bias:
                w.update(bq=torch.zeros(nq * hd), bk=torch.zeros(nkv * hd),
                         bv=torch.zeros(nkv * hd))
        elif init == "reference":
            w = attn_init(cfg, generator)
            w.pop("q_norm", None)
            w.pop("k_norm", None)
            w.update(L.mlp_init(d, ff, generator))
        else:
            raise ValueError(f"init must be 'scaled' or 'reference', not "
                             f"{init!r}")

        def norm(dim):
            return L.RMSNorm(dim, cfg.norm_eps, dtype=dtype, device=dev)

        self.ln1 = norm(d)
        for name in ("wq", "wk", "wv", "wo", "bq", "bk", "bv"):
            if name in w:
                setattr(self, name, param(w[name]))
        if cfg.qk_norm:
            self.q_norm, self.k_norm = norm(hd), norm(hd)
        self.attn = Attention(cfg.attn_kind, cfg.local_window)
        self.ln2 = norm(d)
        self.w_gate, self.w_up = param(w["w_gate"]), param(w["w_up"])
        self.w_down = param(w["w_down"])

    def _mlp(self, x: torch.Tensor, plan: ExecPlan) -> torch.Tensor:
        p = {"w_gate": self.w_gate, "w_up": self.w_up, "w_down": self.w_down}
        return L.mlp(self.ln2(x, plan), p, self.cfg.mlp_act, plan)

    def forward(self, x: torch.Tensor, plan: Optional[ExecPlan] = None, *,
                positions: Optional[torch.Tensor] = None,
                cache_capacity: Optional[int] = None):
        plan = L.plan_for(x, plan)
        b, s, _ = x.shape
        if positions is None:
            positions = torch.arange(s, device=x.device)
        q, k, v = project_qkv(self.ln1(x, plan), self, self.cfg, plan,
                              positions)
        o = self.attn(q, k, v, plan).reshape(b, s, -1)
        x = x + o @ L.cast(self.wo, L.cdtype(plan))
        x = x + self._mlp(x, plan)
        if cache_capacity is None:
            return x
        return x, self._prefill_cache(k, v, cache_capacity)

    def _prefill_cache(self, k: torch.Tensor, v: torch.Tensor,
                       capacity: int) -> KVCache:
        """The layer's cache after a full-sequence pass: a ring of
        ``local_window`` slots (slot = position % window) for local
        attention, else k/v padded to ``capacity``."""
        s = k.shape[1]
        if self.cfg.attn_kind == "local":
            w = self.cfg.local_window
            if s >= w:
                shift = (s % w) - w
                return KVCache(torch.roll(k[:, -w:], shift, dims=1),
                               torch.roll(v[:, -w:], shift, dims=1))
            capacity = w
        pad = capacity - s
        if pad:
            k = nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
            v = nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        return KVCache(k, v)

    def decode(self, x1: torch.Tensor, cache: KVCache, cache_len: torch.Tensor,
               plan: ExecPlan) -> torch.Tensor:
        """One token x1 (B,1,d) at position ``cache_len`` (a device scalar):
        writes its k/v into ``cache`` in place and attends over it."""
        ring = self.cfg.attn_kind == "local"
        q, k, v = project_qkv(self.ln1(x1, plan), self, self.cfg, plan,
                              cache_len.reshape(1))
        cache_update(cache, k, v, cache_len, ring)
        o = attend_decode(q, cache, cache_len + 1,
                          self.cfg.local_window if ring else 0, plan, ring)
        x1 = x1 + o.reshape(x1.shape[0], 1, -1) @ L.cast(self.wo,
                                                        L.cdtype(plan))
        return x1 + self._mlp(x1, plan)


class LMParams(nn.Module):
    """The parameters of a dense or VLM decoder, as the reference's
    ``init_params`` lays them out: ``embed`` (vocab, d), ``lm_head`` when
    embeddings are untied, ``final_norm``, ``blocks`` (one
    :class:`DenseBlock` a layer) and, for a VLM, ``projector``
    (``vis_w1``, ``vis_b1``, ``vis_w2``, ``vis_b2``).  Drawn from
    ``generator`` (a CPU generator; seed 0 when None) in the reference's
    distributions, then moved to ``device`` (``cuda`` unless ``"cpu"`` is
    asked for) in ``dtype``."""

    def __init__(self, cfg, *, dtype: torch.dtype = torch.float32,
                 device=None, generator: Optional[torch.Generator] = None):
        from repro_torch.core.frontends.export_frontend import resolve_device

        super().__init__()
        check_family(cfg)
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.cfg = cfg

        def param(w):
            return nn.Parameter(w.to(device=dev, dtype=dtype))

        d = cfg.d_model
        self.embed = param(L.embed_init((cfg.vocab, d), generator))
        self.lm_head = None if cfg.tie_embeddings else param(
            L.embed_init((cfg.vocab, d), generator))
        self.final_norm = L.RMSNorm(d, cfg.norm_eps, dtype=dtype, device=dev)
        self.blocks = nn.ModuleList(
            DenseBlock(cfg, dtype=dtype, device=dev, generator=generator,
                       init="reference") for _ in range(cfg.n_layers))
        self.projector = None
        if cfg.vision_patches:
            self.projector = nn.ParameterDict({
                "vis_w1": param(L.dense_init((cfg.vision_dim, d), generator)),
                "vis_b1": param(torch.zeros(d)),
                "vis_w2": param(L.dense_init((d, d), generator)),
                "vis_b2": param(torch.zeros(d))})


def init_params(cfg, generator: Optional[torch.Generator] = None,
                dtype: torch.dtype = torch.float32, device=None) -> LMParams:
    return LMParams(cfg, dtype=dtype, device=device, generator=generator)


# ---------------------------------------------------------------------------
# trunk forward (full sequence)
# ---------------------------------------------------------------------------


def forward_full(params: LMParams, x: torch.Tensor, cfg, plan: ExecPlan,
                 positions: torch.Tensor, want_cache: bool = False,
                 cache_capacity: int = 0) -> tuple:
    """x: (B,S,d) embedded inputs.  Returns (hidden, aux (2,), caches):
    ``caches`` is ``{"kv": [KVCache per layer]}`` when ``want_cache``."""
    cache_capacity = cache_capacity or x.shape[1]
    caches = []
    for blk in params.blocks:
        if want_cache:
            x, kv = blk(x, plan, positions=positions,
                        cache_capacity=cache_capacity)
            caches.append(kv)
        else:
            x = blk(x, plan, positions=positions)
    aux = torch.zeros(2, device=x.device)    # MoE losses: no MoE here
    return x, aux, ({"kv": caches} if want_cache else {})


# ---------------------------------------------------------------------------
# embeddings / head
# ---------------------------------------------------------------------------


def embed_inputs(params: LMParams, cfg, plan: ExecPlan, tokens: torch.Tensor,
                 patch_feats: Optional[torch.Tensor] = None) -> torch.Tensor:
    x = L.embed_tokens(tokens, params.embed, plan, cfg.scale_embeddings)
    if cfg.vision_patches and patch_feats is not None:
        pj, dt = params.projector, L.cdtype(plan)
        v = nn.functional.gelu(
            L.cast(patch_feats, dt) @ L.cast(pj["vis_w1"], dt)
            + L.cast(pj["vis_b1"], dt), approximate="tanh")
        v = v @ L.cast(pj["vis_w2"], dt) + L.cast(pj["vis_b2"], dt)
        x = torch.cat([v, x], dim=1)
    return x


def head_table(params: LMParams) -> torch.Tensor:
    return params.embed if params.lm_head is None else params.lm_head


def lm_logits(params: LMParams, cfg, plan: ExecPlan,
              hidden: torch.Tensor) -> torch.Tensor:
    h = params.final_norm(hidden, plan)
    return L.logits_from_hidden(h, head_table(params), plan, cfg.logit_softcap)


# ---------------------------------------------------------------------------
# loss, prefill, decode
# ---------------------------------------------------------------------------


def lm_loss(params: LMParams, batch: dict, cfg, plan: ExecPlan) -> tuple:
    """Masked next-token cross-entropy (labels < 0 carry no loss; a VLM's
    image prefix carries none).  Returns (loss, {"ce", "loss"})."""
    tokens, labels = batch["tokens"], batch["labels"]
    x = embed_inputs(params, cfg, plan, tokens, batch.get("patch_feats"))
    s_total = x.shape[1]
    positions = torch.arange(s_total, device=x.device)
    hidden, _, _ = forward_full(params, x, cfg, plan, positions)
    hidden = hidden[:, s_total - tokens.shape[1]:]
    hidden = params.final_norm(hidden, plan)
    mask = (labels >= 0).float()
    safe = torch.clamp(labels, min=0)
    if plan.loss_impl == "chunked_vocab":
        nll = L.cross_entropy_chunked(hidden, head_table(params), safe, plan,
                                      cfg.logit_softcap)
    else:
        logits = L.logits_from_hidden(hidden, head_table(params), plan,
                                      cfg.logit_softcap)
        nll = L.cross_entropy_full(logits, safe)
    ce = torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return ce, {"ce": ce, "loss": ce}


def prefill(params: LMParams, cfg, plan: ExecPlan, tokens: torch.Tensor,
            patch_feats: Optional[torch.Tensor] = None,
            cache_capacity: int = 0) -> tuple:
    """Returns (last-token logits (B,1,V), decode state)."""
    s_total = tokens.shape[1] + (cfg.vision_patches if cfg.vision_patches
                                 and patch_feats is not None else 0)
    # first, so that under torch.export this constant lands in the
    # embedding's region, never in a norm's
    cache_len = torch.full((), s_total, dtype=torch.int32,
                           device=tokens.device)
    x = embed_inputs(params, cfg, plan, tokens, patch_feats)
    positions = torch.arange(s_total, device=x.device)
    hidden, _, caches = forward_full(
        params, x, cfg, plan, positions, want_cache=True,
        cache_capacity=max(cache_capacity, s_total))
    logits = lm_logits(params, cfg, plan, hidden[:, -1:])
    return logits, {**caches, "cache_len": cache_len}


def decode_step(params: LMParams, cfg, plan: ExecPlan, token: torch.Tensor,
                state: dict) -> tuple:
    """token: (B,1) int.  Returns (logits (B,1,V), new state); the caches
    are updated in place."""
    cache_len = state["cache_len"]
    x1 = embed_inputs(params, cfg, plan, token)
    for blk, kv in zip(params.blocks, state["kv"]):
        x1 = blk.decode(x1, kv, cache_len, plan)
    return lm_logits(params, cfg, plan, x1), {"kv": state["kv"],
                                              "cache_len": cache_len + 1}


# ---------------------------------------------------------------------------
# the hybrid family's RG-LRU sublayer (slice 2)
# ---------------------------------------------------------------------------


class RecurrentSublayer(nn.Module):
    """One RG-LRU sublayer of a hybrid model at ``cfg``'s widths: ``x +
    rglru(ln1(x))``, then ``+ mlp(ln2(x))``, from a zero recurrence state.

    Runs on ``cuda`` unless ``device="cpu"`` is asked for (raises when CUDA
    is wanted and absent).  Weights are drawn from ``generator`` (a CPU
    ``torch.Generator``; seed 0 when None) in the shapes and distributions
    of the reference's ``rglru_init`` and ``mlp_init``, except that the two
    projections that write into the residual stream (``rglru.w_out``,
    ``w_down``) are scaled by 1/sqrt(2 * n_layers), as in
    :class:`DenseBlock`: it keeps the sublayer's outputs where bf16
    resolves the verifier's 1e-2.  ``rglru.lam`` stays f32, as in the
    reference; norm scales start at zero.
    """

    def __init__(self, cfg, *, dtype: torch.dtype = torch.float32,
                 device=None, generator: Optional[torch.Generator] = None):
        from repro_torch.core.frontends.export_frontend import resolve_device

        super().__init__()
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.cfg = cfg
        d, ff = cfg.d_model, cfg.d_ff
        out_scale = 1.0 / math.sqrt(2 * max(cfg.n_layers, 1))

        def param(w, dt=dtype):
            return nn.Parameter(w.to(device=dev, dtype=dt))

        self.ln1 = L.RMSNorm(d, cfg.norm_eps, dtype=dtype, device=dev)
        rg = rglru_init(cfg, generator)
        rg["w_out"] = rg["w_out"] * out_scale
        self.rglru = nn.ParameterDict(
            {k: param(w, torch.float32 if k == "lam" else dtype)
             for k, w in rg.items()})
        self.scan = LinearRecurrence()
        self.ln2 = L.RMSNorm(d, cfg.norm_eps, dtype=dtype, device=dev)
        self.w_gate = param(L.dense_init((d, ff), generator))
        self.w_up = param(L.dense_init((d, ff), generator))
        self.w_down = param(L.dense_init((ff, d), generator) * out_scale)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        plan = L.plan_for(x, None)
        x = x + rglru_block(self.ln1(x), self.rglru, self.cfg, self.scan)
        p = {"w_gate": self.w_gate, "w_up": self.w_up, "w_down": self.w_down}
        return x + L.mlp_ref(self.ln2(x), p, self.cfg.mlp_act, plan)

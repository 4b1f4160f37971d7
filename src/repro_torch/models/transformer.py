"""Port of ``repro/models/transformer.py``: the decoder-only LM's
parameters (:class:`LMParams`, drawn as the reference's ``init_params``
draws them), ``embed_inputs`` (with the VLM projector and the SSM
embedding LayerNorm), ``head_table``, ``lm_logits``, ``forward_full``,
``lm_loss`` (forward, with the MoE auxiliary losses), ``prefill`` and
``decode_step``, for the dense, VLM, MoE, hybrid (RecurrentGemma) and SSM
(RWKV-6) families.

Layers are modules, not stacked leaves.  A dense, VLM or MoE model's
``blocks`` is an ``nn.ModuleList`` of :class:`DenseBlock` (a MoE block
holds a :class:`~repro_torch.models.moe.MoE` where a dense block holds its
MLP weights); its decode state is ``{"kv": [KVCache per layer],
"cache_len": int32 device scalar}``.  A hybrid model holds ``pre_blocks``
(the ``n_layers % len(block_pattern)`` leading RG-LRU sublayers) and
``blocks`` (one ``nn.ModuleDict`` a macro block, ``sub0``, ``sub1``, ... in
``block_pattern`` order: a :class:`RecurrentSublayer` for ``rglru``, a
local-attention :class:`DenseBlock` otherwise).  An SSM model's ``blocks``
is an ``nn.ModuleList`` of :class:`RWKVBlock`.  The decode state keeps the
reference's keys with a list per layer where the reference stacks over
layers::

    {"pre_rglru": [RGLRUState per pre-block],          (only when any)
     "macro_rglru": [{"rglru0": RGLRUState, "rglru1": RGLRUState} a macro],
     "macro_kv": [KVCache (a ring of local_window slots) a macro],
     "cache_len": int32 device scalar}                 (hybrid)
    {"rwkv": [RWKVState(wkv, shift_tm, shift_cm) per layer],
     "cache_len": int32 device scalar}                 (SSM)

(the reference: ``pre_rglru`` / ``macro_rglru[f"rglru{j}"]`` as ``{"h",
"conv"}`` stacked on axis 0, ``macro_kv`` as ``{"k", "v"}`` stacked,
``rwkv`` as ``{"wkv", "shift_tm", "shift_cm"}`` stacked).  A decode step
writes each KV cache in place (the reference's donated state), returns new
RG-LRU and RWKV states, and ``cache_len + 1``.  The enc-dec family lives
in ``whisper.py``.  The plan's ``remat`` checkpoints each layer body
where the reference's ``_maybe_remat`` does, whenever autograd records
(:func:`_maybe_remat`).  Under a mesh's rules (``runtime/pspec.py``) the
residual updates, the embeddings, the logits and the KV caches are
``constrain``-ed as in the reference (the caches by ``cache_axes``, heads
over ``model`` or else the cache sequence); without rules each is the
identity.  ``gather_mode`` and ``gather_dtype`` shape the reference's XLA
gathers and have no counterpart under DTensor.

``RMSNorm``, ``LayerNorm``, ``Attention``, the MoE's ``Router``, the
RG-LRU's ``LinearRecurrence`` and RWKV's ``WKVRecurrence`` are
submodules, so the export frontend isolates them as regions; the
projection and MLP weights sit on the block in the reference's (in, out)
layout.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.models import layers as L
from repro_torch.models.attention import (Attention, KVCache, attend_decode,
                                          attn_init, cache_axes, cache_update,
                                          project_qkv)
from repro_torch.models.moe import MoE
from repro_torch.models.plan import ExecPlan
from repro_torch.models.rglru import (LinearRecurrence, RGLRUState,
                                      rglru_block, rglru_init)
from repro_torch.models.rwkv import (RWKVState, WKVRecurrence, channel_mix,
                                     rwkv_init, time_mix)
from repro_torch.runtime.pspec import (axis_rules, constrain, current_rules,
                                       model_divides)

__all__ = ["DenseBlock", "INIT_STD", "LMParams", "RWKVBlock",
           "RecurrentSublayer", "check_family", "decode_step",
           "embed_inputs", "forward_full", "head_table", "init_params",
           "lm_logits", "lm_loss", "prefill"]

#: weight init std of the ``scaled`` block init: Qwen3's published
#: ``initializer_range``
INIT_STD = 0.02


#: the ops whose outputs the ``dots`` policy saves: the 2-D matmuls (a
#: projection of (B, S, d) activations lowers to one), the reference's
#: ``dots_with_no_batch_dims_saveable``; batched ``bmm`` is recomputed
_SAVED_BY_DOTS = frozenset({torch.ops.aten.mm.default,
                            torch.ops.aten.addmm.default})


def _save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return CheckpointPolicy.MUST_SAVE if op in _SAVED_BY_DOTS \
        else CheckpointPolicy.PREFER_RECOMPUTE


def _dots_contexts():
    """The selective-checkpoint contexts of the ``dots`` policy.  A
    ``scan`` (the RG-LRU ``step`` and RWKV scans) never reaches them:
    ``layers.remat_safe_scan`` pops them while it runs, and the scan is
    recomputed whole."""
    return create_selective_checkpoint_contexts(_save_dots)


def _under_rules(fn, rules, *args, **kwargs):
    """``fn`` under ``rules``: a checkpoint's recompute runs in the
    backward, on the autograd engine's thread for the device (the card's
    own thread), where the caller's thread-local rules are not."""
    with axis_rules(rules):
        return fn(*args, **kwargs)


def _maybe_remat(fn, plan: ExecPlan):
    """``fn`` checkpointed under ``plan.remat`` while autograd records (the
    reference's ``_maybe_remat``): ``"none"`` keeps every activation,
    ``"dots"`` keeps the matmul outputs and recomputes the rest, ``"full"``
    keeps only the inputs.  Without grad (a forward, an export) ``fn`` runs
    as it is."""
    if plan.remat == "none" or not torch.is_grad_enabled():
        return fn
    rules = current_rules()
    if rules is not None:
        fn = functools.partial(_under_rules, fn, rules)
    if plan.remat == "dots":
        return functools.partial(checkpoint, fn, use_reentrant=False,
                                 context_fn=_dots_contexts)
    return functools.partial(checkpoint, fn, use_reentrant=False)


def _merge_heads(o: torch.Tensor) -> torch.Tensor:
    """(B, S, H, D) -> (B, S, H * D).  Under a mesh's rules with heads that
    ``model`` does not divide (10 at RecurrentGemma-2B's width over 16
    ranks), the merge runs in ``local_map`` on each rank's batch rows: its
    backward would view the output projection's gradient, sharded over
    ``model``, into those heads (:func:`model_divides`)."""
    from repro_torch.runtime.pspec import local_map

    b, s, h, _ = o.shape
    if model_divides(h):
        return o.reshape(b, s, -1)
    bspec = current_rules().resolve("batch", b)
    return local_map(lambda t: t.flatten(2), ((bspec, None, None, None),),
                     (bspec, None, None), o)


def check_family(cfg) -> None:
    """Raise ``ValueError`` unless ``cfg`` is a dense, VLM, MoE, hybrid,
    SSM or enc-dec model this port runs (never treat another family as
    dense)."""
    family = "moe" if cfg.moe is not None else cfg.family
    if family not in ("dense", "vlm", "moe", "hybrid", "ssm", "encdec"):
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

    With ``cfg.moe`` set the block's feed-forward is a
    :class:`~repro_torch.models.moe.MoE` (``self.moe``), drawn by the
    reference's ``moe_init`` in either init, in place of the gated MLP.

    ``forward(x)`` is the full-sequence block under the plan (the
    reference form in x's dtype when none is given); with
    ``cache_capacity`` it also returns the layer's :class:`KVCache`
    (prefill), and with ``with_aux`` (a MoE block) the layer's MoE losses
    (load balance, router z) as a (2,) tensor, last.  :meth:`decode` is
    one token against that cache.
    """

    def __init__(self, cfg, *, dtype: torch.dtype = torch.float32,
                 device=None, generator: Optional[torch.Generator] = None,
                 init: str = "scaled"):
        from repro_torch.core.frontends.export_frontend import resolve_device

        super().__init__()
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
            if cfg.moe is None:
                w.update(w_gate=weight(d, ff), w_up=weight(d, ff),
                         w_down=weight(ff, d, std=out_std))
            if cfg.qkv_bias:
                w.update(bq=torch.zeros(nq * hd), bk=torch.zeros(nkv * hd),
                         bv=torch.zeros(nkv * hd))
        elif init == "reference":
            w = attn_init(cfg, generator)
            w.pop("q_norm", None)
            w.pop("k_norm", None)
            if cfg.moe is None:
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
        if cfg.moe is not None:
            self.moe = MoE(cfg, dtype=dtype, device=dev, generator=generator)
        else:
            self.w_gate, self.w_up = param(w["w_gate"]), param(w["w_up"])
            self.w_down = param(w["w_down"])

    def _ffn(self, x: torch.Tensor, plan: ExecPlan) -> tuple:
        """The second sublayer's update from the residual ``x``, and the
        MoE losses as a (2,) tensor (None for a dense block)."""
        h = self.ln2(x, plan)
        if self.cfg.moe is not None:
            y, aux = self.moe(h, plan)
            return y, torch.stack([aux.load_balance, aux.router_z])
        p = {"w_gate": self.w_gate, "w_up": self.w_up, "w_down": self.w_down}
        return L.mlp(h, p, self.cfg.mlp_act, plan), None

    def forward(self, x: torch.Tensor, plan: Optional[ExecPlan] = None, *,
                positions: Optional[torch.Tensor] = None,
                cache_capacity: Optional[int] = None, with_aux: bool = False):
        plan = L.plan_for(x, plan)
        b, s, _ = x.shape
        if positions is None:
            positions = torch.arange(s, device=x.device)
        q, k, v = project_qkv(self.ln1(x, plan), self, self.cfg, plan,
                              positions)
        o = _merge_heads(self.attn(q, k, v, plan))
        x = x + constrain(o @ L.cast(self.wo, L.cdtype(plan)),
                          "batch", "seq", None)
        y, aux = self._ffn(x, plan)
        out = (x + constrain(y, "batch", "seq", None),)
        if cache_capacity is not None:
            out += (self._prefill_cache(k, v, cache_capacity),)
        if with_aux:
            out += (aux,)
        return out if len(out) > 1 else out[0]

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
        cax = cache_axes(self.cfg.n_kv_heads)
        return KVCache(constrain(k, *cax), constrain(v, *cax))

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
        return x1 + self._ffn(x1, plan)[0]


class LMParams(nn.Module):
    """The parameters of a decoder, as the reference's ``init_params`` lays
    them out: ``embed`` (vocab, d), ``lm_head`` when embeddings are untied,
    ``final_norm``, ``blocks`` (dense, VLM and MoE: one :class:`DenseBlock`
    a layer; hybrid: one ``nn.ModuleDict`` of ``sub0``.. a macro block;
    SSM: one :class:`RWKVBlock` a layer), for a hybrid model
    ``pre_blocks`` (the leading RG-LRU sublayers that fill no macro block),
    for an SSM model ``embed_norm`` (the embedding's LayerNorm, the
    reference's ``embed_norm_s`` and ``embed_norm_b``) and, for a VLM,
    ``projector`` (``vis_w1``, ``vis_b1``, ``vis_w2``, ``vis_b2``).  Drawn
    from ``generator`` (a CPU generator; seed 0 when None) in the
    reference's distributions and moved to ``device`` (``cuda`` unless
    ``"cpu"`` is asked for) in ``dtype`` as drawn, so the host holds one
    block's weights at most (a MoE block's, one expert tensor); the RG-LRU
    ``lam`` and the MoE router stay f32, as in the reference."""

    def __init__(self, cfg, *, dtype: torch.dtype = torch.float32,
                 device=None, generator: Optional[torch.Generator] = None):
        from repro_torch.core.frontends.export_frontend import resolve_device

        super().__init__()
        check_family(cfg)
        if cfg.family == "encdec":
            raise ValueError(f"{cfg.arch_id}: an enc-dec model's parameters "
                             f"are whisper.WhisperParams, not LMParams")
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
        self.pre_blocks = self.embed_norm = None
        if cfg.family == "ssm":
            self.embed_norm = L.LayerNorm(d, cfg.norm_eps, dtype=dtype,
                                          device=dev)
            self.blocks = nn.ModuleList(
                RWKVBlock(cfg, dtype=dtype, device=dev, generator=generator)
                for _ in range(cfg.n_layers))
        elif cfg.family == "hybrid":
            def sub(kind):
                if kind == "rglru":
                    return RecurrentSublayer(cfg, dtype=dtype, device=dev,
                                             generator=generator,
                                             init="reference")
                return DenseBlock(cfg, dtype=dtype, device=dev,
                                  generator=generator, init="reference")

            n_macro, rem = divmod(cfg.n_layers, len(cfg.block_pattern))
            if rem:
                self.pre_blocks = nn.ModuleList(sub("rglru")
                                                for _ in range(rem))
            self.blocks = nn.ModuleList(
                nn.ModuleDict({f"sub{j}": sub(kind) for j, kind
                               in enumerate(cfg.block_pattern)})
                for _ in range(n_macro))
        else:
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
    ``aux`` sums the MoE blocks' (load balance, router z) losses (zeros
    without MoE); with ``want_cache``, ``caches`` is ``{"kv": [KVCache per
    layer]}`` (a hybrid model: ``pre_rglru``, ``macro_rglru`` and
    ``macro_kv``; an SSM model: ``rwkv``)."""
    cache_capacity = cache_capacity or x.shape[1]
    aux = torch.zeros(2, device=x.device)
    if cfg.family == "hybrid":
        x, caches = _hybrid_full(params, x, cfg, plan, positions, want_cache)
        return x, aux, caches
    if cfg.family == "ssm":
        states = []
        for blk in params.blocks:
            x, st = _maybe_remat(blk, plan)(x, plan)
            states.append(st)
        return x, aux, ({"rwkv": states} if want_cache else {})
    moe = cfg.moe is not None
    caches = []
    for blk in params.blocks:
        out = _maybe_remat(blk, plan)(
            x, plan, positions=positions, with_aux=moe,
            cache_capacity=cache_capacity if want_cache else None)
        out = out if isinstance(out, tuple) else (out,)
        x = out[0]
        if want_cache:
            caches.append(out[1])
        if moe:
            aux = aux + out[-1]
    return x, aux, ({"kv": caches} if want_cache else {})


def _hybrid_full(params: LMParams, x: torch.Tensor, cfg, plan: ExecPlan,
                 positions: torch.Tensor, want_cache: bool) -> tuple:
    """The reference's hybrid trunk: the pre-blocks, then each macro block's
    sublayers in ``block_pattern`` order (``_hybrid_macro_full``)."""
    pre = []
    for sub in params.pre_blocks or ():
        x, st = sub(x, plan, with_state=True)
        pre.append(st)
    macro_rglru, macro_kv = [], []
    for blk in params.blocks:
        x, states, kv = _maybe_remat(_hybrid_macro, plan)(
            blk, x, cfg, plan, positions, want_cache)
        macro_rglru.append(states)
        macro_kv.append(kv)
    if not want_cache:
        return x, {}
    caches = {"macro_rglru": macro_rglru, "macro_kv": macro_kv}
    if pre:
        caches["pre_rglru"] = pre
    return x, caches


def _hybrid_macro(blk: nn.ModuleDict, x: torch.Tensor, cfg, plan: ExecPlan,
                  positions: torch.Tensor, want_cache: bool) -> tuple:
    """One macro block's sublayers in ``block_pattern`` order (the
    reference's ``_hybrid_macro_full``): (x, {"rglru{j}": RGLRUState},
    the local attention's ring cache or None)."""
    states, kv = {}, None
    for j, kind in enumerate(cfg.block_pattern):
        sub = blk[f"sub{j}"]
        if kind == "rglru":
            x, states[f"rglru{j}"] = sub(x, plan, with_state=True)
        elif want_cache:
            x, kv = sub(x, plan, positions=positions,
                        cache_capacity=cfg.local_window)
        else:
            x = sub(x, plan, positions=positions)
    return x, states, kv


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
    if cfg.family == "ssm":
        x = params.embed_norm(x)
    return constrain(x, "batch", "seq", None)


def head_table(params: LMParams) -> torch.Tensor:
    return params.embed if params.lm_head is None else params.lm_head


def lm_logits(params: LMParams, cfg, plan: ExecPlan,
              hidden: torch.Tensor) -> torch.Tensor:
    h = params.final_norm(hidden, plan)
    out = L.logits_from_hidden(h, head_table(params), plan, cfg.logit_softcap)
    return constrain(out, "batch", "seq", "vocab")


# ---------------------------------------------------------------------------
# loss, prefill, decode
# ---------------------------------------------------------------------------


def lm_loss(params: LMParams, batch: dict, cfg, plan: ExecPlan) -> tuple:
    """Masked next-token cross-entropy (labels < 0 carry no loss; a VLM's
    image prefix carries none), plus, for a MoE model, ``aux_loss`` times
    the mean load-balance loss and ``router_z_loss`` times the mean router
    z-loss over the layers.  Returns (loss, {"ce", "loss"} and, for a MoE
    model, "moe_lb" and "moe_z")."""
    tokens, labels = batch["tokens"], batch["labels"]
    x = embed_inputs(params, cfg, plan, tokens, batch.get("patch_feats"))
    s_total = x.shape[1]
    positions = torch.arange(s_total, device=x.device)
    hidden, aux, _ = forward_full(params, x, cfg, plan, positions)
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
    metrics = {"ce": ce}
    loss = ce
    if cfg.moe is not None:
        lb, z = aux[0] / cfg.n_layers, aux[1] / cfg.n_layers
        loss = loss + cfg.moe.aux_loss * lb + cfg.moe.router_z_loss * z
        metrics.update(moe_lb=lb, moe_z=z)
    metrics["loss"] = loss
    return loss, metrics


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
    """token: (B,1) int.  Returns (logits (B,1,V), new state); the KV
    caches are updated in place, RG-LRU and RWKV states replaced."""
    cache_len = state["cache_len"]
    x1 = embed_inputs(params, cfg, plan, token)
    new_state = {"cache_len": cache_len + 1}
    if cfg.family == "ssm":
        rwkv = []
        for blk, st in zip(params.blocks, state["rwkv"]):
            x1, st = blk(x1, plan, state=st)
            rwkv.append(st)
        new_state["rwkv"] = rwkv
    elif cfg.family == "hybrid":
        pre = []
        for sub, st in zip(params.pre_blocks or (), state.get("pre_rglru", ())):
            x1, st = sub(x1, plan, state=st, with_state=True)
            pre.append(st)
        if pre:
            new_state["pre_rglru"] = pre
        macro_rglru = []
        for blk, rg, kv in zip(params.blocks, state["macro_rglru"],
                               state["macro_kv"]):
            new_rg = {}
            for j, kind in enumerate(cfg.block_pattern):
                sub = blk[f"sub{j}"]
                if kind == "rglru":
                    x1, new_rg[f"rglru{j}"] = sub(
                        x1, plan, state=rg[f"rglru{j}"], with_state=True)
                else:
                    x1 = sub.decode(x1, kv, cache_len, plan)
            macro_rglru.append(new_rg)
        new_state.update(macro_rglru=macro_rglru, macro_kv=state["macro_kv"])
    else:
        for blk, kv in zip(params.blocks, state["kv"]):
            x1 = blk.decode(x1, kv, cache_len, plan)
        new_state["kv"] = state["kv"]
    return lm_logits(params, cfg, plan, x1), new_state


# ---------------------------------------------------------------------------
# the hybrid family's RG-LRU sublayer
# ---------------------------------------------------------------------------


class RecurrentSublayer(nn.Module):
    """One RG-LRU sublayer of a hybrid model at ``cfg``'s widths: ``x +
    rglru(ln1(x))``, then ``+ mlp(ln2(x))`` (the reference's
    ``_rglru_sublayer_full`` and ``_rglru_sublayer_decode``).

    Runs on ``cuda`` unless ``device="cpu"`` is asked for (raises when CUDA
    is wanted and absent).  Weights are drawn from ``generator`` (a CPU
    ``torch.Generator``; seed 0 when None) in the shapes and distributions
    of the reference's ``rglru_init`` and ``mlp_init``.  ``init="scaled"``
    (a lone sublayer) scales the two projections that write into the
    residual stream (``rglru.w_out``, ``w_down``) by 1/sqrt(2 * n_layers),
    as in :class:`DenseBlock`: it keeps the sublayer's outputs where bf16
    resolves the verifier's 1e-2; ``init="reference"`` (a whole model)
    leaves them as drawn.  ``rglru.lam`` stays f32, as in the reference;
    norm scales start at zero.

    ``forward(x, plan, state=None, with_state=False)`` runs the sublayer
    under the plan (the reference form in x's dtype when none is given)
    from ``state`` (an :class:`~repro_torch.models.rglru.RGLRUState`; zero
    when None) and, with ``with_state``, also returns the new state.
    """

    def __init__(self, cfg, *, dtype: torch.dtype = torch.float32,
                 device=None, generator: Optional[torch.Generator] = None,
                 init: str = "scaled"):
        from repro_torch.core.frontends.export_frontend import resolve_device

        super().__init__()
        if init not in ("scaled", "reference"):
            raise ValueError(f"init must be 'scaled' or 'reference', not "
                             f"{init!r}")
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.cfg = cfg
        d, ff = cfg.d_model, cfg.d_ff
        out_scale = 1.0 / math.sqrt(2 * max(cfg.n_layers, 1)) \
            if init == "scaled" else 1.0

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

    def forward(self, x: torch.Tensor, plan: Optional[ExecPlan] = None, *,
                state: Optional[RGLRUState] = None, with_state: bool = False):
        plan = L.plan_for(x, plan)
        y, new_state = rglru_block(self.ln1(x, plan), self.rglru, self.cfg,
                                   plan, self.scan, state)
        x = x + constrain(y, "batch", "seq", None)
        p = {"w_gate": self.w_gate, "w_up": self.w_up, "w_down": self.w_down}
        x = x + L.mlp(self.ln2(x, plan), p, self.cfg.mlp_act, plan)
        return (x, new_state) if with_state else x


# ---------------------------------------------------------------------------
# the SSM family's RWKV-6 block
# ---------------------------------------------------------------------------


class RWKVBlock(nn.Module):
    """One RWKV-6 block at ``cfg``'s widths (the reference's
    ``_rwkv_block_full``): ``x + time_mix(ln1(x))``, then ``+
    channel_mix(ln2(x))``, each half token-shifted from ``state`` (zeros
    when None).  ``ln1`` and ``ln2`` are :class:`~repro_torch.models.layers.
    LayerNorm` submodules (the reference's ``ln1_s``/``ln1_b``,
    ``ln2_s``/``ln2_b``), ``tm_cm`` the reference's ``rwkv_init`` leaves
    drawn from ``generator`` in its distributions, and ``wkv`` the
    :class:`~repro_torch.models.rwkv.WKVRecurrence` scan.  Runs on
    ``cuda`` unless ``device="cpu"`` is asked for.

    ``forward(x, plan, state=None)`` -> (x, the new
    :class:`~repro_torch.models.rwkv.RWKVState`).
    """

    def __init__(self, cfg, *, dtype: torch.dtype = torch.float32,
                 device=None, generator: Optional[torch.Generator] = None):
        from repro_torch.core.frontends.export_frontend import resolve_device

        super().__init__()
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.cfg = cfg
        d = cfg.d_model
        self.ln1 = L.LayerNorm(d, cfg.norm_eps, dtype=dtype, device=dev)
        self.ln2 = L.LayerNorm(d, cfg.norm_eps, dtype=dtype, device=dev)
        self.tm_cm = nn.ParameterDict(
            {k: nn.Parameter(w.to(device=dev, dtype=dtype))
             for k, w in rwkv_init(cfg, generator).items()})
        self.wkv = WKVRecurrence()

    def forward(self, x: torch.Tensor, plan: Optional[ExecPlan] = None, *,
                state: Optional[RWKVState] = None) -> tuple:
        plan = L.plan_for(x, plan)
        y, wkv, last_tm = time_mix(self.ln1(x), self.tm_cm, self.cfg, plan,
                                   state, self.wkv)
        x = x + constrain(y, "batch", "seq", None)
        y2, last_cm = channel_mix(self.ln2(x), self.tm_cm, self.cfg, plan,
                                  state)
        return x + y2, RWKVState(wkv, last_tm, last_cm)

"""Port of ``repro/models/whisper.py``: the Whisper-small backbone, a
transformer encoder-decoder.

The conv/mel frontend is a stub, as in the reference: the encoder takes
precomputed frame embeddings (B, encoder_seq, d_model).  Positions are
sinusoidal (:func:`sinusoid_positions`, computed on the fly, so any decoder
length works).  A decoder block is causal self-attention, cross-attention
to the encoder output, and the MLP.

Layers are modules, not stacked leaves, as in the other families
(``transformer.py``): :class:`WhisperParams` holds ``embed`` (tied: the
logits read it too), ``final_norm``, ``enc_final_norm``, ``enc_blocks``
(an ``nn.ModuleList`` of :class:`EncoderBlock`) and ``blocks`` (of
:class:`DecoderBlock`).  Each ``RMSNorm`` and each attention core
(:class:`~repro_torch.models.attention.Attention`: a causal one for the
decoder's self-attention, non-causal ones for the encoder and the
cross-attention) is a submodule, so the export frontend isolates it as a
region; the projection and MLP weights sit on the block in the
reference's (in, out) layout, the cross-attention's in the ``xattn``
``ParameterDict``.

The decode state keeps the reference's keys with a list per layer where
the reference stacks over layers::

    {"dec": [{"k", "v", "xk", "xv"} per layer],
     "cache_len": int32 device scalar}

``k``/``v`` are padded to the cache capacity and written in place by a
decode step; ``xk``/``xv`` (the cross-attention's keys and values over the
encoder output) are computed once in :func:`prefill` and only read after.
Under a mesh's rules the inputs, the self-attention updates, the caches
and the logits are ``constrain``-ed where the reference constrains them.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from repro_torch.models import layers as L
from repro_torch.models.attention import (Attention, KVCache, attend_decode,
                                          attn_init, cache_axes, cache_update,
                                          project_kv, project_q, project_qkv)
from repro_torch.models.plan import ExecPlan
from repro_torch.models.transformer import _maybe_remat
from repro_torch.runtime.pspec import constrain

__all__ = ["DecoderBlock", "EncoderBlock", "WhisperParams", "decode_step",
           "decoder_forward", "encode", "init_params", "lm_loss", "prefill",
           "sinusoid_positions"]


def sinusoid_positions(s: int, d: int, offset=0,
                       device=None) -> torch.Tensor:
    """(s, d) f32: sin then cos of positions ``offset + arange(s)`` (an int
    or a device scalar) over d / 2 geometric frequencies."""
    pos = torch.arange(s, dtype=torch.float32, device=device) + offset
    inv = torch.exp(-torch.arange(0, d, 2, dtype=torch.float32,
                                  device=device) / d * math.log(10000.0))
    ang = pos[:, None] * inv[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _param(w: torch.Tensor, dtype: torch.dtype, dev) -> nn.Parameter:
    return nn.Parameter(w.to(device=dev, dtype=dtype))


class _Block(nn.Module):
    """What both blocks share: ``ln1``, ``ln2``, the self-attention
    weights (the reference's ``attn_init``) and core, and the MLP, drawn
    from ``generator`` in the reference's distributions on ``dev`` in
    ``dtype``."""

    def __init__(self, cfg, dtype: torch.dtype, dev: torch.device,
                 generator: torch.Generator, causal: bool):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        self.ln1 = L.RMSNorm(d, cfg.norm_eps, dtype=dtype, device=dev)
        self.ln2 = L.RMSNorm(d, cfg.norm_eps, dtype=dtype, device=dev)
        weights = {**attn_init(cfg, generator),
                   **L.mlp_init(d, cfg.d_ff, generator)}
        for name, w in weights.items():
            setattr(self, name, _param(w, dtype, dev))
        self.attn = Attention(causal=causal)

    def _self_attention(self, x: torch.Tensor, plan: ExecPlan,
                        positions: torch.Tensor) -> tuple:
        """x + the self-attention's update, and its k, v."""
        b, s, _ = x.shape
        q, k, v = project_qkv(self.ln1(x, plan), self, self.cfg, plan,
                              positions)
        o = self.attn(q, k, v, plan).reshape(b, s, -1)
        return x + constrain(o @ L.cast(self.wo, L.cdtype(plan)),
                             "batch", "seq", None), k, v

    def _mlp(self, x: torch.Tensor, plan: ExecPlan) -> torch.Tensor:
        p = {"w_gate": self.w_gate, "w_up": self.w_up, "w_down": self.w_down}
        return x + L.mlp(self.ln2(x, plan), p, self.cfg.mlp_act, plan)


class EncoderBlock(_Block):
    """One pre-norm encoder block: non-causal self-attention, then the
    MLP."""

    def __init__(self, cfg, *, dtype: torch.dtype, device,
                 generator: torch.Generator):
        super().__init__(cfg, dtype, device, generator, causal=False)

    def forward(self, x: torch.Tensor, plan: ExecPlan,
                positions: torch.Tensor) -> torch.Tensor:
        x, _, _ = self._self_attention(x, plan, positions)
        return self._mlp(x, plan)


class DecoderBlock(_Block):
    """One pre-norm decoder block: causal self-attention (``ln1``,
    ``attn``), cross-attention to the encoder output (``ln_x``, the
    ``xattn`` weights, the non-causal ``cross`` core), then the MLP."""

    def __init__(self, cfg, *, dtype: torch.dtype, device,
                 generator: torch.Generator):
        super().__init__(cfg, dtype, device, generator, causal=True)
        self.ln_x = L.RMSNorm(cfg.d_model, cfg.norm_eps, dtype=dtype,
                              device=device)
        self.xattn = nn.ParameterDict(
            {k: _param(w, dtype, device)
             for k, w in attn_init(cfg, generator).items()})
        self.cross = Attention(causal=False)

    def _cross_out(self, x: torch.Tensor, o: torch.Tensor,
                   plan: ExecPlan) -> torch.Tensor:
        """x + the cross-attention's output ``o`` (B,S,Hq,D) projected."""
        b, s, _ = x.shape
        return x + o.reshape(b, s, -1) @ L.cast(self.xattn.wo,
                                                L.cdtype(plan))

    def forward(self, x: torch.Tensor, enc_out: torch.Tensor,
                plan: ExecPlan, positions: torch.Tensor,
                enc_pos: torch.Tensor, cache_capacity: Optional[int] = None):
        """The full-sequence block; with ``cache_capacity`` also the
        layer's decode state ``{"k", "v"}`` (padded to the capacity) and
        ``{"xk", "xv"}``."""
        x, k, v = self._self_attention(x, plan, positions)
        qx = project_q(self.ln_x(x, plan), self.xattn, self.cfg, plan,
                       positions)
        kx, vx = project_kv(enc_out, self.xattn, self.cfg, plan, enc_pos)
        x = self._mlp(self._cross_out(x, self.cross(qx, kx, vx, plan), plan),
                      plan)
        if cache_capacity is None:
            return x
        pad = cache_capacity - k.shape[1]
        if pad:
            k = nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
            v = nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        cax = cache_axes(self.cfg.n_kv_heads)
        return x, {"k": constrain(k, *cax), "v": constrain(v, *cax),
                   "xk": constrain(kx, *cax), "xv": constrain(vx, *cax)}

    def decode(self, x1: torch.Tensor, kv: dict, cache_len: torch.Tensor,
               plan: ExecPlan) -> torch.Tensor:
        """One token x1 (B,1,d) at position ``cache_len`` (a device
        scalar): writes its k/v into ``kv`` in place and attends over it,
        then over the whole cross cache."""
        pos = cache_len.reshape(1)
        q, k, v = project_qkv(self.ln1(x1, plan), self, self.cfg, plan, pos)
        cache = cache_update(KVCache(kv["k"], kv["v"]), k, v, cache_len,
                             False)
        o = attend_decode(q, cache, cache_len + 1, 0, plan, False)
        x1 = x1 + o.reshape(x1.shape[0], 1, -1) @ L.cast(self.wo,
                                                        L.cdtype(plan))
        qx = project_q(self.ln_x(x1, plan), self.xattn, self.cfg, plan, pos)
        ox = attend_decode(qx, KVCache(kv["xk"], kv["xv"]), kv["xk"].shape[1],
                           0, plan, False)
        return self._mlp(self._cross_out(x1, ox, plan), plan)


class WhisperParams(nn.Module):
    """The parameters of the encoder-decoder, as the reference's
    ``init_params`` lays them out: ``embed`` (vocab, d), tied;
    ``final_norm``, ``enc_final_norm``; ``enc_blocks`` and ``blocks``.
    Drawn from ``generator`` (a CPU generator; seed 0 when None) in the
    reference's distributions and moved to ``device`` (``cuda`` unless
    ``"cpu"`` is asked for) in ``dtype`` as drawn, a tensor at a time."""

    def __init__(self, cfg, *, dtype: torch.dtype = torch.float32,
                 device=None, generator: Optional[torch.Generator] = None):
        from repro_torch.core.frontends.export_frontend import resolve_device

        super().__init__()
        if cfg.family != "encdec":
            raise ValueError(f"{cfg.arch_id}: WhisperParams holds the "
                             f"enc-dec family, not {cfg.family!r}")
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.cfg = cfg
        d = cfg.d_model
        self.embed = _param(L.embed_init((cfg.vocab, d), generator), dtype,
                            dev)
        self.final_norm = L.RMSNorm(d, cfg.norm_eps, dtype=dtype, device=dev)
        self.enc_final_norm = L.RMSNorm(d, cfg.norm_eps, dtype=dtype,
                                        device=dev)
        self.enc_blocks = nn.ModuleList(
            EncoderBlock(cfg, dtype=dtype, device=dev, generator=generator)
            for _ in range(cfg.n_encoder_layers))
        self.blocks = nn.ModuleList(
            DecoderBlock(cfg, dtype=dtype, device=dev, generator=generator)
            for _ in range(cfg.n_layers))


def init_params(cfg, generator: Optional[torch.Generator] = None,
                dtype: torch.dtype = torch.float32,
                device=None) -> WhisperParams:
    return WhisperParams(cfg, dtype=dtype, device=device, generator=generator)


# ---------------------------------------------------------------------------
# encoder, decoder
# ---------------------------------------------------------------------------


def encode(params: WhisperParams, cfg, plan: ExecPlan,
           frames: torch.Tensor) -> torch.Tensor:
    """frames: (B, T_enc, d) stub embeddings -> (B, T_enc, d)."""
    dt = L.cdtype(plan)
    t_enc = frames.shape[1]
    # before the first input-derived op: under torch.export these constants
    # land in this root region, never in a norm's
    positions = torch.arange(t_enc, device=frames.device)
    pe = sinusoid_positions(t_enc, cfg.d_model, device=frames.device)
    x = constrain(L.cast(frames, dt) + L.cast(pe, dt), "batch", "seq", None)
    for blk in params.enc_blocks:
        x = _maybe_remat(blk, plan)(x, plan, positions)
    return params.enc_final_norm(x, plan)


def decoder_forward(params: WhisperParams, cfg, plan: ExecPlan,
                    tokens: torch.Tensor, enc_out: torch.Tensor,
                    want_cache: bool = False,
                    cache_capacity: int = 0) -> tuple:
    """Returns (hidden (B,S,d), [the layers' decode states] with
    ``want_cache``, else None)."""
    dt = L.cdtype(plan)
    s = tokens.shape[1]
    cache_capacity = cache_capacity or s
    # before the embedding, for the reason ``encode`` gives
    positions = torch.arange(s, device=tokens.device)
    enc_pos = torch.arange(enc_out.shape[1], device=tokens.device)
    pe = sinusoid_positions(s, cfg.d_model, device=tokens.device)
    x = constrain(L.embed_tokens(tokens, params.embed, plan, False)
                  + L.cast(pe, dt), "batch", "seq", None)
    caches = []
    for blk in params.blocks:
        body = _maybe_remat(blk, plan)
        if want_cache:
            x, cache = body(x, enc_out, plan, positions, enc_pos,
                            cache_capacity)
            caches.append(cache)
        else:
            x = body(x, enc_out, plan, positions, enc_pos)
    return x, (caches if want_cache else None)


# ---------------------------------------------------------------------------
# loss, prefill, decode
# ---------------------------------------------------------------------------


def lm_loss(params: WhisperParams, batch: dict, cfg, plan: ExecPlan) -> tuple:
    """Masked next-token cross-entropy of the decoder over the encoded
    ``frames`` (labels < 0 carry no loss).  Returns (loss, {"ce",
    "loss"})."""
    enc_out = encode(params, cfg, plan, batch["frames"])
    hidden, _ = decoder_forward(params, cfg, plan, batch["tokens"], enc_out)
    hidden = params.final_norm(hidden, plan)
    labels = batch["labels"]
    mask = (labels >= 0).float()
    safe = torch.clamp(labels, min=0)
    if plan.loss_impl == "chunked_vocab":
        nll = L.cross_entropy_chunked(hidden, params.embed, safe, plan, 0.0)
    else:
        logits = constrain(L.logits_from_hidden(hidden, params.embed, plan,
                                                0.0), "batch", "seq", "vocab")
        nll = L.cross_entropy_full(logits, safe)
    ce = torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return ce, {"ce": ce, "loss": ce}


def prefill(params: WhisperParams, cfg, plan: ExecPlan, tokens: torch.Tensor,
            frames: torch.Tensor, cache_capacity: int = 0) -> tuple:
    """Encode ``frames``, run the decoder over ``tokens``.  Returns
    (last-token logits (B,1,V), decode state)."""
    # first, so that under torch.export this constant lands in a root
    # region, never in a norm's
    cache_len = torch.full((), tokens.shape[1], dtype=torch.int32,
                           device=tokens.device)
    enc_out = encode(params, cfg, plan, frames)
    hidden, caches = decoder_forward(params, cfg, plan, tokens, enc_out,
                                     want_cache=True,
                                     cache_capacity=cache_capacity)
    h = params.final_norm(hidden[:, -1:], plan)
    logits = L.logits_from_hidden(h, params.embed, plan, 0.0)
    return logits, {"dec": caches, "cache_len": cache_len}


def decode_step(params: WhisperParams, cfg, plan: ExecPlan,
                token: torch.Tensor, state: dict) -> tuple:
    """token: (B,1) int.  Returns (logits (B,1,V), new state); the self
    caches are written in place, the cross caches only read."""
    cache_len = state["cache_len"]
    pe = sinusoid_positions(1, cfg.d_model, offset=cache_len,
                            device=token.device)
    x1 = L.embed_tokens(token, params.embed, plan, False) \
        + L.cast(pe, L.cdtype(plan))
    for blk, kv in zip(params.blocks, state["dec"], strict=True):
        x1 = blk.decode(x1, kv, cache_len, plan)
    h = params.final_norm(x1, plan)
    logits = L.logits_from_hidden(h, params.embed, plan, 0.0)
    return logits, {"dec": state["dec"], "cache_len": cache_len + 1}

"""Parameters of the JAX reference -> the port's modules.

``model_from_jax`` takes the whole tree of the reference's ``init_params``
(``repro/models/transformer.py``) as numpy arrays — ``embed``, ``lm_head``
when embeddings are untied, ``final_norm``, ``blocks`` (each leaf stacked
on axis 0 over the layers; for a hybrid model over the macro blocks, each
``{"sub0": ..., "sub1": ...}``), a hybrid model's ``pre_blocks`` (a list
of RG-LRU sublayers), an SSM model's ``embed_norm_s`` and ``embed_norm_b``
and, for a VLM, ``projector`` — and returns an
:class:`~repro_torch.models.transformer.LMParams` holding them.  For the
enc-dec family it takes the tree of ``repro/models/whisper.py`` —
``embed``, ``final_norm``, ``enc_final_norm``, ``enc_blocks`` and
``blocks`` (both stacked), a decoder block also holding ``ln_x`` and
``xattn`` {wq, wk, wv, wo} — and returns a
:class:`~repro_torch.models.whisper.WhisperParams`.  A block
is the reference's ``_dense_block_init`` — ``ln1``, ``ln2``, ``attn`` {wq,
wk, wv, wo, bq, bk, bv, q_norm, k_norm}, and ``mlp`` {w_gate, w_up,
w_down} or, for a MoE model, ``moe`` {w_router, w_gate, w_up, w_down,
shared} — its ``_hybrid_sub_init`` (``rglru`` {w_branch, w_in, w_out,
w_conv, b_conv, w_a, b_a, w_x, b_x, lam} in place of ``attn``), or its
``_rwkv_block_init`` (``ln1_s``, ``ln1_b``, ``ln2_s``, ``ln2_b``,
``tm_cm``), all in the reference's (in, out) layout.
``dense_block_from_jax`` takes one dense or MoE block and returns a
:class:`~repro_torch.models.transformer.DenseBlock`;
``recurrent_sublayer_from_jax`` takes one RG-LRU sublayer and returns a
:class:`~repro_torch.models.transformer.RecurrentSublayer`.  All three
reject a missing, extra or misshapen key.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

from repro_torch.models.transformer import (DenseBlock, LMParams,
                                            RecurrentSublayer)
from repro_torch.models.whisper import WhisperParams

__all__ = ["dense_block_from_jax", "model_from_jax",
           "recurrent_sublayer_from_jax"]

_NORMS = ("ln1", "ln2", "ln_x", "q_norm", "k_norm", "final_norm",
          "enc_final_norm")
#: the reference's LayerNorm leaves and MoE router -> the port's names
_RENAMED = {"ln1_s": "ln1.weight", "ln1_b": "ln1.bias",
            "ln2_s": "ln2.weight", "ln2_b": "ln2.bias",
            "embed_norm_s": "embed_norm.weight",
            "embed_norm_b": "embed_norm.bias",
            "w_router": "router.weight"}


def _name(key: str) -> str:
    """A reference leaf name -> the port's parameter name."""
    return f"{key}.weight" if key in _NORMS else _RENAMED.get(key, key)


def _block_params(blk: Mapping) -> dict:
    """One reference block (dense, MoE, RG-LRU sublayer, RWKV, or an
    enc-dec encoder or decoder block), flattened to the port block's
    parameter names: ``attn`` and ``mlp`` leaves sit on the block,
    ``moe``, ``rglru``, ``tm_cm`` and ``xattn`` leaves under their
    submodule.  A block that is not RWKV's must hold ``ln1``, ``ln2`` and
    its feed-forward (``mlp`` or ``moe``; KeyError); unknown keys pass
    through unchanged, so :func:`_load` rejects them (as it rejects any
    other missing one)."""
    if "tm_cm" not in blk:
        missing = [k for k in ("ln1", "ln2", "moe" if "moe" in blk else "mlp")
                   if k not in blk]
        if missing:
            raise KeyError(f"block lacks {missing}")
    out = {}
    for key, value in blk.items():
        if key in ("attn", "mlp"):
            out.update({_name(k): w for k, w in value.items()})
        elif key == "moe":
            for k, w in value.items():
                if k == "shared":
                    out.update({f"moe.shared.{n}": x for n, x in w.items()})
                else:
                    out[f"moe.{_name(k)}"] = w
        elif key in ("rglru", "tm_cm", "xattn"):
            out.update({f"{key}.{k}": w for k, w in value.items()})
        else:
            out[_name(key)] = value
    return out


def model_from_jax(params: Mapping, cfg, *, dtype: torch.dtype = torch.float32,
                   device=None) -> LMParams | WhisperParams:
    from repro_torch.core.frontends.export_frontend import resolve_device

    dev = resolve_device(device)
    encdec = cfg.family == "encdec"
    with torch.device("meta"):
        model = (WhisperParams if encdec else LMParams)(
            cfg, dtype=dtype, device="meta")
    hybrid = cfg.family == "hybrid"
    n_stacked = {"blocks": cfg.n_layers // len(cfg.block_pattern) if hybrid
                 else cfg.n_layers}
    if encdec:
        n_stacked["enc_blocks"] = cfg.n_encoder_layers
    flat = {}
    for key, value in params.items():
        if key in n_stacked:
            n = n_stacked[key]
            layers = {np.shape(v)[0] for v in _leaves(value)}
            if layers != {n}:
                raise ValueError(f"{key}: stacked over {sorted(layers)} "
                                 f"layers, config has {n}")
            for i in range(n):
                layer = _map(value, lambda a: np.asarray(a)[i])
                subs = layer.items() if hybrid else [("", layer)]
                for sub, blk in subs:
                    prefix = f"{key}.{i}.{sub}." if sub else f"{key}.{i}."
                    flat.update({prefix + k: w
                                 for k, w in _block_params(blk).items()})
        elif key == "pre_blocks":
            for i, blk in enumerate(value):
                flat.update({f"pre_blocks.{i}.{k}": w
                             for k, w in _block_params(blk).items()})
        elif key == "projector":
            flat.update({f"projector.{k}": w for k, w in value.items()})
        else:
            flat[_name(key)] = value
    return _load(model, flat, dev)


def dense_block_from_jax(blk: Mapping, cfg, *,
                         dtype: torch.dtype = torch.float32,
                         device=None) -> DenseBlock:
    block = DenseBlock(cfg, dtype=dtype, device=device)
    return _load(block, _block_params(blk), block.ln1.weight.device)


def recurrent_sublayer_from_jax(sub: Mapping, cfg, *,
                                dtype: torch.dtype = torch.float32,
                                device=None) -> RecurrentSublayer:
    layer = RecurrentSublayer(cfg, dtype=dtype, device=device)
    return _load(layer, _block_params(sub), layer.ln1.weight.device)


def _leaves(tree):
    if isinstance(tree, Mapping):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _map(tree, fn):
    if isinstance(tree, Mapping):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _load(module: nn.Module, params: dict, device) -> nn.Module:
    """Put ``params`` (name -> array) into ``module``'s parameters, which
    must be exactly these names and shapes, each in the dtype the module
    gives it, on ``device``."""
    own = dict(module.named_parameters())
    if set(params) != set(own):
        raise ValueError(f"parameter sets differ: {sorted(set(params) ^ set(own))}")
    state = {}
    for name, value in params.items():
        value = torch.from_numpy(np.array(value, dtype=np.float32))
        if value.shape != own[name].shape:
            raise ValueError(f"{name}: shape {tuple(value.shape)} vs "
                             f"{tuple(own[name].shape)}")
        state[name] = value.to(device=device, dtype=own[name].dtype)
    module.load_state_dict(state, strict=True, assign=True)
    return module

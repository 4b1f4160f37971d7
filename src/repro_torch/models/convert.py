"""Parameters of the JAX reference -> the port's modules.

``model_from_jax`` takes the whole tree of the reference's ``init_params``
(``repro/models/transformer.py``) as numpy arrays — ``embed``, ``lm_head``
when embeddings are untied, ``final_norm``, ``blocks`` (each leaf stacked
on axis 0 over the layers) and, for a VLM, ``projector`` — and returns an
:class:`~repro_torch.models.transformer.LMParams` holding them.
``dense_block_from_jax`` takes one block of ``_dense_block_init`` —
``ln1``, ``ln2``, ``attn`` {wq, wk, wv, wo, bq, bk, bv, q_norm, k_norm},
``mlp`` {w_gate, w_up, w_down}, all in the reference's (in, out) layout —
and returns a :class:`~repro_torch.models.transformer.DenseBlock`.
``recurrent_sublayer_from_jax`` takes one ``_hybrid_sub_init(...,
"rglru", ...)`` dict — ``ln1``, ``ln2``, ``rglru`` {w_branch, w_in, w_out,
w_conv, b_conv, w_a, b_a, w_x, b_x, lam}, ``mlp`` {w_gate, w_up, w_down}
— and returns a :class:`~repro_torch.models.transformer.RecurrentSublayer`.
All three reject a missing, extra or misshapen key.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

from repro_torch.models.transformer import (DenseBlock, LMParams,
                                            RecurrentSublayer)

__all__ = ["dense_block_from_jax", "model_from_jax",
           "recurrent_sublayer_from_jax"]

_NORMS = ("ln1", "ln2", "q_norm", "k_norm", "final_norm")


def _name(key: str) -> str:
    """A reference leaf name -> the port's parameter name."""
    return f"{key}.weight" if key in _NORMS else key


def _block_params(blk: Mapping) -> dict:
    """One reference block (dense or RG-LRU sublayer), flattened to the
    port block's parameter names.  ``ln1``, ``ln2`` and ``mlp`` are
    required (KeyError); unknown keys pass through unchanged, so
    :func:`_load` rejects them."""
    out = {"ln1.weight": blk["ln1"], "ln2.weight": blk["ln2"], **blk["mlp"]}
    for key, value in blk.items():
        if key == "attn":
            out.update({_name(k): w for k, w in value.items()})
        elif key == "rglru":
            out.update({f"rglru.{k}": w for k, w in value.items()})
        elif key not in ("ln1", "ln2", "mlp"):
            out[key] = value
    return out


def model_from_jax(params: Mapping, cfg, *, dtype: torch.dtype = torch.float32,
                   device=None) -> LMParams:
    from repro_torch.core.frontends.export_frontend import resolve_device

    dev = resolve_device(device)
    with torch.device("meta"):
        model = LMParams(cfg, dtype=dtype, device="meta")
    flat = {}
    for key, value in params.items():
        if key == "blocks":
            layers = {np.shape(v)[0] for v in _leaves(value)}
            if layers != {cfg.n_layers}:
                raise ValueError(f"blocks: stacked over {sorted(layers)} "
                                 f"layers, config has {cfg.n_layers}")
            for i in range(cfg.n_layers):
                layer = _map(value, lambda a: np.asarray(a)[i])
                flat.update({f"blocks.{i}.{k}": w
                             for k, w in _block_params(layer).items()})
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

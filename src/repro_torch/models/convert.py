"""Parameters of the JAX reference -> the port's modules.

``dense_block_from_jax`` takes one block of ``_dense_block_init``
(``repro/models/transformer.py``) as numpy arrays — ``ln1``, ``ln2``,
``attn`` {wq, wk, wv, wo, q_norm, k_norm}, ``mlp`` {w_gate, w_up, w_down},
all in the reference's (in, out) layout — and returns a
:class:`~repro_torch.models.transformer.DenseBlock` holding them.
``recurrent_sublayer_from_jax`` takes one ``_hybrid_sub_init(...,
"rglru", ...)`` dict — ``ln1``, ``ln2``, ``rglru`` {w_branch, w_in, w_out,
w_conv, b_conv, w_a, b_a, w_x, b_x, lam}, ``mlp`` {w_gate, w_up, w_down} —
and returns a :class:`~repro_torch.models.transformer.RecurrentSublayer`.
Both reject a missing, extra or misshapen key.
"""
from __future__ import annotations

import numpy as np
import torch

from torch import nn

from repro_torch.models.transformer import DenseBlock, RecurrentSublayer

__all__ = ["dense_block_from_jax", "recurrent_sublayer_from_jax"]


def dense_block_from_jax(blk: dict, cfg, *, dtype: torch.dtype = torch.float32,
                         device=None) -> DenseBlock:
    block = DenseBlock(cfg, dtype=dtype, device=device)
    attn, mlp = blk["attn"], blk["mlp"]
    params = {"ln1.weight": blk["ln1"], "ln2.weight": blk["ln2"],
              "wq": attn["wq"], "wk": attn["wk"], "wv": attn["wv"],
              "wo": attn["wo"], "w_gate": mlp["w_gate"],
              "w_up": mlp["w_up"], "w_down": mlp["w_down"]}
    if cfg.qk_norm:
        params["q_norm.weight"] = attn["q_norm"]
        params["k_norm.weight"] = attn["k_norm"]
    return _load(block, params)


def recurrent_sublayer_from_jax(sub: dict, cfg, *,
                                dtype: torch.dtype = torch.float32,
                                device=None) -> RecurrentSublayer:
    layer = RecurrentSublayer(cfg, dtype=dtype, device=device)
    mlp = sub["mlp"]
    params = {"ln1.weight": sub["ln1"], "ln2.weight": sub["ln2"],
              "w_gate": mlp["w_gate"], "w_up": mlp["w_up"],
              "w_down": mlp["w_down"]}
    params.update({f"rglru.{k}": w for k, w in sub["rglru"].items()})
    return _load(layer, params)


def _load(module: nn.Module, params: dict) -> nn.Module:
    """Copy ``params`` (name -> array) into ``module``'s parameters, which
    must be exactly these names and shapes."""
    own = dict(module.named_parameters())
    if set(params) != set(own):
        raise ValueError(f"parameter sets differ: {sorted(set(params) ^ set(own))}")
    with torch.no_grad():
        for name, value in params.items():
            value = torch.from_numpy(np.array(value, dtype=np.float32))
            if value.shape != own[name].shape:
                raise ValueError(f"{name}: shape {tuple(value.shape)} vs "
                                 f"{tuple(own[name].shape)}")
            own[name].copy_(value.to(own[name].dtype))
    return module

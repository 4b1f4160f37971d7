"""Parameters of the JAX reference -> the port's modules.

``dense_block_from_jax`` takes one block of ``_dense_block_init``
(``repro/models/transformer.py``) as numpy arrays — ``ln1``, ``ln2``,
``attn`` {wq, wk, wv, wo, q_norm, k_norm}, ``mlp`` {w_gate, w_up, w_down},
all in the reference's (in, out) layout — and returns a
:class:`~repro_torch.models.transformer.DenseBlock` holding them.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.transformer import DenseBlock

__all__ = ["dense_block_from_jax"]


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
    own = dict(block.named_parameters())
    if set(params) != set(own):
        raise ValueError(f"parameter sets differ: {sorted(set(params) ^ set(own))}")
    with torch.no_grad():
        for name, value in params.items():
            value = torch.from_numpy(np.array(value, dtype=np.float32))
            if value.shape != own[name].shape:
                raise ValueError(f"{name}: shape {tuple(value.shape)} vs "
                                 f"{tuple(own[name].shape)}")
            own[name].copy_(value.to(own[name].dtype))
    return block

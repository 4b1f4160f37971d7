"""Port of ``repro/optim/compression.py``: error-feedback int8 gradient
compression (symmetric per-tensor scale; the quantization residual is
carried to the next step, so the compressed trajectory tracks the exact
one).  Trees are mappings name -> tensor, as in ``adamw.py``.  The
cross-pod all-reduce that consumes it (``make_compressed_dp_step``) waits
for the mesh (``ROADMAP.md`` queue 1 item 10)."""
from __future__ import annotations

from typing import Mapping, NamedTuple

import torch

from repro_torch.optim.adamw import _named

__all__ = ["CompressionState", "compress_int8", "decompress_int8",
           "ef_compress_update", "ef_init"]


class CompressionState(NamedTuple):
    error: dict[str, torch.Tensor]   # f32 residual (error feedback memory)


def ef_init(params) -> CompressionState:
    return CompressionState({k: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device)
                             for k, p in _named(params).items()})


def compress_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 -> (int8 values, f32 scale).  ``torch.round`` rounds half to
    even, as ``jnp.round`` does."""
    amax = torch.max(torch.abs(x))
    scale = torch.clamp(amax, min=1e-20) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


@torch.no_grad()
def ef_compress_update(grads: Mapping[str, torch.Tensor],
                       state: CompressionState) -> tuple[dict, dict,
                                                         CompressionState]:
    """(quantized tree, scales tree, new error state)."""
    qs, scales, errs = {}, {}, {}
    for k, g in grads.items():
        corrected = g.float() + state.error[k]
        qs[k], scales[k] = compress_int8(corrected)
        errs[k] = corrected - decompress_int8(qs[k], scales[k])
    return qs, scales, CompressionState(errs)

"""Port of ``repro/optim/compression.py``: error-feedback int8 gradient
compression (symmetric per-tensor scale; the quantization residual is
carried to the next step, so the compressed trajectory tracks the exact
one).  Trees are mappings name -> tensor, as in ``adamw.py``.  The
cross-pod reduction that consumes it is ``runtime.train.
make_compressed_dp_step``: it passes the pods' shared scales
(``ef_compress_update(..., scales=...)``), so that every pod decodes
every payload with the scale it was encoded with."""
from __future__ import annotations

from typing import Mapping, NamedTuple, Optional

import torch

from repro_torch.optim.adamw import _named

__all__ = ["CompressionState", "compress_int8", "decompress_int8",
           "ef_compress_update", "ef_init", "int8_scale"]


class CompressionState(NamedTuple):
    error: dict[str, torch.Tensor]   # f32 residual (error feedback memory)


def ef_init(params) -> CompressionState:
    return CompressionState({k: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device)
                             for k, p in _named(params).items()})


def int8_scale(x: torch.Tensor) -> torch.Tensor:
    """The symmetric per-tensor scale: max |x| / 127."""
    return torch.clamp(torch.max(torch.abs(x)), min=1e-20) / 127.0


def compress_int8(x: torch.Tensor, scale: Optional[torch.Tensor] = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 -> (int8 values, f32 scale), at ``x``'s own scale unless one is
    given.  ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    if scale is None:
        scale = int8_scale(x)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


@torch.no_grad()
def ef_compress_update(grads: Mapping[str, torch.Tensor],
                       state: CompressionState,
                       scales: Optional[Mapping[str, torch.Tensor]] = None
                       ) -> tuple[dict, dict, CompressionState]:
    """(quantized tree, scales tree, new error state); each tensor at its
    own scale, or at ``scales[name]`` when given."""
    qs, out_scales, errs = {}, {}, {}
    for k, g in grads.items():
        corrected = g.float() + state.error[k]
        qs[k], out_scales[k] = compress_int8(
            corrected, None if scales is None else scales[k])
        errs[k] = corrected - decompress_int8(qs[k], out_scales[k])
    return qs, out_scales, CompressionState(errs)

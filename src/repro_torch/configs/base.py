"""Port of ``repro/configs/base.py``: the :class:`ArchConfig` fields a dense
decoder block reads, :meth:`ArchConfig.reduced` and :func:`get_config`.
The MoE, hybrid, SSM, enc-dec and VLM fields, the shape specs and the other
architectures come with their slices."""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass

__all__ = ["ArchConfig", "ARCH_IDS", "get_config"]


@dataclass(frozen=True)
class ArchConfig:
    # identity -------------------------------------------------------------
    arch_id: str
    family: str                   # dense (the only family ported so far)
    source: str = ""              # provenance note

    # trunk ------------------------------------------------------------------
    n_layers: int = 0
    d_model: int = 0
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0             # 0 -> d_model // n_heads
    d_ff: int = 0
    vocab: int = 0

    # attention flavour ------------------------------------------------------
    attn_kind: str = "full"
    qk_norm: bool = False         # qwen3-style RMSNorm on q and k
    qkv_bias: bool = False
    rope_theta: float = 10_000.0

    # MLP flavour --------------------------------------------------------------
    mlp_act: str = "silu"         # silu (SwiGLU) | gelu (GeGLU)

    tie_embeddings: bool = True
    norm_eps: float = 1e-6

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU tests (the reference's sizes)."""
        return dataclasses.replace(
            self, n_layers=min(self.n_layers, 2), d_model=64, n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 4) or 4, head_dim=16, d_ff=128,
            vocab=256)


ARCH_IDS: tuple[str, ...] = ("qwen3_0_6b",)


def get_config(arch_id: str) -> ArchConfig:
    canon = arch_id.replace("-", "_").replace(".", "_")
    if canon not in ARCH_IDS:
        raise KeyError(f"unknown arch '{arch_id}'; ported: {sorted(ARCH_IDS)}")
    return importlib.import_module(f"repro_torch.configs.{canon}").CONFIG

"""Port of ``repro/configs/base.py``: the :class:`ArchConfig` fields that a
dense decoder block, a hybrid model's RG-LRU sublayer and the RWKV-6 WKV
recurrence read, :meth:`ArchConfig.reduced` and :func:`get_config`.  The
MoE, enc-dec and VLM fields, the shape specs and the other architectures
come with their slices."""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass

__all__ = ["ArchConfig", "ARCH_IDS", "get_config"]


@dataclass(frozen=True)
class ArchConfig:
    # identity -------------------------------------------------------------
    arch_id: str
    family: str                   # dense | hybrid | ssm
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
    local_window: int = 2048      # for attn_kind == "local"
    qk_norm: bool = False         # qwen3-style RMSNorm on q and k
    qkv_bias: bool = False
    rope_theta: float = 10_000.0

    # MLP flavour --------------------------------------------------------------
    mlp_act: str = "silu"         # silu (SwiGLU) | gelu (GeGLU)

    # hybrid / recurrent -----------------------------------------------------
    block_pattern: tuple[str, ...] = ()   # e.g. ("rglru","rglru","local_attn")
    d_rnn: int = 0                # RG-LRU recurrence width (0 -> d_model)
    conv1d_width: int = 4         # RG-LRU temporal conv width

    # rwkv ---------------------------------------------------------------------
    rwkv_head_dim: int = 64

    tie_embeddings: bool = True
    scale_embeddings: bool = False  # gemma multiplies embeddings by sqrt(d)
    norm_eps: float = 1e-6

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def d_rnn_resolved(self) -> int:
        return self.d_rnn or self.d_model

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU tests (the reference's sizes)."""
        kw: dict = dict(
            n_layers=min(self.n_layers, 2), d_model=64, n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 4) or 4, head_dim=16, d_ff=128,
            vocab=256, local_window=min(self.local_window, 32))
        if self.block_pattern:
            kw["n_layers"] = len(self.block_pattern)
        if self.d_rnn:
            kw["d_rnn"] = 64
        if self.family == "ssm":
            kw["rwkv_head_dim"] = 16
        return dataclasses.replace(self, **kw)


ARCH_IDS: tuple[str, ...] = ("qwen3_0_6b", "recurrentgemma_2b", "rwkv6_3b")


def get_config(arch_id: str) -> ArchConfig:
    canon = arch_id.replace("-", "_").replace(".", "_")
    if canon not in ARCH_IDS:
        raise KeyError(f"unknown arch '{arch_id}'; ported: {sorted(ARCH_IDS)}")
    return importlib.import_module(f"repro_torch.configs.{canon}").CONFIG

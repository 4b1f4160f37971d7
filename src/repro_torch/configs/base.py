"""Port of ``repro/configs/base.py``: the shape specs, :class:`MoEConfig`,
:class:`ArchConfig` with its derived properties, ``param_count`` and
``reduced``, and the registry of all ten architectures (``ARCH_IDS``,
aliases, :func:`get_config`, :func:`all_configs`).  Plain data, no
framework imports.

Architecture + shape configuration system.

Every assigned architecture is described by one :class:`ArchConfig` in its own
``configs/<id>.py`` file.  Configs are plain frozen dataclasses so they can be
hashed, diffed and serialized; the registry maps ``--arch <id>`` strings to
them.  ``reduced()`` returns the small same-family config used by the CPU
smoke tests.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass, field
from typing import Optional, Sequence

# ---------------------------------------------------------------------------
# Shape specs (shared by every LM-family architecture)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeSpec:
    """One benchmark cell: an input shape + which step function it lowers."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


TRAIN_4K = ShapeSpec("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeSpec("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeSpec("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeSpec("long_500k", 524_288, 1, "decode")

ALL_SHAPES: tuple[ShapeSpec, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES}


# ---------------------------------------------------------------------------
# Architecture config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0
    top_k: int = 1
    d_ff_expert: int = 0          # expert hidden size (may differ from dense d_ff)
    capacity_factor: float = 1.25
    n_shared_experts: int = 0     # llama4-style shared expert (always-on)
    router_z_loss: float = 1e-3
    aux_loss: float = 1e-2


@dataclass(frozen=True)
class ArchConfig:
    # identity -------------------------------------------------------------
    arch_id: str
    family: str                   # dense | moe | hybrid | ssm | encdec | vlm
    source: str = ""              # provenance note from the assignment table

    # trunk ------------------------------------------------------------------
    n_layers: int = 0
    d_model: int = 0
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0             # 0 -> d_model // n_heads
    d_ff: int = 0
    vocab: int = 0

    # attention flavour ------------------------------------------------------
    attn_kind: str = "full"       # full | local | none (pure recurrence)
    local_window: int = 2048      # for attn_kind == "local"
    qk_norm: bool = False         # qwen3-style RMSNorm on q and k
    qkv_bias: bool = False        # qwen1.5-style bias on qkv projections
    rope_theta: float = 10_000.0
    logit_softcap: float = 0.0    # gemma-style final-logit softcap (0 = off)

    # MLP flavour --------------------------------------------------------------
    mlp_act: str = "silu"         # silu (SwiGLU) | gelu (GeGLU)

    # MoE ----------------------------------------------------------------------
    moe: Optional[MoEConfig] = None
    moe_every: int = 1            # MoE in every k-th layer (1 = all layers)

    # hybrid / recurrent -----------------------------------------------------
    block_pattern: tuple[str, ...] = ()   # e.g. ("rglru","rglru","local_attn")
    d_rnn: int = 0                # RG-LRU recurrence width (0 -> d_model)
    conv1d_width: int = 4         # RG-LRU temporal conv width

    # rwkv ---------------------------------------------------------------------
    rwkv_head_dim: int = 64

    # enc-dec -------------------------------------------------------------------
    n_encoder_layers: int = 0
    encoder_seq: int = 0          # fixed encoder context (whisper: 1500 frames)

    # vlm ------------------------------------------------------------------------
    vision_patches: int = 0       # stub patch-embedding count (llava anyres)
    vision_dim: int = 0           # raw vision feature dim before projector

    # embeddings ------------------------------------------------------------------
    tie_embeddings: bool = True
    scale_embeddings: bool = False  # gemma multiplies embeddings by sqrt(d)

    # norm --------------------------------------------------------------------
    norm_eps: float = 1e-6

    # --- derived -------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def d_rnn_resolved(self) -> int:
        return self.d_rnn or self.d_model

    @property
    def subquadratic(self) -> bool:
        """True when a 500k-token decode is feasible (no full-attn KV scaling)."""
        return self.family in ("hybrid", "ssm")

    @property
    def has_decoder(self) -> bool:
        return True  # every assigned arch has an autoregressive decoder

    def supports_shape(self, shape: ShapeSpec) -> bool:
        if shape.name == "long_500k" and not self.subquadratic:
            return False
        return True

    def skip_reason(self, shape: ShapeSpec) -> str:
        if shape.name == "long_500k" and not self.subquadratic:
            return "pure full-attention arch: 500k decode needs sub-quadratic attention (see DESIGN.md)"
        return ""

    # --- parameter counting (for roofline MODEL_FLOPS = 6 N D) ----------------
    def param_count(self, active_only: bool = False) -> int:
        d, hd = self.d_model, self.resolved_head_dim
        n_q = self.n_heads * hd
        n_kv = self.n_kv_heads * hd
        embed = self.vocab * d * (1 if self.tie_embeddings else 2)

        def attn_params() -> int:
            bias = (n_q + 2 * n_kv) if self.qkv_bias else 0
            return d * n_q + 2 * d * n_kv + n_q * d + bias

        def dense_mlp(dff: int) -> int:
            return 3 * d * dff  # gated (up, gate, down)

        def rglru_params() -> int:
            dr = self.d_rnn_resolved
            # in/out proj (x2 branches), conv, gates (block-diag approximated dense/heads)
            return 2 * d * dr + dr * d + self.conv1d_width * dr + 2 * dr * (dr // max(self.n_heads, 1)) + 2 * dr

        def rwkv_layer() -> int:
            # time-mix: r,k,v,w,g,o projections + lora for w + channel-mix
            tm = 5 * d * d + 2 * d * 64 + d * d
            cm = 2 * d * int(self.d_ff)
            return tm + cm

        total = embed
        active = embed
        for li in range(self.n_layers):
            if self.family == "ssm":
                p = rwkv_layer()
                total += p
                active += p
                continue
            blk = self.block_pattern[li % len(self.block_pattern)] if self.block_pattern else "attn"
            if blk == "rglru":
                p = rglru_params() + dense_mlp(self.d_ff)
                total += p
                active += p
                continue
            total += attn_params()
            active += attn_params()
            if self.moe is not None and (li % self.moe_every == 0):
                e = self.moe
                per_exp = dense_mlp(e.d_ff_expert or self.d_ff)
                total += e.n_experts * per_exp + d * e.n_experts
                active += (e.top_k + e.n_shared_experts) * per_exp + d * e.n_experts
                if e.n_shared_experts:
                    total += e.n_shared_experts * per_exp
            else:
                total += dense_mlp(self.d_ff)
                active += dense_mlp(self.d_ff)
        for _ in range(self.n_encoder_layers):
            p = attn_params() + dense_mlp(self.d_ff)
            # decoder layers also carry cross-attention
            total += p
            active += p
        if self.n_encoder_layers:  # decoder cross-attn blocks
            ca = self.n_layers * attn_params()
            total += ca
            active += ca
        if self.vision_patches:
            proj = self.vision_dim * d + d * d  # 2-layer projector
            total += proj
            active += proj
        return active if active_only else total

    # --- smoke-test reduction ---------------------------------------------------
    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        kw: dict = dict(
            n_layers=min(self.n_layers, 2 if not self.block_pattern else len(self.block_pattern)),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 4) or 4,
            head_dim=16,
            d_ff=128,
            vocab=256,
        )
        if self.moe is not None:
            kw["moe"] = dataclasses.replace(
                self.moe, n_experts=4, top_k=min(self.moe.top_k, 2), d_ff_expert=64
            )
        if self.block_pattern:
            kw["n_layers"] = len(self.block_pattern)
        if self.d_rnn:
            kw["d_rnn"] = 64
        if self.n_encoder_layers:
            kw["n_encoder_layers"] = 2
            kw["encoder_seq"] = 16
        if self.vision_patches:
            kw["vision_patches"] = 8
            kw["vision_dim"] = 32
        if self.family == "ssm":
            kw["rwkv_head_dim"] = 16
        kw["local_window"] = min(self.local_window, 32)
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

ARCH_IDS: tuple[str, ...] = (
    "llama4_scout_17b_a16e",
    "olmoe_1b_7b",
    "gemma_7b",
    "tinyllama_1_1b",
    "qwen1_5_4b",
    "qwen3_0_6b",
    "whisper_small",
    "recurrentgemma_2b",
    "llava_next_mistral_7b",
    "rwkv6_3b",
)

_ALIASES = {
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "gemma-7b": "gemma_7b",
    "tinyllama-1.1b": "tinyllama_1_1b",
    "qwen1.5-4b": "qwen1_5_4b",
    "qwen3-0.6b": "qwen3_0_6b",
    "whisper-small": "whisper_small",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "rwkv6-3b": "rwkv6_3b",
}


def get_config(arch_id: str) -> ArchConfig:
    canon = _ALIASES.get(arch_id, arch_id).replace("-", "_").replace(".", "_")
    if canon not in ARCH_IDS:
        raise KeyError(f"unknown arch '{arch_id}'; known: {sorted(ARCH_IDS)}")
    mod = importlib.import_module(f"repro_torch.configs.{canon}")
    return mod.CONFIG


def all_configs() -> dict[str, ArchConfig]:
    return {a: get_config(a) for a in ARCH_IDS}

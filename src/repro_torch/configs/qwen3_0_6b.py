"""Port of ``repro/configs/qwen3_0_6b.py``: Qwen3 0.6B dense (qk_norm, GQA).

[hf:Qwen/Qwen3-8B family; hf] — 28L d_model=1024 16H (GQA kv=8) d_ff=3072
vocab=151936, qk_norm.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="qwen3_0_6b",
    family="dense",
    source="hf:Qwen/Qwen3-8B; hf",
    n_layers=28,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=3072,
    vocab=151_936,
    attn_kind="full",
    qk_norm=True,
    mlp_act="silu",
    rope_theta=1_000_000.0,
    tie_embeddings=True,
)

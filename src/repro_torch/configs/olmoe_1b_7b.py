"""Port of ``repro/configs/olmoe_1b_7b.py``: OLMoE 1B-active / 7B-total MoE.

[arXiv:2409.02060; hf] — 16L d_model=2048 16H (GQA kv=16) d_ff=1024
vocab=50304, MoE 64e top-8.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    arch_id="olmoe_1b_7b",
    family="moe",
    source="arXiv:2409.02060; hf",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1024,
    vocab=50_304,
    attn_kind="full",
    qk_norm=True,  # OLMoE uses QK-Norm
    mlp_act="silu",
    moe=MoEConfig(n_experts=64, top_k=8, d_ff_expert=1024),
    moe_every=1,
    rope_theta=10_000.0,
    tie_embeddings=False,
)

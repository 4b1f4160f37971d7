"""Port of ``repro/configs/llama4_scout_17b_a16e.py``: Llama-4 Scout 17B-active / 16-expert MoE.

[hf:meta-llama/Llama-4-Scout-17B-16E; unverified] — 48L d_model=5120 40H
(GQA kv=8) d_ff=8192 vocab=202048, MoE 16e top-1, early fusion.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    arch_id="llama4_scout_17b_a16e",
    family="moe",
    source="hf:meta-llama/Llama-4-Scout-17B-16E; unverified",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab=202_048,
    attn_kind="full",
    mlp_act="silu",
    moe=MoEConfig(n_experts=16, top_k=1, d_ff_expert=8192, n_shared_experts=1),
    moe_every=1,
    rope_theta=500_000.0,
    tie_embeddings=False,
)

"""Port of ``repro/configs/qwen1_5_4b.py``: Qwen1.5 4B dense (QKV bias).

[hf:Qwen/Qwen1.5-0.5B family; hf] — 40L d_model=2560 20H (kv=20) d_ff=6912
vocab=151936, QKV bias.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="qwen1_5_4b",
    family="dense",
    source="hf:Qwen/Qwen1.5-0.5B; hf",
    n_layers=40,
    d_model=2560,
    n_heads=20,
    n_kv_heads=20,
    head_dim=128,
    d_ff=6912,
    vocab=151_936,
    attn_kind="full",
    qkv_bias=True,
    mlp_act="silu",
    rope_theta=1_000_000.0,
    tie_embeddings=False,
)

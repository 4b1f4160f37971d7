"""Port of ``repro/configs/rwkv6_3b.py``: RWKV-6 (Finch) 3B,
attention-free, data-dependent decay.

[arXiv:2404.05892; hf] — 32L d_model=2560 d_ff=8960 vocab=65536, head_dim=64.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="rwkv6_3b",
    family="ssm",
    source="arXiv:2404.05892; hf",
    n_layers=32,
    d_model=2560,
    n_heads=40,             # 2560 / 64 wkv heads
    n_kv_heads=40,
    head_dim=64,
    d_ff=8960,
    vocab=65_536,
    attn_kind="none",
    mlp_act="relu_sq",      # rwkv channel-mix uses squared relu
    rwkv_head_dim=64,
    tie_embeddings=False,
)

"""Port of ``repro/configs/recurrentgemma_2b.py``: RecurrentGemma 2B
(Griffin), RG-LRU + local attention, 1 attn : 2 recurrent.

[arXiv:2402.19427; hf] — 26L d_model=2560 10H (GQA kv=1 => MQA) d_ff=7680
vocab=256000, d_rnn lru_width=2560, local window 2048.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="recurrentgemma_2b",
    family="hybrid",
    source="arXiv:2402.19427; hf",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,           # MQA
    head_dim=256,
    d_ff=7680,
    vocab=256_000,
    attn_kind="local",
    local_window=2048,
    mlp_act="gelu",
    block_pattern=("rglru", "rglru", "local_attn"),
    d_rnn=2560,
    conv1d_width=4,
    rope_theta=10_000.0,
    tie_embeddings=True,
    scale_embeddings=True,
)

"""Port of ``repro/configs/tinyllama_1_1b.py``: TinyLlama 1.1B dense (llama2 arch, small).

[arXiv:2401.02385; hf] — 22L d_model=2048 32H (GQA kv=4) d_ff=5632 vocab=32000.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="tinyllama_1_1b",
    family="dense",
    source="arXiv:2401.02385; hf",
    n_layers=22,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=64,
    d_ff=5632,
    vocab=32_000,
    attn_kind="full",
    mlp_act="silu",
    rope_theta=10_000.0,
    tie_embeddings=False,
)

"""Port of ``repro/configs/gemma_7b.py``: Gemma 7B dense.

[arXiv:2403.08295; hf] — 28L d_model=3072 16H (kv=16) d_ff=24576
vocab=256000, GeGLU, head_dim=256.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="gemma_7b",
    family="dense",
    source="arXiv:2403.08295; hf",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    head_dim=256,
    d_ff=24_576,
    vocab=256_000,
    attn_kind="full",
    mlp_act="gelu",  # GeGLU
    rope_theta=10_000.0,
    tie_embeddings=True,
    scale_embeddings=True,
    logit_softcap=0.0,
)

"""Port of ``repro/configs/llava_next_mistral_7b.py``: LLaVA-NeXT (mistral-7b backbone) VLM; anyres vision frontend stubbed.

[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified] — 32L d_model=4096 32H
(GQA kv=8) d_ff=14336 vocab=32000.  ``input_specs()`` supplies precomputed
patch embeddings (anyres: up to 5 tiles x 24x24 = 2880 patches of CLIP-dim
1024); the 2-layer MLP projector into d_model IS implemented.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="llava_next_mistral_7b",
    family="vlm",
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14_336,
    vocab=32_000,
    attn_kind="full",
    mlp_act="silu",
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    vision_patches=2880,   # 5 anyres tiles x 576 patches
    vision_dim=1024,       # CLIP ViT-L/14 feature dim
)

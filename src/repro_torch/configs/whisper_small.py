"""Port of ``repro/configs/whisper_small.py``: Whisper-small encoder-decoder (audio backbone; conv frontend stubbed).

[arXiv:2212.04356; unverified] — 12L d_model=768 12H (kv=12) d_ff=3072
vocab=51865.  ``input_specs()`` supplies precomputed frame embeddings for the
encoder (the conv frontend is a STUB per the assignment).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="whisper_small",
    family="encdec",
    source="arXiv:2212.04356; unverified",
    n_layers=12,            # decoder layers
    n_encoder_layers=12,
    encoder_seq=1500,       # 30 s of audio at 50 Hz after the conv stub
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab=51_865,
    attn_kind="full",
    mlp_act="gelu",
    rope_theta=0.0,         # whisper uses learned/sinusoidal positions, not RoPE
    tie_embeddings=True,
)

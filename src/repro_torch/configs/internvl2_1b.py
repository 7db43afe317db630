"""internvl2-1b — a ViT patch front end (stub) and a Qwen2-0.5B-class LM
(a copy of ``repro.configs.internvl2_1b``, field for field).

24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655, QKV bias, tied
embeddings.  Batches carry 256 precomputed patch embeddings of 1024
(B, 256, 1024), projected into the LM and placed before the tokens.  The
TP padding fields are the reference's multi-device deployment: the dry
run reads them, one card's training and serving do not.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-1b",
    family="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab=151655,
    qkv_bias=True,           # Qwen2 LM backbone uses QKV bias
    rope_theta=1e6,
    tie_embeddings=True,
    modality="vlm",
    frontend_dim=1024,       # InternViT-300M hidden size
    frontend_len=256,        # patch tokens per image
    tp_pad_heads=16,
    tp_pad_kv_heads=16,
    shard_kv_heads=True,
    notes="full attention: long_500k skipped (no sub-quadratic path)",
)

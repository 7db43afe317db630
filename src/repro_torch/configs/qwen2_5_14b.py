"""qwen2.5-14b — dense GQA with QKV bias (a copy of
``repro.configs.qwen2_5_14b``, field for field).

48L d_model=5120 40H (GQA kv=8) d_ff=13824 vocab=152064.  The TP padding
and FSDP fields are the reference's multi-device deployment: the dry
run reads them, one card's training and serving do not.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-14b",
    family="dense",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=13824,
    vocab=152064,
    qkv_bias=True,
    rope_theta=1e6,
    tp_pad_heads=48,
    tp_pad_kv_heads=16,
    shard_kv_heads=True,
    fsdp=True,
    notes="full attention: long_500k skipped",
)

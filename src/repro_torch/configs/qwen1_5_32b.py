"""qwen1.5-32b — dense MHA (kv=40) with QKV bias (a copy of
``repro.configs.qwen1_5_32b``, field for field).

64L d_model=5120 40H kv=40 d_ff=27392 vocab=152064.  Decode keeps an int8
KV cache, and ``serve_mlp_int8`` marks the model for w8a16 MLP weights at
serving time (``models.lm.quantize_mlp_weights``).  The TP padding and
FSDP fields are the reference's multi-device deployment: the dry
run reads them, one card's training and serving do not.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    d_ff=27392,
    vocab=152064,
    qkv_bias=True,
    rope_theta=1e6,
    tp_pad_heads=48,
    tp_pad_kv_heads=48,
    shard_kv_heads=True,
    cache_dtype="int8",
    serve_mlp_int8=True,   # w8a16 MLP weights at serving time
    fsdp=True,
    notes="full attention: long_500k skipped",
)

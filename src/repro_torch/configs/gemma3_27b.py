"""gemma3-27b — 5:1 local:global sliding-window stack (a copy of
``repro.configs.gemma3_27b``, field for field).

62L d_model=5376 32H (GQA kv=16) head_dim=128 d_ff=21504 vocab=262144,
GELU, tied embeddings.  Every 6th layer is global; locals use a
1024-token window with RoPE theta 10k, globals theta 1M.  The TP padding
and FSDP fields are the reference's multi-device deployment: the dry
run reads them, one card's training and serving do not.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-27b",
    family="dense",
    n_layers=62,
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab=262144,
    activation="gelu",
    rope_theta=1e6,
    tie_embeddings=True,
    window=1024,
    global_interval=6,
    shard_kv_heads=True,
    fsdp=True,
    notes="long_500k runs (sliding-window locals + sparse globals)",
)

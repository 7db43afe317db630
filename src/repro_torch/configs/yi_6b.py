"""yi-6b — llama-arch GQA. [arXiv:2403.04652; hf].

32L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000.  Heads divide TP-16
exactly; kv=4 replicated over the model axis (cache is sequence-sharded for
decode so replication costs no HBM capacity at scale).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="yi-6b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    d_ff=11008,
    vocab=64000,
    rope_theta=5e6,
    tp_pad_kv_heads=16,
    shard_kv_heads=True,
    notes="full attention: long_500k skipped",
)

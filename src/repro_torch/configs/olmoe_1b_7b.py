"""olmoe-1b-7b — 64-expert top-8 MoE (1B active / 7B total). [arXiv:2409.02060].

16L d_model=2048 16H (kv=16) d_ff=1024/expert vocab=50304.  The flagship
packed-stream consumer: top-8 dispatch/combine are indirect streams (the
indirect scatter and gather of ``kernels/csrc/stream_converters.cu``).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab=50304,
    n_experts=64,
    top_k=8,
    shard_kv_heads=True,
    notes="full attention: long_500k skipped",
)

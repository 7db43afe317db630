"""rwkv6-3b "Finch" — attention-free, data-dependent decay. [arXiv:2404.05892].

32L d_model=2560 d_ff=8960 vocab=65536.  40 WKV heads of 64 (padded 48 under
TP-16).  Arch-applicability: no KV/attention indirection exists — packed
streams touch only embedding/head gathers and gradient compression
(DESIGN.md section 4).  long_500k RUNS (O(1) recurrent state).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=40,            # d_model / 64 WKV heads
    n_kv_heads=40,
    d_ff=8960,
    vocab=65536,
    ssm="rwkv6",
    tp_pad_heads=48,
    notes="attention-free; long_500k runs; paper technique applies to embedding streams only",
)

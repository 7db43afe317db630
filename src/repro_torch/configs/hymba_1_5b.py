"""hymba-1.5b — parallel attention and Mamba heads in every block (a copy
of ``repro.configs.hymba_1_5b``, field for field).

32L d_model=1600 25H (GQA kv=5, head dim 64) d_ff=5504 vocab=32001
ssm_state=16.  Each block runs sliding-window attention (1024) beside a
selective SSM head, each path output-normed, then averaged; layers
{0, L/2, L-1} attend globally (``models.lm.global_flags``).  Meta-tokens
are out of scope, as in the reference.  The TP padding fields are the
reference's multi-device deployment: the dry run reads them,
one card's training and serving do not.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab=32001,
    ssm="hymba",
    ssm_state=16,
    window=1024,
    tp_pad_heads=32,
    tp_pad_kv_heads=16,
    shard_kv_heads=True,
    notes="hybrid: long_500k runs; 3 global-attention layers",
)

"""hubert-xlarge — encoder-only audio transformer (a copy of
``repro.configs.hubert_xlarge``, field for field).

48L d_model=1280 16H (kv=16, head dim 80) d_ff=5120 vocab=504 (cluster
targets).  Bidirectional (causal=False), plain GELU FFN (no GLU).  The
conv waveform front end is a stub: batches carry frame embeddings
(B, S, 512), projected into the model.  Encoder-only, so it has no
decode step.  RMSNorm stands in for LayerNorm, as in the reference.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab=504,
    causal=False,
    glu=False,
    activation="gelu",
    modality="audio",
    frontend_dim=512,
    shard_kv_heads=True,
    notes="encoder-only: decode shapes skipped",
)

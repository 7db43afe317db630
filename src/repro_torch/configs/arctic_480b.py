"""arctic-480b — 128-expert top-2 MoE with a dense residual MLP (a copy
of ``repro.configs.arctic_480b``, field for field).

35L d_model=7168 56H (GQA kv=8) d_ff=4864 per expert vocab=32000,
Adafactor, bf16 parameters, chunked prefill of 4096.  The dense residual
path runs beside the MoE FFN.  At full size it does not fit one card; the
port runs it at its smoke size, and the dry run
(``repro_torch.launch.dryrun``) accounts for it at full size.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,
    vocab=32000,
    n_experts=128,
    top_k=2,
    dense_residual=True,
    tp_pad_heads=64,
    tp_pad_kv_heads=16,
    shard_kv_heads=True,
    fsdp=True,
    optimizer="adafactor",
    param_dtype="bfloat16",
    prefill_chunk=4096,    # chunked prefill: bounds MoE dispatch buffers
    notes="full attention: long_500k skipped",
)

"""Architecture registry of the port: the reference's ten families.

A copy of ``repro.configs``: the ten assigned configurations in the
reference's registry order (so ``ALL_ARCH_NAMES`` is the reference's),
the shape cells ``SHAPES`` (training takes ``train_4k``'s sequence
length) and the ones each arch runs (:func:`applicable_shapes`, the
dry run's cells), :func:`smoke_config`, which reduces any of them to a
CPU-test size exactly as the reference does.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

from .base import SHAPES, ArchConfig, ShapeConfig
from .arctic_480b import CONFIG as _arctic_480b
from .gemma3_27b import CONFIG as _gemma3_27b
from .hubert_xlarge import CONFIG as _hubert_xlarge
from .hymba_1_5b import CONFIG as _hymba_1_5b
from .internvl2_1b import CONFIG as _internvl2_1b
from .olmoe_1b_7b import CONFIG as _olmoe_1b_7b
from .qwen1_5_32b import CONFIG as _qwen1_5_32b
from .qwen2_5_14b import CONFIG as _qwen2_5_14b
from .rwkv6_3b import CONFIG as _rwkv6_3b
from .yi_6b import CONFIG as _yi_6b

ARCHS: Dict[str, ArchConfig] = {
    c.name: c
    for c in [
        _internvl2_1b,
        _qwen1_5_32b,
        _yi_6b,
        _qwen2_5_14b,
        _gemma3_27b,
        _rwkv6_3b,
        _hubert_xlarge,
        _hymba_1_5b,
        _olmoe_1b_7b,
        _arctic_480b,
    ]
}

ALL_ARCH_NAMES: List[str] = list(ARCHS)


def get_config(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch '{name}'; available: {ALL_ARCH_NAMES}")
    return ARCHS[name]


def smoke_config(name: str) -> ArchConfig:
    """Reduced same-family config: 2 layers, narrow dims, tiny vocab."""
    c = get_config(name)
    kv = min(c.n_kv_heads, 2)
    heads = 4 if c.ssm != "rwkv6" else 2  # rwkv heads = d/64
    repl = dict(
        n_layers=2,
        d_model=128,
        n_heads=heads,
        n_kv_heads=kv if heads % max(kv, 1) == 0 else heads,
        head_dim=32 if c.ssm != "rwkv6" else None,
        d_ff=96 if not c.n_experts else 64,
        vocab=256,
        n_experts=4 if c.n_experts else 0,
        top_k=min(c.top_k, 2) if c.n_experts else 0,
        window=8 if c.window else None,
        global_interval=2 if c.global_interval else None,
        frontend_dim=16 if c.frontend_dim else 0,
        frontend_len=4 if c.frontend_len else 0,
        tp_pad_heads=None,
        tp_pad_kv_heads=None,
        shard_kv_heads=False,
        fsdp=False,
        cache_dtype=c.cache_dtype,
        dtype="float32",
        param_dtype="float32",
        remat=False,
    )
    return dataclasses.replace(c, **repl)



def applicable_shapes(cfg: ArchConfig) -> List[ShapeConfig]:
    """The shape cells this arch runs: training and prefill always; decode
    for a causal model; ``long_500k`` for a causal model that is
    sub-quadratic (a recurrent state or a sliding window)."""
    out = [SHAPES["train_4k"], SHAPES["prefill_32k"]]
    if cfg.causal:  # an encoder-only model has no decode step
        out.append(SHAPES["decode_32k"])
        if cfg.ssm is not None or cfg.window is not None:
            out.append(SHAPES["long_500k"])
    return out

"""Architecture registry of the port: the configurations its slices serve.

A copy of the parts of ``repro.configs`` the serving slices need: the
``yi-6b`` entry (paged and speculative serving, and the Mamba block at its
width), the ``rwkv6-3b`` entry (recurrent serving) and
:func:`smoke_config`, which reduces either to a CPU-test size exactly as
the reference does.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

from .base import ArchConfig
from .rwkv6_3b import CONFIG as _rwkv6_3b
from .yi_6b import CONFIG as _yi_6b

ARCHS: Dict[str, ArchConfig] = {c.name: c for c in [_yi_6b, _rwkv6_3b]}

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

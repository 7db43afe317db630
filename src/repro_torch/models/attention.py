"""GQA attention for training (from ``repro.models.attention``).

The full-sequence path: QKV projections (with optional biases), RoPE, and
attention through ``kernels.ops.flash_attention`` where the reference
scans ``chunked_mha``, the same function (exact causal GQA attention with
an optional sliding window) under another implementation.  The
projections come out as (B, S, H, D); the kernels take their (B, H, S, D)
transposed views as they are and write the output in the layout ``wo``
reads, so no copy is made on either side.

Layers run as a Python loop, so ``is_global`` is a Python bool per layer:
a windowed layer passes ``window=cfg.window`` and a global one ``None``,
the function the reference's traced ``window_flag`` selects.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..configs.base import ArchConfig
from ..kernels import ops
from .common import Param, apply_rope

__all__ = ["attention_defs", "attention_fwd"]


def attention_defs(cfg: ArchConfig, q_heads: int,
                   kv_heads: int) -> Dict[str, Param]:
    d, hd = cfg.d_model, cfg.hd
    defs = {
        "wq": Param((d, q_heads, hd)),
        "wk": Param((d, kv_heads, hd)),
        "wv": Param((d, kv_heads, hd)),
        "wo": Param((q_heads, hd, d)),
    }
    if cfg.qkv_bias:
        defs["bq"] = Param((q_heads, hd), init="zeros")
        defs["bk"] = Param((kv_heads, hd), init="zeros")
        defs["bv"] = Param((kv_heads, hd), init="zeros")
    return defs


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum('bsd,dhk->bshk', x, w)`` as one matrix product."""
    b, s, d = x.shape
    return (x @ w.reshape(d, -1)).view(b, s, *w.shape[1:])


def _qkv(p, x: torch.Tensor, cfg: ArchConfig
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    dt = cfg.compute_dtype
    q = _proj(x, p["wq"].to(dt))
    k = _proj(x, p["wk"].to(dt))
    v = _proj(x, p["wv"].to(dt))
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    return q, k, v


def _rope_dual(x: torch.Tensor, positions: torch.Tensor, cfg: ArchConfig,
               is_global: bool) -> torch.Tensor:
    """RoPE with the local/global theta of mixed stacks (gemma3: 10k local,
    ``rope_theta`` global)."""
    if cfg.global_interval is None or is_global:
        return apply_rope(x, positions, cfg.rope_theta)
    return apply_rope(x, positions, 1e4)


def attention_fwd(p: Dict[str, torch.Tensor], x: torch.Tensor,
                  cfg: ArchConfig, is_global: bool, positions: torch.Tensor,
                  impl: str = "cuda") -> torch.Tensor:
    """Full-sequence attention (train / prefill without a cache).

    x (B, S, d_model) in the compute dtype → (B, S, d_model).  ``impl``
    goes to ``ops.flash_attention``: ``'cuda'`` runs the kernels for a
    tensor on the card, ``'ref'`` the plain versions anywhere.
    """
    q, k, v = _qkv(p, x, cfg)
    q = _rope_dual(q, positions, cfg, is_global)
    k = _rope_dual(k, positions, cfg, is_global)
    window = cfg.window if cfg.window is not None and not is_global else None
    o = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=cfg.causal,
                            window=window, impl=impl)
    b, s = x.shape[:2]
    wo = p["wo"].to(cfg.compute_dtype)
    return o.transpose(1, 2).reshape(b, s, -1) @ wo.reshape(-1, wo.shape[-1])

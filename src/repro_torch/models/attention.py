"""GQA attention (from ``repro.models.attention``): training, and the
dense inference path over a contiguous KV cache.

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

The dense inference path (``attention_prefill``, ``attention_decode``)
keeps each layer's K and V in a contiguous ``(B, max_len, KVH, hd)`` cache
(int8 codes with per-(token, head) scales when ``cfg.cache_dtype`` is
``'int8'``), written in place at the step's positions.  No TPU kernel sits
behind it in the reference, so its attention is plain tensor code: grouped
float32 scores, masked with -1e30, a float32 softmax and the weighted sum
of V, as the reference's decode attention computes them.  The prefill
takes its queries ``PREFILL_CHUNK`` at a time, so it holds at most
``(B, H, PREFILL_CHUNK, S)`` scores, as the reference's online softmax
over KV chunks of that size holds ``(B, S, H, PREFILL_CHUNK)``.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from ..configs.base import ArchConfig
from ..kernels import ops, ref
from .common import Param, apply_rope

__all__ = ["attention_decode", "attention_defs", "attention_fwd",
           "attention_prefill", "cache_dims", "init_kv_cache"]

#: Query rows a prefill attends at once (the reference's ``kv_chunk``).
PREFILL_CHUNK = 1024


def attention_defs(cfg: ArchConfig, q_heads: int,
                   kv_heads: int) -> Dict[str, Param]:
    d, hd = cfg.d_model, cfg.hd
    defs = {
        "wq": Param((d, q_heads, hd), ("fsdp", "heads", "head_dim")),
        "wk": Param((d, kv_heads, hd), ("fsdp", "kv_heads_w", "head_dim")),
        "wv": Param((d, kv_heads, hd), ("fsdp", "kv_heads_w", "head_dim")),
        "wo": Param((q_heads, hd, d), ("heads", "head_dim", "fsdp")),
    }
    if cfg.qkv_bias:
        defs["bq"] = Param((q_heads, hd), ("heads", "head_dim"),
                           init="zeros")
        defs["bk"] = Param((kv_heads, hd), ("kv_heads_w", "head_dim"),
                           init="zeros")
        defs["bv"] = Param((kv_heads, hd), ("kv_heads_w", "head_dim"),
                           init="zeros")
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


def _out_proj(p, out: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """``einsum('bshk,hkd->bsd', out, wo)`` as one matrix product."""
    b, s = out.shape[:2]
    wo = p["wo"].to(cfg.compute_dtype)
    return out.reshape(b, s, -1) @ wo.reshape(-1, wo.shape[-1])


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
    return _out_proj(p, o.transpose(1, 2), cfg)


# ---------------------------------------------------------------------------
# KV cache (contiguous): prefill fill and decode step
# ---------------------------------------------------------------------------


def init_kv_cache(cfg: ArchConfig, kv_heads: int, batch: int, max_len: int,
                  device: torch.device) -> Dict[str, torch.Tensor]:
    """One layer's cache tensors (the caller stacks the layers)."""
    shape = (batch, max_len, kv_heads, cfg.hd)
    if cfg.cache_dtype == "int8":
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(shape[:3], device=device),
            "v_scale": torch.zeros(shape[:3], device=device),
        }
    return {"k": torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.compute_dtype, device=device)}


def cache_dims(cfg: ArchConfig) -> Dict[str, tuple]:
    """The reference's logical dims of each cache leaf (for sharding
    specs)."""
    dims4 = ("cache_batch", "cache_seq", "kv_heads", "head_dim")
    dims3 = ("cache_batch", "cache_seq", "kv_heads")
    if cfg.cache_dtype == "int8":
        return {"k": dims4, "v": dims4, "k_scale": dims3, "v_scale": dims3}
    return {"k": dims4, "v": dims4}


def _store_kv(cache, k_new: torch.Tensor, v_new: torch.Tensor, pos: int,
              cfg: ArchConfig):
    """Write the S_new tokens' K and V at positions [pos, pos + S_new) of
    the cache, in place; returns the cache."""
    if cfg.cache_dtype == "int8":
        kq, ks = ref.int8_quantize(k_new, dim=-1)
        vq, vs = ref.int8_quantize(v_new, dim=-1)
        upd = {"k": kq, "v": vq, "k_scale": ks[..., 0], "v_scale": vs[..., 0]}
    else:
        upd = {"k": k_new, "v": v_new}
    for name, val in upd.items():
        cache[name][:, pos:pos + val.shape[1]] = val
    return cache


def _read_kv(cache, cfg: ArchConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    if cfg.cache_dtype == "int8":
        k = cache["k"].float() * cache["k_scale"][..., None]
        v = cache["v"].float() * cache["v_scale"][..., None]
        return k.to(cfg.compute_dtype), v.to(cfg.compute_dtype)
    return cache["k"], cache["v"]


def _cached_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      q_pos: torch.Tensor, cfg: ArchConfig, is_global: bool,
                      causal: bool) -> torch.Tensor:
    """q (B, C, H, hd) at positions ``q_pos`` (C,) over keys k, v
    (B, S, KVH, hd) at positions 0..S-1 → (B, C, H, hd) in the compute
    dtype.  Grouped float32 scores, masked by -1e30 where ``causal`` and
    the key lies past the query or, on a local layer, outside the window;
    float32 softmax."""
    b, c, h, hd = q.shape
    kvh = k.shape[2]
    rep = h // kvh
    qg = q.reshape(b, c, kvh, rep, hd).float() * (1.0 / math.sqrt(hd))
    sc = torch.einsum("bcgrd,bsgd->bgrcs", qg, k.float())
    kpos = torch.arange(k.shape[1], device=q.device)[None, :]   # (1, S)
    qpos = q_pos[:, None]                                       # (C, 1)
    mask = (kpos <= qpos) | (not causal)
    if cfg.window is not None and not is_global:
        mask = mask & ((qpos - kpos) < cfg.window)
    sc = torch.where(mask, sc, torch.tensor(-1e30, device=q.device))
    w = torch.softmax(sc, dim=-1)
    out = torch.einsum("bgrcs,bsgd->bcgrd", w, v.float())
    return out.reshape(b, c, h, hd).to(cfg.compute_dtype)


def attention_prefill(p, x: torch.Tensor, cfg: ArchConfig, is_global: bool,
                      cache) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Prefill: attention over the prompt's own S positions, its queries
    ``PREFILL_CHUNK`` at a time (a causal chunk reads only the keys up to
    its last row), and its K (after RoPE) and V into cache positions
    [0, S).  x (B, S, d_model)."""
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)
    q, k, v = _qkv(p, x, cfg)
    q = _rope_dual(q, positions, cfg, is_global)
    k = _rope_dual(k, positions, cfg, is_global)
    out = torch.empty_like(q)
    for i in range(0, s, PREFILL_CHUNK):
        j = min(i + PREFILL_CHUNK, s)
        kv_end = j if cfg.causal else s
        out[:, i:j] = _cached_attention(q[:, i:j], k[:, :kv_end],
                                        v[:, :kv_end], positions[i:j], cfg,
                                        is_global, cfg.causal)
    cache = _store_kv(cache, k, v, 0, cfg)
    return _out_proj(p, out, cfg), cache


def attention_decode(p, x: torch.Tensor, cfg: ArchConfig, is_global: bool,
                     cache, pos: int
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Decode (C = 1) or extend (C = chunk) against the cache: the C new
    tokens at positions [pos, pos + C) go into the cache first, then
    attend over all of it, masked to the positions each may see.
    x (B, C, d_model)."""
    positions = pos + torch.arange(x.shape[1], device=x.device)
    q, k_new, v_new = _qkv(p, x, cfg)
    q = _rope_dual(q, positions, cfg, is_global)
    k_new = _rope_dual(k_new, positions, cfg, is_global)
    cache = _store_kv(cache, k_new, v_new, pos, cfg)
    k, v = _read_kv(cache, cfg)
    out = _cached_attention(q, k, v, positions, cfg, is_global, True)
    return _out_proj(p, out, cfg), cache

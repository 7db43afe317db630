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
from ..parallel import collectives
from ..parallel.sharding import (constrain, is_dtensor, local_call,
                                 mesh_axis_size, partial_on)
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


Q_DIMS = ("act_batch", "seq", "heads", "head_dim")
KV_DIMS = ("act_batch", "seq", "kv_heads", "head_dim")
OUT_DIMS = ("act_batch", "seq", "d_model")


def _qkv(p, x: torch.Tensor, cfg: ArchConfig, rules=None
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    dt = cfg.compute_dtype
    if is_dtensor(x) and _kv_split(rules):
        q = _proj(x, p["wq"].to(dt))
        if cfg.qkv_bias:
            q = q + p["bq"].to(dt)
        k, v = (_KVProj.apply(x, p[w].to(dt), p[b].to(dt) if cfg.qkv_bias
                              else None, rules)
                for w, b in (("wk", "bk"), ("wv", "bv")))
    else:
        q = _proj(x, p["wq"].to(dt))
        k = _proj(x, p["wk"].to(dt))
        v = _proj(x, p["wv"].to(dt))
        if cfg.qkv_bias:
            q = q + p["bq"].to(dt)
            k = k + p["bk"].to(dt)
            v = v + p["bv"].to(dt)
    return (constrain(q, rules, Q_DIMS), constrain(k, rules, KV_DIMS),
            constrain(v, rules, KV_DIMS))


def _kv_split(rules) -> bool:
    """Whether the K and V weights shard their kv heads (``kv_heads_w``,
    over more than one device) while the activations keep them whole
    (``kv_heads`` unsharded)."""
    return (rules is not None and rules.axis("kv_heads") is None
            and rules.axis_size("kv_heads_w") > 1)


def _kv_gather(w, rules):
    """A K or V weight (D, KVH, hd) DTensor with its kv heads whole."""
    from torch.distributed.tensor import Replicate

    ax = rules.axis("kv_heads_w")
    axes = (ax,) if isinstance(ax, str) else tuple(ax)
    names = rules.mesh.axis_names
    want = tuple(Replicate() if names[i] in axes else pl
                 for i, pl in enumerate(w.placements))
    return w if want == tuple(w.placements) else w.redistribute(
        w.device_mesh, want)


class _KVProj(torch.autograd.Function):
    """The K or V projection of DTensors where the weight shards the kv
    heads and the activations keep them whole, partitioned as XLA
    partitions the reference's: forward, the whole weight gathered and
    every kv head projected (with a bias: each rank's heads projected,
    biased, and the activations gathered); backward, the gradient laid
    out whole, the input's gradient through the whole weight, and the
    weight's (and bias') gradient from each rank's block of heads only."""

    @staticmethod
    def forward(ctx, x, w, b, rules):
        ctx.save_for_backward(x, w)
        ctx.rules, ctx.has_bias = rules, b is not None
        if b is None:
            return _proj(x, _kv_gather(w, rules))
        return constrain(_proj(x, w) + b, rules, KV_DIMS)

    @staticmethod
    def backward(ctx, g):
        from ..parallel.sharding import placements

        x, w = ctx.saved_tensors
        rules = ctx.rules
        mesh = rules.mesh
        whole = placements(rules.spec(KV_DIMS), mesh)
        if tuple(g.placements) != whole:
            g = g.redistribute(mesh.device_mesh, whole)
        b, s, d = x.shape
        wf = _kv_gather(w, rules)
        dx = (g.reshape(b * s, -1) @ wf.reshape(d, -1).T).view(b, s, d)
        own = placements(rules.spec(KV_DIMS[:2] + ("kv_heads_w",
                                                     "head_dim")), mesh)
        gl = g.redistribute(mesh.device_mesh, own)
        dw = (x.reshape(b * s, d).T @ gl.reshape(b * s, -1)).view(w.shape)
        db = gl.sum(dim=(0, 1)) if ctx.has_bias else None
        return dx, dw, db, None


def _local_heads(fn, q, k, v, rules, q_seq=None):
    """``fn(q, k, v, q0)`` (B, S, heads, hd) → (B, S, H, hd) on each
    rank's block: its share of the batch and of the query heads, with the
    KV heads that those query heads read; ``q0`` is the position of the
    block's first query row.  Where the KV heads are not sharded with the
    query heads (``kv_heads`` whole, GQA), each rank takes the KV heads of
    its query block, and their gradients are partial sums over the heads
    axis.  ``q_seq`` (mesh axes) shards the query rows too, every rank
    reading all the keys."""
    mesh = rules.mesh
    q_spec = rules.spec(Q_DIMS)
    kv_spec = rules.spec(KV_DIMS)
    q0 = 0
    if q_seq:
        q_spec = (q_spec[0], q_seq) + q_spec[2:]
        q0 = (collectives.axis_index(mesh, q_seq) * q.shape[1]
              // mesh_axis_size(mesh, q_seq))
    heads_ax = q_spec[2]
    n_q = mesh_axis_size(mesh, heads_ax)
    n_kv = mesh_axis_size(mesh, kv_spec[2])
    h, kvh = q.shape[2], k.shape[2]
    grad = None
    if n_q > 1 and n_kv == 1:
        rep = h // kvh
        h_loc = h // n_q
        m = collectives.axis_index(mesh, heads_ax)
        lo, hi = m * h_loc // rep, ((m + 1) * h_loc - 1) // rep + 1
        grad = (None, partial_on(kv_spec, heads_ax, mesh),
                partial_on(kv_spec, heads_ax, mesh))
    else:
        lo, hi = 0, kvh

    def local(ql, kl, vl):
        return fn(ql, kl[:, :, lo:hi], vl[:, :, lo:hi], q0)

    return local_call(local, mesh, (q, k, v), (q_spec, kv_spec, kv_spec),
                      q_spec, grad)


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
                  impl: str = "cuda", rules=None) -> torch.Tensor:
    """Full-sequence attention (train / prefill without a cache).

    x (B, S, d_model) in the compute dtype → (B, S, d_model).  ``impl``
    goes to ``ops.flash_attention``: ``'cuda'`` runs the kernels for a
    tensor on the card, ``'ref'`` the plain versions anywhere.  On
    DTensors (``rules`` on a bound mesh) each rank attends over its own
    batch and heads (:func:`_local_heads`).
    """
    q, k, v = _qkv(p, x, cfg, rules)
    q = _rope_dual(q, positions, cfg, is_global)
    k = _rope_dual(k, positions, cfg, is_global)
    window = cfg.window if cfg.window is not None and not is_global else None

    def attend(q_, k_, v_, q0=0):
        o = ops.flash_attention(q_.transpose(1, 2), k_.transpose(1, 2),
                                v_.transpose(1, 2), causal=cfg.causal,
                                window=window, impl=impl)
        return o.transpose(1, 2)

    o = (_local_heads(attend, q, k, v, rules) if is_dtensor(q)
         else attend(q, k, v))
    return constrain(_out_proj(p, o, cfg), rules, OUT_DIMS)


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
              cfg: ArchConfig, rules=None):
    """Write the S_new tokens' K and V at positions [pos, pos + S_new) of
    the cache, in place; returns the cache.  On DTensors each rank writes
    the positions of its own block of the sequence-sharded cache
    (:func:`_write_local`)."""
    if cfg.cache_dtype == "int8":
        kq, ks = ref.int8_quantize(k_new, dim=-1)
        vq, vs = ref.int8_quantize(v_new, dim=-1)
        upd = {"k": kq, "v": vq, "k_scale": ks[..., 0], "v_scale": vs[..., 0]}
    else:
        upd = {"k": k_new, "v": v_new}
    dims = cache_dims(cfg)
    for name, val in upd.items():
        if is_dtensor(cache[name]):
            _write_local(cache[name], val, pos, rules, dims[name])
        else:
            cache[name][:, pos:pos + val.shape[1]] = val
    return cache


def _seq_block(rules, dims, length: int) -> Tuple[int, int]:
    """[lo, hi): the positions of this rank's block of a cache leaf of
    ``length`` positions laid out by ``dims``."""
    ax = rules.axis(dims[1])
    n = mesh_axis_size(rules.mesh, ax)
    if n == 1:
        return 0, length
    m = collectives.axis_index(rules.mesh, ax)
    return m * length // n, (m + 1) * length // n


def _write_local(dst, val, pos: int, rules, dims) -> None:
    """Write ``val`` (B, C, ...) at positions [pos, pos + C) of the
    DTensor cache leaf ``dst`` (B, S, ...), laid out by ``dims``: ``val``
    goes to the cache's layout with its C positions whole, and each rank
    writes those of them that fall in its block of S, in place."""
    from ..parallel.sharding import placements

    mesh = rules.mesh
    spec = list(rules.spec(dims))
    spec[1] = None
    if not is_dtensor(val):
        from torch.distributed.tensor import DTensor, Replicate

        val = DTensor.from_local(val, mesh.device_mesh,
                                 [Replicate()] * len(mesh.axis_names),
                                 run_check=False)
    want = placements(tuple(spec), mesh)
    if tuple(val.placements) != want:
        val = val.redistribute(mesh.device_mesh, want)
    lo, hi = _seq_block(rules, dims, dst.shape[1])
    a, b = max(lo, pos), min(hi, pos + val.shape[1])
    if a < b:
        dst.to_local()[:, a - lo:b - lo] = val.to_local()[:, a - pos:b - pos]


def _read_kv(cache, cfg: ArchConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    if cfg.cache_dtype == "int8":
        k = cache["k"].float() * cache["k_scale"][..., None]
        v = cache["v"].float() * cache["v_scale"][..., None]
        return k.to(cfg.compute_dtype), v.to(cfg.compute_dtype)
    return cache["k"], cache["v"]


def _scores(q: torch.Tensor, k: torch.Tensor, q_pos: torch.Tensor,
            cfg: ArchConfig, is_global: bool, causal: bool,
            k0: int = 0) -> torch.Tensor:
    """Grouped float32 scores (B, KVH, H/KVH, C, S) of q (B, C, H, hd) at
    positions ``q_pos`` (C,) over keys k (B, S, KVH, hd) at positions
    k0..k0+S-1, -1e30 where ``causal`` and the key lies past the query
    or, on a local layer, outside the window."""
    b, c, h, hd = q.shape
    kvh = k.shape[2]
    rep = h // kvh
    qg = q.reshape(b, c, kvh, rep, hd).float() * (1.0 / math.sqrt(hd))
    sc = torch.einsum("bcgrd,bsgd->bgrcs", qg, k.float())
    kpos = k0 + torch.arange(k.shape[1], device=q.device)[None, :]  # (1, S)
    qpos = q_pos[:, None]                                       # (C, 1)
    mask = (kpos <= qpos) | (not causal)
    if cfg.window is not None and not is_global:
        mask = mask & ((qpos - kpos) < cfg.window)
    return torch.where(mask, sc, torch.tensor(-1e30, device=q.device))


def _cached_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      q_pos: torch.Tensor, cfg: ArchConfig, is_global: bool,
                      causal: bool) -> torch.Tensor:
    """q (B, C, H, hd) at positions ``q_pos`` (C,) over keys k, v
    (B, S, KVH, hd) at positions 0..S-1 → (B, C, H, hd) in the compute
    dtype: :func:`_scores`, float32 softmax."""
    b, c, h, hd = q.shape
    w = torch.softmax(_scores(q, k, q_pos, cfg, is_global, causal), dim=-1)
    out = torch.einsum("bgrcs,bsgd->bcgrd", w, v.float())
    return out.reshape(b, c, h, hd).to(cfg.compute_dtype)


def attention_prefill(p, x: torch.Tensor, cfg: ArchConfig, is_global: bool,
                      cache, rules=None
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Prefill: attention over the prompt's own S positions, its queries
    ``PREFILL_CHUNK`` at a time (a causal chunk reads only the keys up to
    its last row), and its K (after RoPE) and V into cache positions
    [0, S).  x (B, S, d_model).  On DTensors each rank attends over its
    own batch and heads (:func:`_local_heads`)."""
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)
    q, k, v = _qkv(p, x, cfg, rules)
    q = _rope_dual(q, positions, cfg, is_global)
    k = _rope_dual(k, positions, cfg, is_global)

    def attend(q_, k_, v_, q0=0):
        out = torch.empty_like(q_)
        rows = q_.shape[1]
        for i in range(0, rows, PREFILL_CHUNK):
            j = min(i + PREFILL_CHUNK, rows)
            # a block of the rows (q_seq) reads every key, as XLA does
            kv_end = j if cfg.causal and rows == s else s
            out[:, i:j] = _cached_attention(
                q_[:, i:j], k_[:, :kv_end], v_[:, :kv_end],
                positions[q0 + i:q0 + j], cfg, is_global, cfg.causal)
        return out

    if is_dtensor(q):
        # Without a sharded batch the query rows go over the batch axes,
        # as XLA partitions the reference's prefill attention.
        q_seq = None
        if rules.axis("act_batch") is None:
            q_seq = tuple(a for a in ("pod", "data")
                          if a in rules.mesh.axis_names) or None
        out = constrain(_local_heads(attend, q, k, v, rules, q_seq), rules,
                        Q_DIMS)
    else:
        out = attend(q, k, v)
    cache = _store_kv(cache, k, v, 0, cfg, rules)
    return constrain(_out_proj(p, out, cfg), rules, OUT_DIMS), cache


def attention_decode(p, x: torch.Tensor, cfg: ArchConfig, is_global: bool,
                     cache, pos: int, rules=None
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Decode (C = 1) or extend (C = chunk) against the cache: the C new
    tokens at positions [pos, pos + C) go into the cache first, then
    attend over all of it, masked to the positions each may see.
    x (B, C, d_model).  On DTensors the cache is sharded over sequence and
    each rank attends over its block (:func:`_decode_local`)."""
    positions = pos + torch.arange(x.shape[1], device=x.device)
    q, k_new, v_new = _qkv(p, x, cfg, rules)
    q = _rope_dual(q, positions, cfg, is_global)
    k_new = _rope_dual(k_new, positions, cfg, is_global)
    cache = _store_kv(cache, k_new, v_new, pos, cfg, rules)
    if is_dtensor(cache["k"]):
        # every head comes back to each rank: its block of the heads
        # meets the output projection's block of the weight
        out = constrain(_decode_local(q, cache, positions, cfg, is_global,
                                      rules), rules, Q_DIMS)
    else:
        k, v = _read_kv(cache, cfg)
        out = _cached_attention(q, k, v, positions, cfg, is_global, True)
    return constrain(_out_proj(p, out, cfg), rules, OUT_DIMS), cache


def _decode_local(q, cache, positions: torch.Tensor, cfg: ArchConfig,
                  is_global: bool, rules):
    """The decode attention on the sequence-sharded cache (flash-decoding
    over the ``cache_seq`` axes): each rank takes every query head of its
    batch block, scores its block of the cache (:func:`_scores`), and
    three reductions over the sequence axes (the row maxima, the softmax
    denominators, the weighted values) give every rank the rows of its
    batch block.  Returns (B, C,
    H, hd) DTensor, batch as the cache's."""
    import torch.distributed as dist

    mesh = rules.mesh
    dims = cache_dims(cfg)
    seq_ax = rules.axis("cache_seq")
    n_seq = mesh_axis_size(mesh, seq_ax)
    group = collectives.axis_group(mesh, seq_ax) if n_seq > 1 else None
    length = cache["k"].shape[1]
    lo, _ = _seq_block(rules, dims["k"], length)
    q_spec = (rules.axis("cache_batch"), None, None, None)
    names = ("k", "v", "k_scale", "v_scale") if cfg.cache_dtype == "int8" \
        else ("k", "v")
    leaves = [cache[n] for n in names]

    def fn(ql, *blocks):
        kl, vl = _read_kv(dict(zip(names, blocks)), cfg)
        b, c, h, hd = ql.shape
        sc = _scores(ql, kl, positions, cfg, is_global, True, lo)
        m = sc.amax(dim=-1, keepdim=True)
        if group is not None:
            dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
        w = torch.exp(sc - m)
        den = w.sum(dim=-1, keepdim=True)
        out = torch.einsum("bgrcs,bsgd->bcgrd", w, vl.float())
        if group is not None:
            dist.all_reduce(den, group=group)
            dist.all_reduce(out, group=group)
        out = out / den.permute(0, 3, 1, 2, 4)
        return out.reshape(b, c, h, hd).to(cfg.compute_dtype)

    specs = [q_spec] + [rules.spec(dims[n]) for n in names]
    return local_call(fn, mesh, [q] + leaves, specs, q_spec)

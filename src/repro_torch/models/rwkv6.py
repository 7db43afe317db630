"""RWKV6 "Finch" block: data-dependent-decay time mix and channel mix
(the port's ``repro.models.rwkv6``).

The WKV recurrence  S_t = diag(w_t) S_{t-1} + k_t v_tᵀ,
                    y_t = r_t · (S_{t-1} + diag(u) k_t v_tᵀ)
has two forms in :func:`wkv6`.  ``chunk=None`` steps the state token by
token (:func:`~.common.decayed_cumsum`); the recurrent serving engine
runs it.  ``chunk=C`` is the reference's training form, which the ``lm``
paths run: chunks of C tokens (:data:`CHUNK` = 32, the reference's),
each solved in log-depth (:func:`~.common.decayed_scan`) under
``torch.utils.checkpoint`` when gradients are on, so the backward keeps
only the (B, H, hd, hd) state between chunks.  Without it a 4k sequence
keeps T/C x C·B·H·hd² bytes of scan residuals: the reference records
62 GB a device at rwkv6-3b's 4k training shape before it chunked.  For
T = 1 both forms run the same operations.  The dtypes follow the
reference exactly: activations and the projections in
``cfg.compute_dtype``, the decay, the recurrence and the group-norm
statistics in float32.  ``rules`` (on a bound mesh, DTensors) constrain
the activations where the reference does.

Every block function takes the float32 parameters ``p`` and, optionally,
``pf``, the same tree already cast to the compute dtype: the reference
casts inside the traced step, where XLA folds the casts, while an eager
step would cast every weight on every token.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..parallel.sharding import (constrain, is_dtensor, local_call,
                                 partial_on)
from .common import (Param, cast_tree, decayed_cumsum, decayed_scan,
                     rms_norm)

__all__ = [
    "CHUNK",
    "HEAD_DIM",
    "LORA_R",
    "channel_mix",
    "init_rwkv_state",
    "rwkv_block",
    "rwkv_defs",
    "rwkv_heads",
    "rwkv_state_dims",
    "rwkv_state_specs",
    "time_mix",
    "wkv6",
]

LORA_R = 32
HEAD_DIM = 64
MIX_NAMES = ("r", "w", "k", "v", "g")
#: Tokens a chunk of the ``lm`` paths' scan (the reference's 32).
CHUNK = 32


def rwkv_heads(cfg: ArchConfig, padded: bool = False) -> int:
    """WKV heads: d_model / 64, or ``cfg.tp_pad_heads`` when ``padded``
    (tensor-parallel layouts pad the heads to divide the model axis)."""
    if padded and cfg.tp_pad_heads:
        return cfg.tp_pad_heads
    return cfg.d_model // HEAD_DIM


def rwkv_defs(cfg: ArchConfig, heads: Optional[int] = None) -> Dict[str, Any]:
    d, f = cfg.d_model, cfg.d_ff
    h = heads or rwkv_heads(cfg)
    tm = {
        "mu_x": Param((d,), ("d_model",), init="zeros"),
        "mu": Param((5, d), (None, "d_model"), init="zeros"),
        "lora_a": Param((5, d, LORA_R), (None, "d_model", None),
                        scale=0.01),
        "lora_b": Param((5, LORA_R, d), (None, None, "d_model"),
                        scale=0.01),
        "w_base": Param((h, HEAD_DIM), ("heads", "head_dim"), init="zeros"),
        "wa": Param((d, LORA_R * 2), ("d_model", None), scale=0.01),
        "wb": Param((LORA_R * 2, h, HEAD_DIM), (None, "heads", "head_dim"),
                    scale=0.01),
        "u": Param((h, HEAD_DIM), ("heads", "head_dim"), init="zeros"),
        "wr": Param((d, h, HEAD_DIM), ("fsdp", "heads", "head_dim")),
        "wk": Param((d, h, HEAD_DIM), ("fsdp", "heads", "head_dim")),
        "wv": Param((d, h, HEAD_DIM), ("fsdp", "heads", "head_dim")),
        "wg": Param((d, h, HEAD_DIM), ("fsdp", "heads", "head_dim")),
        "wo": Param((h, HEAD_DIM, d), ("heads", "head_dim", "fsdp")),
        "ln_g": Param((h, HEAD_DIM), ("heads", "head_dim"), init="zeros"),
    }
    cm = {
        "mu_k": Param((d,), ("d_model",), init="zeros"),
        "mu_r": Param((d,), ("d_model",), init="zeros"),
        "wk": Param((d, f), ("fsdp", "d_ff")),
        "wv": Param((f, d), ("d_ff", "fsdp")),
        # the receptance gate's output dim shards over the model axis
        "wr": Param((d, d), ("fsdp", "heads")),
    }
    return {"tm": tm, "cm": cm}


def rwkv_state_specs(cfg: ArchConfig, heads: Optional[int] = None
                     ) -> Dict[str, Tuple[tuple, torch.dtype]]:
    """State name → (per-sequence per-layer row shape, dtype)."""
    d, h = cfg.d_model, heads or rwkv_heads(cfg)
    return {
        "s": ((h, HEAD_DIM, HEAD_DIM), torch.float32),
        "x_tm": ((d,), cfg.compute_dtype),
        "x_cm": ((d,), cfg.compute_dtype),
    }


OUT_DIMS = ("act_batch", "seq", "d_model")


def _shift(x: torch.Tensor, x_last: Optional[torch.Tensor]) -> torch.Tensor:
    """Token shift: the previous token's activation (zeros or the carried
    one at t = 0)."""
    prev = torch.zeros_like(x[:, :1]) if x_last is None else x_last[:, None]
    return torch.cat([prev, x[:, :-1]], dim=1)


def _wkv_tokens(s: torch.Tensor, r: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor, w: torch.Tensor, u: torch.Tensor,
                stepped: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tokens r, k, v, w (T, B, H, hd) float32 from state s (B, H, hd, hd)
    → (the state after them, y (T, B, H, hd) float32); ``stepped`` steps
    the state token by token, else it is solved in log-depth."""
    kv = k[..., None] * v[..., None, :]                      # (T,B,H,hd,hd)
    if stepped:
        hs, s_new = decayed_cumsum(w[..., None].expand(kv.shape), kv, s)
    else:
        hs = decayed_scan(w[..., None], kv, s)
        s_new = hs[-1]
    s_prev = torch.cat([s[None], hs[:-1]], dim=0)
    y = torch.einsum("tbhk,tbhkv->tbhv", r, s_prev)
    bonus = torch.einsum("tbhk,hk,tbhk->tbh", r, u, k)
    return s_new, y + bonus[..., None] * v


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor, s0: torch.Tensor, chunk: Optional[int] = None
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, w (B, T, H, hd); u (H, hd); s0 (B, H, hd, hd) float32 →
    (y in r's dtype, final state float32).  ``chunk`` picks the form
    (module doc): None steps token by token, an int solves chunks of that
    many tokens (the last may be shorter)."""
    rt, kt, vt, wt = (x.float().transpose(0, 1) for x in (r, k, v, w))
    u32, s = u.float(), s0.float()
    if chunk is None:
        s, y = _wkv_tokens(s, rt, kt, vt, wt, u32, stepped=True)
    else:
        ys = []
        for i in range(0, rt.shape[0], chunk):
            part = [x[i:i + chunk] for x in (rt, kt, vt, wt)]
            if torch.is_grad_enabled():
                s, yc = checkpoint(_wkv_tokens, s, *part, u32,
                                   use_reentrant=False)
            else:
                s, yc = _wkv_tokens(s, *part, u32)
            ys.append(yc)
        y = torch.cat(ys) if len(ys) > 1 else ys[0]
    return y.transpose(0, 1).to(r.dtype), s


def _ddlerp(p, x, sx):
    """Data-dependent lerp producing the five mixed inputs (r, w, k, v, g)."""
    xxx = x + sx * p["mu_x"]
    out = {}
    for i, name in enumerate(MIX_NAMES):
        lora = torch.tanh(xxx @ p["lora_a"][i]) @ p["lora_b"][i]
        out[name] = x + sx * (p["mu"][i] + lora)
    return out


def _wkv_local(r, k, v, w, u, s0, chunk, rules):
    """:func:`wkv6` on DTensors: each rank runs its batch block's heads
    (the heads on the ``heads`` axis), and its share of u's gradient; a
    zero state (``s0`` None) is made on the rank."""
    tok = rules.spec(("act_batch", "seq", "heads", None))
    st = rules.spec(("act_batch", "heads", None, None))
    # u is the same on every batch shard: its gradient sums over them
    grad_u = partial_on((st[1], None), rules.axis("act_batch"), rules.mesh)

    def fn(r_, k_, v_, w_, u_, s_):
        if s_ is None:
            s_ = torch.zeros(r_.shape[:1] + r_.shape[2:3]
                             + (HEAD_DIM, HEAD_DIM), device=r_.device)
        return wkv6(r_, k_, v_, w_, u_, s_, chunk)

    return local_call(fn, rules.mesh, (r, k, v, w, u, s0),
                      (tok, tok, tok, tok, (st[1], None), st), [tok, st],
                      (None, None, None, None, grad_u, None))


def time_mix(p, x: torch.Tensor, cfg: ArchConfig,
             state: Optional[Dict[str, torch.Tensor]] = None, pf=None,
             chunk: Optional[int] = None, rules=None):
    """x (B, T, D); state ``{'s': (B,H,hd,hd), 'x_tm': (B,D)}`` or None.
    Returns (out (B, T, D), ``{'s', 'x_tm'}``); ``chunk`` goes to
    :func:`wkv6`.  On DTensors the scan runs on each rank's batch and
    heads (:func:`_wkv_local`).  The reference's constraint of r, k and v
    discards its result, so none is made here."""
    dt = cfg.compute_dtype
    pf = pf if pf is not None else cast_tree(p, dt)
    b = x.shape[0]
    h = p["u"].shape[0]
    x_last = None if state is None else state["x_tm"]
    sx = _shift(x, x_last) - x
    mixed = _ddlerp(pf, x, sx)
    if is_dtensor(x):
        # The mixes' gradients are summed over the heads axis here, so the
        # data-dependent lerp's backward runs on every token, as XLA
        # partitions the reference's.
        mixed = {k: constrain(v, rules, ("act_batch", "seq", "d_model"))
                 for k, v in mixed.items()}

    r = torch.einsum("bsd,dhk->bshk", mixed["r"], pf["wr"])
    k = torch.einsum("bsd,dhk->bshk", mixed["k"], pf["wk"])
    v = torch.einsum("bsd,dhk->bshk", mixed["v"], pf["wv"])
    g = F.silu(torch.einsum("bsd,dhk->bshk", mixed["g"], pf["wg"]))
    w_log = p["w_base"].float() + torch.einsum(
        "bsd,dr,rhk->bshk", mixed["w"].float(), torch.tanh(p["wa"].float()),
        p["wb"].float())
    w = torch.exp(-torch.exp(w_log))

    if is_dtensor(r):
        y, s_new = _wkv_local(r, k, v, w.to(r.dtype), p["u"],
                              None if state is None else state["s"], chunk,
                              rules)
    else:
        s0 = (torch.zeros((b, h, HEAD_DIM, HEAD_DIM), device=x.device)
              if state is None else state["s"])
        y, s_new = wkv6(r, k, v, w.to(r.dtype), p["u"], s0, chunk)

    # Per-head group norm, statistics in float32.
    y32 = y.float()
    mu = y32.mean(dim=-1, keepdim=True)
    var = y32.var(dim=-1, keepdim=True, unbiased=False)
    y = ((y - mu) * torch.rsqrt(var + 1e-5)).to(dt)
    y = y * (1.0 + pf["ln_g"]) * g
    out = torch.einsum("bshk,hkd->bsd", y, pf["wo"])
    return constrain(out, rules, OUT_DIMS), {"s": s_new, "x_tm": x[:, -1]}


def channel_mix(p, x: torch.Tensor, cfg: ArchConfig,
                state: Optional[Dict[str, torch.Tensor]] = None, pf=None,
                rules=None):
    """x (B, T, D); state ``{'x_cm': (B, D)}`` or None.  Returns
    (out, ``{'x_cm'}``)."""
    dt = cfg.compute_dtype
    pf = pf if pf is not None else cast_tree(p, dt)
    x_last = None if state is None else state["x_cm"]
    sx = _shift(x, x_last) - x
    xk = x + sx * pf["mu_k"]
    xr = x + sx * pf["mu_r"]
    k = constrain(torch.square(torch.relu(xk @ pf["wk"])), rules,
                  ("act_batch", "seq", "d_ff"))
    v = k @ pf["wv"]
    r = torch.sigmoid(xr @ pf["wr"])
    if is_dtensor(r):
        # the gate gathered whole, the product's partial sums then summed
        # once, as XLA partitions the reference's
        r = constrain(r, rules, OUT_DIMS)
    return constrain(r * v, rules, OUT_DIMS), {"x_cm": x[:, -1]}


def rwkv_block(p, x: torch.Tensor, cfg: ArchConfig, norms,
               state: Optional[Dict[str, torch.Tensor]] = None, pf=None,
               chunk: Optional[int] = None, rules=None):
    """One RWKV layer: x + TM(norm(x)); x + CM(norm(x)).  Returns
    (x, state).  ``p`` holds ``tm`` and ``cm``; ``norms`` ``ln1``/``ln2``;
    ``chunk`` goes to :func:`wkv6`."""
    pf = pf if pf is not None else cast_tree(p, cfg.compute_dtype)
    tm_out, st_tm = time_mix(p["tm"], rms_norm(x, norms["ln1"]), cfg, state,
                             pf=pf["tm"], chunk=chunk, rules=rules)
    x = x + tm_out
    cm_out, st_cm = channel_mix(p["cm"], rms_norm(x, norms["ln2"]), cfg,
                                state, pf=pf["cm"], rules=rules)
    x = x + cm_out
    return x, {**st_tm, **st_cm}


def init_rwkv_state(cfg: ArchConfig, batch: int, device: torch.device,
                    heads: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """A zero state: ``s`` (B, H, hd, hd) float32, ``x_tm`` and ``x_cm``
    (B, D) in the compute dtype; H is ``heads`` or d_model / 64."""
    return {name: torch.zeros((batch,) + shape, dtype=dtype, device=device)
            for name, (shape, dtype) in rwkv_state_specs(cfg, heads).items()}


def rwkv_state_dims(cfg: ArchConfig) -> Dict[str, tuple]:
    """The reference's logical dims of each state leaf (for sharding
    specs)."""
    return {
        "s": ("cache_batch", "heads", None, None),
        "x_tm": ("cache_batch", None),
        "x_cm": ("cache_batch", None),
    }

"""RWKV6 "Finch" block: data-dependent-decay time mix and channel mix
(the port's ``repro.models.rwkv6``).

The WKV recurrence  S_t = diag(w_t) S_{t-1} + k_t v_tᵀ,
                    y_t = r_t · (S_{t-1} + diag(u) k_t v_tᵀ)
runs through :func:`~.common.decayed_cumsum`.  The dtypes follow the
reference exactly: activations and the projections in
``cfg.compute_dtype``, the decay, the recurrence and the group-norm
statistics in float32.  Sharding constraints are left out (no-ops here).

Every block function takes the float32 parameters ``p`` and, optionally,
``pf``, the same tree already cast to the compute dtype: the reference
casts inside the traced step, where XLA folds the casts, while an eager
step would cast every weight on every token.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from .common import Param, cast_tree, decayed_cumsum, rms_norm

__all__ = [
    "HEAD_DIM",
    "LORA_R",
    "channel_mix",
    "rwkv_block",
    "rwkv_defs",
    "rwkv_heads",
    "rwkv_state_specs",
    "time_mix",
    "wkv6",
]

LORA_R = 32
HEAD_DIM = 64
MIX_NAMES = ("r", "w", "k", "v", "g")


def rwkv_heads(cfg: ArchConfig) -> int:
    return cfg.d_model // HEAD_DIM


def rwkv_defs(cfg: ArchConfig, heads: Optional[int] = None) -> Dict[str, Any]:
    d, f = cfg.d_model, cfg.d_ff
    h = heads or rwkv_heads(cfg)
    tm = {
        "mu_x": Param((d,), init="zeros"),
        "mu": Param((5, d), init="zeros"),
        "lora_a": Param((5, d, LORA_R), scale=0.01),
        "lora_b": Param((5, LORA_R, d), scale=0.01),
        "w_base": Param((h, HEAD_DIM), init="zeros"),
        "wa": Param((d, LORA_R * 2), scale=0.01),
        "wb": Param((LORA_R * 2, h, HEAD_DIM), scale=0.01),
        "u": Param((h, HEAD_DIM), init="zeros"),
        "wr": Param((d, h, HEAD_DIM)),
        "wk": Param((d, h, HEAD_DIM)),
        "wv": Param((d, h, HEAD_DIM)),
        "wg": Param((d, h, HEAD_DIM)),
        "wo": Param((h, HEAD_DIM, d)),
        "ln_g": Param((h, HEAD_DIM), init="zeros"),
    }
    cm = {
        "mu_k": Param((d,), init="zeros"),
        "mu_r": Param((d,), init="zeros"),
        "wk": Param((d, f)),
        "wv": Param((f, d)),
        "wr": Param((d, d)),
    }
    return {"tm": tm, "cm": cm}


def rwkv_state_specs(cfg: ArchConfig) -> Dict[str, Tuple[tuple, torch.dtype]]:
    """State name → (per-sequence per-layer row shape, dtype)."""
    d, h = cfg.d_model, rwkv_heads(cfg)
    return {
        "s": ((h, HEAD_DIM, HEAD_DIM), torch.float32),
        "x_tm": ((d,), cfg.compute_dtype),
        "x_cm": ((d,), cfg.compute_dtype),
    }


def _shift(x: torch.Tensor, x_last: Optional[torch.Tensor]) -> torch.Tensor:
    """Token shift: the previous token's activation (zeros or the carried
    one at t = 0)."""
    prev = torch.zeros_like(x[:, :1]) if x_last is None else x_last[:, None]
    return torch.cat([prev, x[:, :-1]], dim=1)


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor, s0: torch.Tensor
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, w (B, T, H, hd); u (H, hd); s0 (B, H, hd, hd) float32 →
    (y in r's dtype, final state float32)."""
    hd = r.shape[-1]
    rt, kt, vt, wt = (x.float().transpose(0, 1) for x in (r, k, v, w))
    a = wt[..., None].expand(wt.shape + (hd,))                # (T,B,H,hd,hd)
    bb = kt[..., None] * vt[..., None, :]
    hs, s_new = decayed_cumsum(a, bb, s0.float())
    s_prev = torch.cat([s0.float()[None], hs[:-1]], dim=0)
    y = torch.einsum("tbhk,tbhkv->tbhv", rt, s_prev)
    bonus = torch.einsum("tbhk,hk,tbhk->tbh", rt, u.float(), kt)
    y = y + bonus[..., None] * vt
    return y.transpose(0, 1).to(r.dtype), s_new


def _ddlerp(p, x, sx):
    """Data-dependent lerp producing the five mixed inputs (r, w, k, v, g)."""
    xxx = x + sx * p["mu_x"]
    out = {}
    for i, name in enumerate(MIX_NAMES):
        lora = torch.tanh(xxx @ p["lora_a"][i]) @ p["lora_b"][i]
        out[name] = x + sx * (p["mu"][i] + lora)
    return out


def time_mix(p, x: torch.Tensor, cfg: ArchConfig,
             state: Optional[Dict[str, torch.Tensor]] = None, pf=None):
    """x (B, T, D); state ``{'s': (B,H,hd,hd), 'x_tm': (B,D)}`` or None.
    Returns (out (B, T, D), ``{'s', 'x_tm'}``)."""
    dt = cfg.compute_dtype
    pf = pf if pf is not None else cast_tree(p, dt)
    b = x.shape[0]
    h = p["u"].shape[0]
    x_last = None if state is None else state["x_tm"]
    sx = _shift(x, x_last) - x
    mixed = _ddlerp(pf, x, sx)

    r = torch.einsum("bsd,dhk->bshk", mixed["r"], pf["wr"])
    k = torch.einsum("bsd,dhk->bshk", mixed["k"], pf["wk"])
    v = torch.einsum("bsd,dhk->bshk", mixed["v"], pf["wv"])
    g = F.silu(torch.einsum("bsd,dhk->bshk", mixed["g"], pf["wg"]))
    w_log = p["w_base"].float() + torch.einsum(
        "bsd,dr,rhk->bshk", mixed["w"].float(), torch.tanh(p["wa"].float()),
        p["wb"].float())
    w = torch.exp(-torch.exp(w_log))

    s0 = (torch.zeros((b, h, HEAD_DIM, HEAD_DIM), device=x.device)
          if state is None else state["s"])
    y, s_new = wkv6(r, k, v, w.to(r.dtype), p["u"], s0)

    # Per-head group norm, statistics in float32.
    y32 = y.float()
    mu = y32.mean(dim=-1, keepdim=True)
    var = y32.var(dim=-1, keepdim=True, unbiased=False)
    y = ((y - mu) * torch.rsqrt(var + 1e-5)).to(dt)
    y = y * (1.0 + pf["ln_g"]) * g
    out = torch.einsum("bshk,hkd->bsd", y, pf["wo"])
    return out, {"s": s_new, "x_tm": x[:, -1]}


def channel_mix(p, x: torch.Tensor, cfg: ArchConfig,
                state: Optional[Dict[str, torch.Tensor]] = None, pf=None):
    """x (B, T, D); state ``{'x_cm': (B, D)}`` or None.  Returns
    (out, ``{'x_cm'}``)."""
    dt = cfg.compute_dtype
    pf = pf if pf is not None else cast_tree(p, dt)
    x_last = None if state is None else state["x_cm"]
    sx = _shift(x, x_last) - x
    xk = x + sx * pf["mu_k"]
    xr = x + sx * pf["mu_r"]
    k = torch.square(torch.relu(xk @ pf["wk"]))
    v = k @ pf["wv"]
    r = torch.sigmoid(xr @ pf["wr"])
    return r * v, {"x_cm": x[:, -1]}


def rwkv_block(p, x: torch.Tensor, cfg: ArchConfig, norms,
               state: Optional[Dict[str, torch.Tensor]] = None, pf=None):
    """One RWKV layer: x + TM(norm(x)); x + CM(norm(x)).  Returns
    (x, state).  ``p`` holds ``tm`` and ``cm``; ``norms`` ``ln1``/``ln2``."""
    pf = pf if pf is not None else cast_tree(p, cfg.compute_dtype)
    tm_out, st_tm = time_mix(p["tm"], rms_norm(x, norms["ln1"]), cfg, state,
                             pf=pf["tm"])
    x = x + tm_out
    cm_out, st_cm = channel_mix(p["cm"], rms_norm(x, norms["ln2"]), cfg,
                                state, pf=pf["cm"])
    x = x + cm_out
    return x, {**st_tm, **st_cm}

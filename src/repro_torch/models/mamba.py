"""Selective SSM (S6 / Mamba) head (the port's ``repro.models.mamba``).

The selective scan  h_t = exp(Δ_t ⊙ A) h_{t-1} + Δ_t B_t x_t,  y_t = C_t·h_t
runs through :func:`~.common.decayed_cumsum`, with Δ, B and C projected per
token.  Dtypes follow the reference: the projections and the causal conv in
``cfg.compute_dtype``, Δ, the decay and the state in float32.  The Hymba
hybrid block of the reference is not ported (no serving path uses it);
sharding constraints are left out.

As in :mod:`.rwkv6`, the functions take the float32 parameters ``p`` and
optionally ``pf``, the same tree cast to the compute dtype once.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from .common import Param, cast_tree, decayed_cumsum

__all__ = ["mamba_defs", "mamba_dims", "mamba_fwd", "mamba_state_specs"]


def mamba_dims(cfg: ArchConfig) -> Tuple[int, int, int]:
    """(d_inner, dt_rank, state size N)."""
    d_inner = 2 * cfg.d_model
    dt_rank = max(1, math.ceil(cfg.d_model / 16))
    return d_inner, dt_rank, cfg.ssm_state


def mamba_defs(cfg: ArchConfig) -> Dict[str, Param]:
    d = cfg.d_model
    di, r, n = mamba_dims(cfg)
    k = cfg.ssm_conv
    return {
        "w_in": Param((d, 2 * di)),
        "conv_w": Param((k, di), scale=0.1),
        "conv_b": Param((di,), init="zeros"),
        "w_x": Param((di, r + 2 * n)),
        "w_dt": Param((r, di)),
        "b_dt": Param((di,), init="zeros"),
        "a_log": Param((di, n), init="ones"),
        "d_skip": Param((di,), init="ones"),
        "w_out": Param((di, d)),
    }


def mamba_state_specs(cfg: ArchConfig
                      ) -> Dict[str, Tuple[tuple, torch.dtype]]:
    """State name → (per-sequence per-layer row shape, dtype)."""
    di, _, n = mamba_dims(cfg)
    return {
        "h": ((di, n), torch.float32),
        "conv": ((cfg.ssm_conv - 1, cfg.d_model * 2), cfg.compute_dtype),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 tail: Optional[torch.Tensor] = None):
    """Depthwise causal conv over time.  x (B,T,di); w (K,di); tail
    (B,K-1,di).  Returns (out, new tail)."""
    k = w.shape[0]
    pad = torch.zeros_like(x[:, : k - 1]) if tail is None else tail
    xp = torch.cat([pad, x], dim=1)
    t = x.shape[1]
    out = sum(xp[:, i:i + t] * w[i] for i in range(k))
    new_tail = xp[:, -(k - 1):] if k > 1 else None
    return out + b, new_tail


def mamba_fwd(p, x: torch.Tensor, cfg: ArchConfig,
              state: Optional[Dict[str, torch.Tensor]] = None, pf=None):
    """x (B, T, D) → (y (B, T, D), ``{'h', 'conv'}``)."""
    dt_ = cfg.compute_dtype
    pf = pf if pf is not None else cast_tree(p, dt_)
    b, t, _ = x.shape
    di, r, n = mamba_dims(cfg)
    xz = x @ pf["w_in"]
    xm, z = torch.chunk(xz, 2, dim=-1)
    tail = None if state is None else state["conv"]
    xm, new_tail = _causal_conv(xm, pf["conv_w"], pf["conv_b"], tail)
    xm = F.silu(xm)

    a = -torch.exp(p["a_log"].float())                       # (di, N)
    h0 = (torch.zeros((b, di, n), device=x.device) if state is None
          else state["h"])
    xt = xm.transpose(0, 1)                                  # (T, B, di)
    proj = xt @ pf["w_x"]                                    # (T, B, r+2N)
    dt_r, bm, cm = torch.split(proj, [r, n, n], dim=-1)
    delta = F.softplus((dt_r @ pf["w_dt"]).float() + p["b_dt"].float())
    da = torch.exp(delta[..., None] * a)                     # (T, B, di, N)
    db = (delta * xt.float())[..., None] * bm.float()[:, :, None, :]
    hs, h_final = decayed_cumsum(da, db, h0)
    y = torch.einsum("tbdn,tbn->tbd", hs, cm.float())
    y = y.transpose(0, 1).to(dt_)
    y = y + pf["d_skip"] * xm
    y = y * F.silu(z)
    out = y @ pf["w_out"]
    return out, {"h": h_final, "conv": new_tail}

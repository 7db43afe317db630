"""The dense gated MLP of the training path (from ``repro.models.mlp``).

The Mixture-of-Experts layer (``moe_defs`` / ``moe_fwd``: token dispatch
and combine over the indirect converters) is not ported yet: both raise,
naming ROADMAP A7.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..configs.base import ArchConfig
from .common import ACTIVATIONS, Param

__all__ = ["mlp_defs", "mlp_fwd", "moe_defs", "moe_fwd"]

_MOE = ("MoE training (dispatch/combine over the indirect converters) is "
        "not ported yet: ROADMAP A7")


def mlp_defs(cfg: ArchConfig, d_ff: Optional[int] = None) -> Dict[str, Param]:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    defs = {"w_up": Param((d, f)), "w_down": Param((f, d))}
    if cfg.glu:
        defs["w_gate"] = Param((d, f))
    return defs


def mlp_fwd(p, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    dt = cfg.compute_dtype
    act = ACTIVATIONS[cfg.activation]
    up = x @ p["w_up"].to(dt)
    h = act(up) * (x @ p["w_gate"].to(dt)) if cfg.glu else act(up)
    return h @ p["w_down"].to(dt)


def moe_defs(cfg: ArchConfig):
    raise NotImplementedError(_MOE)


def moe_fwd(p, x: torch.Tensor, cfg: ArchConfig):
    raise NotImplementedError(_MOE)

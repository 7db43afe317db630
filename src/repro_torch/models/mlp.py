"""Dense MLP and Mixture-of-Experts layers (from ``repro.models.mlp``).

The MoE layer is the reference's flagship packed-stream consumer: token
dispatch is an indirect write into expert-contiguous buffers and combine
is an indirect read back (``kernels.ops.moe_dispatch`` /
``moe_combine``, the indirect scatter and gather kernels on the card).
The expert FFN's three products stay ``torch.einsum`` (batched matrix
products), as the reference leaves them to XLA outside any kernel.  Every
weight is read through :func:`_w`, which also takes the w8a16 form of
``lm.quantize_mlp_weights`` (int8 codes and per-channel scales).

The reference's expert-parallel lowering (``_ep_moe_fwd``, a shard_map
over the mesh's experts axis) needs a device mesh, which the port does not
have yet: it raises, naming ROADMAP A9.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from ..configs.base import ArchConfig
from ..kernels import ops
from .common import ACTIVATIONS, Param

__all__ = ["MLP_WEIGHT_NAMES", "mlp_defs", "mlp_fwd", "moe_capacity",
           "moe_defs", "moe_fwd"]

#: The weight leaves that ``lm.quantize_mlp_weights`` turns into int8.
MLP_WEIGHT_NAMES = ("w_up", "w_gate", "w_down")


def mlp_defs(cfg: ArchConfig, d_ff: Optional[int] = None) -> Dict[str, Param]:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    defs = {"w_up": Param((d, f), ("fsdp_mlp", "d_ff")),
            "w_down": Param((f, d), ("d_ff", "fsdp_mlp"))}
    if cfg.glu:
        defs["w_gate"] = Param((d, f), ("fsdp_mlp", "d_ff"))
    return defs


def _w(leaf, dt: torch.dtype) -> torch.Tensor:
    """A weight in ``dt``: a plain tensor, or w8a16 ``{'q': int8,
    'scale': float32}`` dequantized as ``q * scale`` in ``dt``."""
    if isinstance(leaf, dict):
        return leaf["q"].to(dt) * leaf["scale"].to(dt)
    return leaf.to(dt)


def mlp_fwd(p, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    dt = cfg.compute_dtype
    act = ACTIVATIONS[cfg.activation]
    up = x @ _w(p["w_up"], dt)
    h = act(up) * (x @ _w(p["w_gate"], dt)) if cfg.glu else act(up)
    return h @ _w(p["w_down"], dt)


# ---------------------------------------------------------------------------
# Mixture of Experts
# ---------------------------------------------------------------------------


def moe_defs(cfg: ArchConfig) -> Dict[str, object]:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    defs: Dict[str, object] = {
        "router": Param((d, e), ("d_model", None), scale=0.02),
        "w_up": Param((e, d, f), ("experts", "fsdp_mlp", None)),
        "w_down": Param((e, f, d), ("experts", None, "fsdp_mlp")),
    }
    if cfg.glu:
        defs["w_gate"] = Param((e, d, f), ("experts", "fsdp_mlp", None))
    if cfg.dense_residual:
        defs["dense"] = mlp_defs(cfg)
    return defs


def moe_capacity(cfg: ArchConfig, n_tokens: int) -> int:
    """Slots per expert for ``n_tokens`` tokens: the capacity factor's
    share of the T·K assignments, rounded up to 8, at least 8."""
    cap = math.ceil(n_tokens * cfg.top_k * cfg.capacity_factor
                    / cfg.n_experts)
    return max(8, -(-cap // 8) * 8)


def _expert_ffn(p, buf: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    dt = cfg.compute_dtype
    act = ACTIVATIONS[cfg.activation]
    up = torch.einsum("ecd,edf->ecf", buf, _w(p["w_up"], dt))
    if cfg.glu:
        h = act(up) * torch.einsum("ecd,edf->ecf", buf, _w(p["w_gate"], dt))
    else:
        h = act(up)
    return torch.einsum("ecf,efd->ecd", h, _w(p["w_down"], dt))


def _top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``: the k largest along the last axis, and of equal
    values the lower index first (a stable descending sort; ties are
    common among 64 experts' probabilities of bf16 logits)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _router(p, flat: torch.Tensor, cfg: ArchConfig):
    """(gate (T, K) float32, expert index (T, K), Switch-style aux loss)."""
    logits = (flat @ p["router"].to(cfg.compute_dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    gate, idx = _top_k(probs, cfg.top_k)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    # E * sum_e fraction_e * mean_prob_e.
    frac = torch.nn.functional.one_hot(idx, cfg.n_experts).float().sum(1) \
        .mean(0) / cfg.top_k
    aux = cfg.n_experts * torch.sum(frac * probs.mean(0))
    return gate, idx, aux


def moe_fwd(p, x: torch.Tensor, cfg: ArchConfig, impl: str = "cuda"
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) → (output (B, S, D), aux load-balance loss).

    The reference's portable path: route, dispatch into (E, C, D) buffers
    with the capacity of the call's B·S tokens, the expert FFN, combine
    weighted by the kept gates.  ``impl`` goes to ``ops.moe_dispatch`` /
    ``moe_combine``: ``'cuda'`` the indirect converter kernels for tensors
    on the card (their plain versions on the CPU), ``'ref'`` the oracles.
    """
    b, s, d = x.shape
    t = b * s
    flat = x.reshape(t, d)
    gate, idx, aux = _router(p, flat, cfg)
    cap = moe_capacity(cfg, t)
    buf, src, keep = ops.moe_dispatch(flat, idx, cfg.n_experts, cap,
                                      impl=impl)
    out_buf = _expert_ffn(p, buf, cfg)
    out = ops.moe_combine(out_buf, src, gate * keep, t, impl=impl)
    out = out.reshape(b, s, d)
    if cfg.dense_residual:
        out = out + mlp_fwd(p["dense"], x, cfg)
    return out, aux


def _ep_moe_fwd(*args, **kwargs):
    """The reference's ``_ep_moe_fwd`` (expert parallelism over a mesh)."""
    raise NotImplementedError(
        "expert-parallel MoE (the reference's _ep_moe_fwd, a shard_map over "
        "the mesh's experts axis) needs a device mesh, which the port does "
        "not have yet (ROADMAP A9)")

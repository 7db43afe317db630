"""Optimizers: AdamW and Adafactor (from ``repro.optim.optimizers``).

The reference's functional interface, ``init(params) → state`` and
``update(grads, state, params, step) → (params, state, metrics)``, with
state trees that mirror the parameter tree, and the reference's exact
arithmetic (not ``torch.optim.AdamW``'s): gradients clipped by their
global norm, bias correction with ``t = step + 1``, decoupled weight decay
only on leaves with ``ndim > 1``, everything in float32 whatever the
storage dtype.  The update writes the new parameters and state into their
tensors in place under ``torch.no_grad()`` (the counterpart of the
reference's donated buffers) and returns the same trees.  The step's
scalars (learning rate, bias corrections) are 0-dim float32 tensors on the
host, which every device takes as scalars.  The reference's
``_chain`` / ``_dep_of`` are XLA scheduling no-ops and are left out.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import torch

from ..models.common import map_tree, tree_leaves

__all__ = [
    "Optimizer",
    "OptimizerConfig",
    "clip_by_global_norm",
    "cosine_schedule",
    "global_norm",
    "make_optimizer",
]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def clip_by_global_norm(tree, max_norm: float):
    """``(tree scaled to a global norm of at most max_norm, norm)``."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return map_tree(lambda g: g * scale, tree), norm


def cosine_schedule(base_lr: float, warmup: int, total: int) -> Callable:
    """Linear warmup to ``base_lr`` over ``warmup`` steps, then a cosine
    decay to 0 at ``total``; float32 0-dim tensors."""
    def lr(step) -> torch.Tensor:
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = base_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = base_lr * 0.5 * (1.0 + torch.cos(math.pi * prog))
        return torch.where(step < warmup, warm, cos)

    return lr


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"     # bfloat16 halves AdamW m/v bytes
    factored_threshold: int = 128     # adafactor: factor dims ≥ this


class Optimizer(NamedTuple):
    init: Callable
    update: Callable


def make_optimizer(cfg: OptimizerConfig) -> Optimizer:
    if cfg.name == "adamw":
        return _adamw(cfg)
    if cfg.name == "adafactor":
        return _adafactor(cfg)
    raise ValueError(f"unknown optimizer {cfg.name}")


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def _adamw(cfg: OptimizerConfig) -> Optimizer:
    mdt = _DTYPES[cfg.moment_dtype]
    lr_fn = cosine_schedule(cfg.lr, cfg.warmup_steps, cfg.total_steps)

    def init(params):
        zeros = lambda p: torch.zeros_like(p, dtype=mdt,  # noqa: E731
                                           requires_grad=False)
        return {"m": map_tree(zeros, params), "v": map_tree(zeros, params)}

    @torch.no_grad()
    def update(grads, state, params, step):
        grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
        t = torch.tensor(float(step), dtype=torch.float32) + 1.0
        lr = lr_fn(step)
        c1 = 1.0 - cfg.b1 ** t
        c2 = 1.0 - cfg.b2 ** t
        for g, m, v, p in zip(tree_leaves(grads), tree_leaves(state["m"]),
                              tree_leaves(state["v"]), tree_leaves(params)):
            g32 = g.float()
            m_new = cfg.b1 * m.float() + (1 - cfg.b1) * g32
            v_new = cfg.b2 * v.float() + (1 - cfg.b2) * g32 * g32
            step_ = (m_new / c1) / (torch.sqrt(v_new / c2) + cfg.eps)
            if p.ndim > 1:
                step_ = step_ + cfg.weight_decay * p.float()
            p.copy_(p.float() - lr * step_)
            m.copy_(m_new)
            v.copy_(v_new)
        return params, state, {"grad_norm": gnorm, "lr": lr}

    return Optimizer(init, update)


# ---------------------------------------------------------------------------
# Adafactor (factored second moments; bf16 first moment)
# ---------------------------------------------------------------------------


def _adafactor(cfg: OptimizerConfig) -> Optimizer:
    lr_fn = cosine_schedule(cfg.lr, cfg.warmup_steps, cfg.total_steps)

    def factored(p) -> bool:
        return (p.ndim >= 2 and p.shape[-1] >= cfg.factored_threshold
                and p.shape[-2] >= cfg.factored_threshold)

    def init(params):
        def st(p):
            z = dict(dtype=torch.float32, device=p.device)
            if factored(p):
                return {
                    "vr": torch.zeros(p.shape[:-1], **z),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **z),
                    "m": torch.zeros(p.shape, dtype=torch.bfloat16,
                                     device=p.device),
                }
            return {"v": torch.zeros(p.shape, **z),
                    "m": torch.zeros(p.shape, dtype=torch.bfloat16,
                                     device=p.device)}

        return map_tree(st, params)

    @torch.no_grad()
    def update(grads, state, params, step):
        grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
        lr = lr_fn(step)
        b2 = 1.0 - (torch.tensor(float(step), dtype=torch.float32)
                    + 1.0) ** -0.8
        for g, s, p in zip(tree_leaves(grads), _leaf_states(params, state),
                           tree_leaves(params)):
            g32 = g.float()
            g2 = g32 * g32 + 1e-30
            if factored(p):
                vr = b2 * s["vr"] + (1 - b2) * torch.mean(g2, dim=-1)
                vc = b2 * s["vc"] + (1 - b2) * torch.mean(g2, dim=-2)
                # (DTensors: both factors laid out as g, so the outer
                # product is formed on each rank's block of g)
                vr_g, vc_g = _as_factor(vr, g32, -1), _as_factor(vc, g32, -2)
                denom = (vr_g[..., None] * vc_g[..., None, :]
                         / torch.clamp(torch.mean(vr_g, dim=-1, keepdim=True)
                                       [..., None], min=1e-30))
                pre = g32 * torch.rsqrt(denom + 1e-30)
                s["vr"].copy_(vr)
                s["vc"].copy_(vc)
            else:
                v = b2 * s["v"] + (1 - b2) * g2
                pre = g32 * torch.rsqrt(v + 1e-30)
                s["v"].copy_(v)
            # update clipping (RMS <= 1), as Adafactor does
            rms = torch.sqrt(torch.mean(pre * pre) + 1e-30)
            pre = pre / torch.clamp(rms, min=1.0)
            m = cfg.b1 * s["m"].float() + (1 - cfg.b1) * pre
            upd = m + cfg.weight_decay * p.float() if p.ndim > 1 else m
            p.copy_(p.float() - lr * upd)
            s["m"].copy_(m)
        return params, state, {"grad_norm": gnorm, "lr": lr}

    return Optimizer(init, update)


def _as_factor(v, g, dim: int):
    """A factored second moment ``v`` (``g`` with ``dim`` reduced) laid
    out as ``g`` lays out its other dims, whole along the rest: a DTensor
    ``g`` sharded along ``dim`` leaves ``v`` replicated on that mesh axis.
    A plain tensor as it is."""
    from ..parallel.sharding import is_dtensor

    if not is_dtensor(v):
        return v
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.placement_types import _StridedShard

    cut = g.ndim + dim
    want = []
    for pl in g.placements:
        d = getattr(pl, "dim", None)
        if d is None or d == cut or not isinstance(pl, (Shard,
                                                         _StridedShard)):
            want.append(Replicate())
        elif isinstance(pl, _StridedShard):
            want.append(_StridedShard(d - (d > cut),
                                      split_factor=pl.split_factor))
        else:
            want.append(Shard(d - (d > cut)))
    want = tuple(want)
    return v if tuple(v.placements) == want else v.redistribute(
        v.device_mesh, want)


def _leaf_states(params, state) -> list:
    """Adafactor's state dict of each parameter leaf, in leaf order (the
    state tree is the parameter tree with a dict at every leaf)."""
    if isinstance(params, dict):
        return [s for k in sorted(params)
                for s in _leaf_states(params[k], state[k])]
    return [state]

"""Dense MLP and Mixture-of-Experts layers (from ``repro.models.mlp``).

The MoE layer is the reference's flagship packed-stream consumer: token
dispatch is an indirect write into expert-contiguous buffers and combine
is an indirect read back (``kernels.ops.moe_dispatch`` /
``moe_combine``, the indirect scatter and gather kernels on the card).
The expert FFN's three products stay ``torch.einsum`` (batched matrix
products), as the reference leaves them to XLA outside any kernel.  Every
weight is read through :func:`_w`, which also takes the w8a16 form of
``lm.quantize_mlp_weights`` (int8 codes and per-channel scales).

With sharding rules on a bound mesh whose experts axis has more than one
device, :func:`moe_fwd` takes the reference's expert-parallel lowering
(:func:`_ep_moe_fwd`, a ``shard_map`` over the experts axis there): every
rank routes all tokens, packs those assigned to its own E/n experts
(the rest go to an overflow expert that is dropped), runs its experts'
FFN, combines its partial output, and one sum over the experts axis
adds the partials.  The dispatch and combine take ``impl`` as the
portable path does, so on the card they are the converter kernels.
:func:`_ep_shard` is one shard's share, which a single card can also
compute for every shard in turn.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from ..configs.base import ArchConfig
from ..kernels import ops
from ..parallel import collectives
from ..parallel.sharding import constrain, is_dtensor
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


OUT_DIMS = ("act_batch", "seq", "d_model")


def mlp_fwd(p, x: torch.Tensor, cfg: ArchConfig, rules=None) -> torch.Tensor:
    dt = cfg.compute_dtype
    act = ACTIVATIONS[cfg.activation]
    up = constrain(x @ _w(p["w_up"], dt), rules, ("act_batch", "seq", "d_ff"))
    h = act(up) * (x @ _w(p["w_gate"], dt)) if cfg.glu else act(up)
    return constrain(h @ _w(p["w_down"], dt), rules, OUT_DIMS)


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


def _router(p, flat: torch.Tensor, cfg: ArchConfig, group=None,
            n_shards: int = 1):
    """(gate (T, K) float32, expert index (T, K), Switch-style aux loss).
    ``group``: ``flat`` is one of ``n_shards`` equal blocks of the tokens,
    whose means are summed over the group, so ``aux`` is the whole
    batch's."""
    logits = (flat @ p["router"].to(cfg.compute_dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    gate, idx = _top_k(probs, cfg.top_k)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    # E * sum_e fraction_e * mean_prob_e.
    frac = torch.nn.functional.one_hot(idx, cfg.n_experts).float().sum(1) \
        .mean(0) / cfg.top_k
    mean_probs = probs.mean(0)
    if group is not None:
        frac = collectives.sum_forward(frac, group) / n_shards
        mean_probs = collectives.sum_forward(mean_probs, group) / n_shards
    aux = cfg.n_experts * torch.sum(frac * mean_probs)
    return gate, idx, aux


def moe_fwd(p, x: torch.Tensor, cfg: ArchConfig, impl: str = "cuda",
            rules=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) → (output (B, S, D), aux load-balance loss).

    The reference's portable path: route, dispatch into (E, C, D) buffers
    with the capacity of the call's B·S tokens, the expert FFN, combine
    weighted by the kept gates.  ``impl`` goes to ``ops.moe_dispatch`` /
    ``moe_combine``: ``'cuda'`` the indirect converter kernels for tensors
    on the card (their plain versions on the CPU), ``'ref'`` the oracles.
    ``rules`` on a bound mesh with more than one device along the experts
    axis takes the expert-parallel path (:func:`_ep_moe_fwd`); ``None``,
    an abstract mesh (the dry run's global count), or one device there,
    is the portable path.
    """
    b, s, d = x.shape
    t = b * s
    flat = x.reshape(t, d)
    ep = rules.axis("experts") if rules is not None else None
    n_ep = rules.axis_size("experts") if rules is not None else 1
    if rules is not None and rules.bound and isinstance(ep, str) \
            and n_ep > 1:
        out, aux = _ep_moe_fwd(p, flat, cfg, rules, ep, n_ep, impl)
        out = out.reshape(b, s, d)
    else:
        gate, idx, aux = _router(p, flat, cfg)
        cap = moe_capacity(cfg, t)
        buf, src, keep = ops.moe_dispatch(flat, idx, cfg.n_experts, cap,
                                          impl=impl)
        buf = constrain(buf, rules, ("experts", "capacity", None))
        out_buf = constrain(_expert_ffn(p, buf, cfg), rules,
                            ("experts", "capacity", None))
        out = ops.moe_combine(out_buf, src, gate * keep, t, impl=impl)
        out = out.reshape(b, s, d)
    if cfg.dense_residual:
        out = out + mlp_fwd(p["dense"], x, cfg, rules)
    return constrain(out, rules, OUT_DIMS), aux


def _expert_block(leaf, m: int, e_loc: int):
    """Shard ``m``'s experts of an expert weight: rows ``[m·e_loc,
    (m+1)·e_loc)`` of a whole tensor, or of each part of a w8a16 dict."""
    if isinstance(leaf, dict):
        return {k: _expert_block(v, m, e_loc) for k, v in leaf.items()}
    return leaf[m * e_loc:(m + 1) * e_loc]


def _ep_shard(p, tokens: torch.Tensor, gate: torch.Tensor,
              idx: torch.Tensor, cfg: ArchConfig, m: int, n_ep: int,
              cap: int, impl: str = "cuda", w=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shard ``m`` of ``n_ep``'s share of the MoE output: the assignments
    to its ``E / n_ep`` experts packed with capacity ``cap`` (the others
    to the overflow expert ``e_loc``, which is dropped), its experts' FFN,
    and the combine weighted by the kept local gates.  The experts'
    weights are rows of ``p``'s whole expert weights, or ``w`` where the
    caller holds the block alone.  Returns (partial output (T, D) in the
    compute dtype, kept (T, K): the assignments this shard kept)."""
    e_loc = cfg.n_experts // n_ep
    local_idx = idx - m * e_loc
    ok = (local_idx >= 0) & (local_idx < e_loc)
    masked = torch.where(ok, local_idx, torch.full_like(local_idx, e_loc))
    buf, src, keep = ops.moe_dispatch(tokens, masked, e_loc + 1, cap,
                                      impl=impl)
    if w is None:
        w = {name: _expert_block(p[name], m, e_loc)
             for name in MLP_WEIGHT_NAMES if name in p}
    out_buf = _expert_ffn(w, buf[:e_loc], cfg)
    out_buf = torch.cat([out_buf, out_buf.new_zeros((1,)
                                                    + out_buf.shape[1:])])
    kept = keep & ok
    partial = ops.moe_combine(out_buf, src, (gate * kept).float(),
                              tokens.shape[0], impl=impl)
    return partial, kept


def _ep_moe_fwd(p, flat: torch.Tensor, cfg: ArchConfig, rules, ep: str,
                n_ep: int, impl: str = "cuda"
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE over the mesh axis ``ep`` (the reference's
    ``shard_map`` manual over it): flat (T, D) → (output (T, D), aux).

    Plain tokens: every rank holds the tokens whole, as the reference's
    shard_map sees them, and the parameters whole, as plain tensors (its
    experts are rows of the expert weights), and routes the tokens all
    (the same on every rank, so ``aux`` is local); its shard
    (:func:`_ep_shard`) packs, runs and combines its own experts'
    assignments, with the capacity of the tokens of one batch shard, as
    the reference computes it.  One sum over ``ep`` adds the partial
    outputs.  The gradients of the tokens and gates that the shard used
    are summed over ``ep`` in the backward, where the reference sums the
    cotangents of its replicated inputs.  The sums run in float32 off the
    card and in the compute dtype on it, as the reference's ``psum_dt``.

    DTensor tokens (sharded over the batch axes) stay on their rank, as
    XLA partitions the reference's shard_map over its automatic data
    axis: each rank routes, packs (with that capacity), runs and combines
    its own block of the tokens, the router's means are summed over the
    batch axes for ``aux``, and the output keeps the tokens' layout.  The
    weights' gradients are then partial sums over the batch axes.
    """
    dt = cfg.compute_dtype
    group = collectives.axis_group(rules.mesh, ep)
    m = collectives.axis_index(rules.mesh, ep)
    n_batch = max(1, rules.axis_size("batch"))
    t_shard = max(1, flat.shape[0] // n_batch)
    cap = moe_capacity(cfg, t_shard)
    dtensor_tokens = is_dtensor(flat)
    batch_ax = rules.axis("batch") if n_batch > 1 else None
    p, w = _ep_params(p, rules, ep, batch_ax if dtensor_tokens else None)
    b_group = None
    if dtensor_tokens:
        from torch.distributed.tensor import DTensor

        from ..parallel.sharding import placements

        spec = placements((batch_ax, None), rules.mesh)
        if tuple(flat.placements) != spec:
            flat = flat.redistribute(rules.mesh.device_mesh, spec)
        flat = flat.to_local()
        if batch_ax is not None:
            b_group = collectives.axis_group(rules.mesh, batch_ax)
    psum_dt = torch.float32 if flat.device.type != "cuda" else dt
    tokens = flat.to(dt)
    gate, idx, aux = _router(p, tokens, cfg, b_group, n_batch)
    shard_tokens = collectives.sum_backward(tokens.to(psum_dt), group).to(dt)
    shard_gate = collectives.sum_backward(gate, group)
    partial, _ = _ep_shard(p, shard_tokens, shard_gate, idx, cfg, m, n_ep,
                           cap, impl, w=w)
    out = collectives.sum_forward(partial.to(psum_dt), group).to(dt)
    if dtensor_tokens:
        dm = rules.mesh.device_mesh
        out = DTensor.from_local(out, dm, spec, run_check=False)
        aux = DTensor.from_local(aux, dm, placements((), rules.mesh),
                                 run_check=False)
    return out, aux


def _ep_params(p, rules, ep: str, partial=None):
    """``(p, w)``: the MoE parameters as the expert-parallel shard reads
    them.  Plain tensors pass whole (``w`` None: the shard cuts its
    experts' rows).  DTensor parameters (``param_shardings``) come as
    local tensors: each expert weight laid out with its experts on ``ep``
    and every other dim whole (under fsdp d_model is gathered), its block
    in ``w``; the router replicated.  ``partial`` (mesh axes): each rank
    saw its own block of the tokens there, so the gradients are partial
    sums over those axes."""
    if not any(is_dtensor(v) for v in _leaves(p)):
        return p, None
    from torch.distributed.tensor import Partial, Replicate, Shard

    dm = rules.mesh.device_mesh
    names = rules.mesh.axis_names
    part = (partial,) if isinstance(partial, str) else tuple(partial or ())

    def layout(first):
        spec = tuple(first if a == ep else Replicate() for a in names)
        grad = tuple(Partial() if a in part else pl
                     for a, pl in zip(names, spec))
        return spec, (grad if part else None)

    def local(leaf, spec, grad):
        if isinstance(leaf, dict):
            return {k: local(v, spec, grad) for k, v in leaf.items()}
        if not is_dtensor(leaf):
            return leaf
        if tuple(leaf.placements) != spec:
            leaf = leaf.redistribute(dm, spec)
        return leaf.to_local(grad_placements=grad)

    w = {name: local(p[name], *layout(Shard(0)))
         for name in MLP_WEIGHT_NAMES if name in p}
    return {**p, "router": local(p["router"], *layout(Replicate()))}, w


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]

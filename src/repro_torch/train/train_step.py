"""Train-step factory with microbatch accumulation (from
``repro.train.train_step``).

``make_train_step`` returns ``(params, opt_state, batch, step) → (params,
opt_state, metrics)``: the loss and its gradients (``torch.autograd.grad``
over the parameter leaves), accumulated over ``grad_accum`` microbatches
in float32 by a Python loop where the reference scans, then the
optimizer's in-place update.

``make_compressed_train_step`` is the reference's manual data-parallel
step: each rank of the data-parallel group takes its block of the batch,
and the gradients cross the group as int8 with error feedback
(``optim.compression``), over the process group of the mesh's
data-parallel axes.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from ..configs.base import ArchConfig
from ..models import lm
from ..models.common import map_tree, tree_leaves, tree_unflatten
from ..optim import compression
from ..optim.optimizers import Optimizer
from ..parallel import collectives
from ..parallel.sharding import is_dtensor, reduce_partials

__all__ = ["grads_with_accum", "make_compressed_train_step", "make_loss_fn",
           "make_train_step"]


def _split_microbatches(batch: Dict[str, torch.Tensor], n: int):
    """Every leaf (B, ...) reshaped to (n, B/n, ...): microbatch i holds
    the rows [i·B/n, (i+1)·B/n), as the reference's reshape.  A DTensor
    leaf sharded over the batch is gathered over its batch axes, split,
    and each rank keeps its block of every microbatch's rows."""
    def sp(x):
        b = x.shape[0]
        if b % n:
            raise ValueError(f"batch {b} does not split into {n} "
                             f"microbatches")
        if is_dtensor(x):
            return _split_local(x, n)
        return x.reshape(n, b // n, *x.shape[1:])

    return map_tree(sp, batch)


def _split_local(x, n: int):
    from torch.distributed.tensor import DTensor, Replicate, Shard

    def moved(p):  # a dim's placement one dim further on
        return Shard(p.dim + 1) if isinstance(p, Shard) else p

    whole = [Replicate() if isinstance(p, Shard) and p.dim == 0 else moved(p)
             for p in x.placements]
    want = [Shard(1) if isinstance(p, Shard) and p.dim == 0 else moved(p)
            for p in x.placements]
    rows = x.redistribute(x.device_mesh, [
        Replicate() if isinstance(p, Shard) and p.dim == 0 else p
        for p in x.placements]).to_local()
    split = rows.reshape(n, rows.shape[0] // n, *rows.shape[1:])
    return DTensor.from_local(split, x.device_mesh, whole,
                              run_check=False).redistribute(
        x.device_mesh, want)


def make_loss_fn(cfg: ArchConfig, impl: str = "cuda", rules=None
                 ) -> Callable:
    def loss_fn(params, batch):
        return lm.train_loss(params, batch, cfg, impl=impl, rules=rules)

    return loss_fn


def grads_with_accum(loss_fn, params, batch, grad_accum: int):
    """Returns (mean loss, metrics, grads); the gradient tree mirrors
    ``params``.  Leaves that do not require grad are switched to."""
    leaves = tree_leaves(params)
    for p in leaves:
        if not p.requires_grad:
            p.requires_grad_(True)
    if grad_accum == 1:
        loss, metrics = loss_fn(params, batch)
        grads = [_like(g, p) for g, p in
                 zip(torch.autograd.grad(loss, leaves), leaves)]
        return (loss.detach(), map_tree(torch.Tensor.detach, metrics),
                tree_unflatten(params, grads))

    micro = _split_microbatches(batch, grad_accum)
    acc = [torch.zeros_like(p, dtype=torch.float32) if is_dtensor(p)
           else torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for p in leaves]
    loss_sum = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for i in range(grad_accum):
        loss, _ = loss_fn(params, map_tree(lambda x: x[i], micro))
        for a, g, p in zip(acc, torch.autograd.grad(loss, leaves), leaves):
            a.add_(_like(g, p))
        loss_sum = loss_sum + loss.detach()
    for a in acc:
        a.div_(grad_accum)
    loss = loss_sum / grad_accum
    return loss, {"ce_loss": loss}, tree_unflatten(params, acc)


def _like(g, p):
    """A DTensor gradient laid out as its parameter (the sums over the
    batch axes that its partial values need, one all-reduce over all of
    them, or a reduce-scatter where the parameter is sharded); a plain
    tensor as it is."""
    if is_dtensor(g) and tuple(g.placements) != tuple(p.placements):
        g = reduce_partials(g)
        if tuple(g.placements) != tuple(p.placements):
            g = g.redistribute(p.device_mesh, p.placements)
    return g


def make_train_step(cfg: ArchConfig, opt: Optimizer, grad_accum: int = 1,
                    impl: str = "cuda", rules=None) -> Callable:
    """(params, opt_state, batch, step) → (params, opt_state, metrics); the
    parameters and optimizer state are updated in place.  ``rules`` go to
    the loss (``lm.train_loss``): on a bound mesh with DTensor arguments
    the step runs sharded by them."""
    loss_fn = make_loss_fn(cfg, impl, rules)

    def train_step(params, opt_state, batch, step):
        loss, metrics, grads = grads_with_accum(loss_fn, params, batch,
                                                grad_accum)
        new_params, new_opt, opt_metrics = opt.update(grads, opt_state,
                                                      params, step)
        return new_params, new_opt, {"loss": loss, **metrics, **opt_metrics}

    return train_step


def make_compressed_train_step(cfg: ArchConfig, opt: Optimizer, mesh,
                               dp_axes: Tuple[str, ...] = ("data",),
                               grad_accum: int = 1) -> Callable:
    """The data-parallel step with the int8 error-feedback all-reduce:
    ``(params, opt_state, batch, step, err_fb) → (params, opt_state,
    err_fb, metrics)`` over the process group of ``dp_axes`` of the bound
    ``mesh``.

    The parameters are replicated over the group (``cfg.fsdp`` raises, as
    the reference asserts).  Every rank is given the same global batch
    and takes its block by its index along ``dp_axes``; the loss is
    averaged over the group, the gradients summed by
    ``compression.compressed_grad_psum`` and divided by the group's size,
    then the optimizer updates in place.  ``err_fb`` is this rank's
    ``(1, N)`` float32 residual, from ``step.init_err_fb(params)``.
    """
    if cfg.fsdp:
        raise ValueError("the compressed data-parallel step needs "
                         "replicated params (cfg.fsdp=False)")
    loss_fn = make_loss_fn(cfg)
    group = collectives.axis_group(mesh, dp_axes)
    n_dp = collectives.axis_size(mesh, dp_axes)
    me = collectives.axis_index(mesh, dp_axes)

    def train_step(params, opt_state, batch, step, err_fb):
        def local(x):
            b = x.shape[0] // n_dp
            return x[me * b:(me + 1) * b]

        loss, metrics, grads = grads_with_accum(
            loss_fn, params, map_tree(local, batch), grad_accum)
        loss = collectives.psum(loss, group) / n_dp
        grads, new_err = compression.compressed_grad_psum(grads, group,
                                                          err_fb[0])
        grads = map_tree(lambda g: g.div_(n_dp), grads)
        new_params, new_opt, opt_metrics = opt.update(grads, opt_state,
                                                      params, step)
        return new_params, new_opt, new_err[None], {"loss": loss,
                                                    **opt_metrics}

    def init_err_fb(params):
        leaf = tree_leaves(params)[0]
        return torch.zeros((1, compression.tree_size(params)),
                           dtype=torch.float32, device=leaf.device)

    train_step.init_err_fb = init_err_fb
    return train_step

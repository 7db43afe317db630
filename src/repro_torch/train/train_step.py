"""Train-step factory with microbatch accumulation (from
``repro.train.train_step``).

``make_train_step`` returns ``(params, opt_state, batch, step) → (params,
opt_state, metrics)``: the loss and its gradients (``torch.autograd.grad``
over the parameter leaves), accumulated over ``grad_accum`` microbatches
in float32 by a Python loop where the reference scans, then the
optimizer's in-place update.  The int8-compressed data-parallel step
(``make_compressed_train_step``) needs a mesh and raises, naming ROADMAP
A9.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from ..configs.base import ArchConfig
from ..models import lm
from ..models.common import map_tree, tree_leaves, tree_unflatten
from ..optim.optimizers import Optimizer

__all__ = ["grads_with_accum", "make_compressed_train_step", "make_loss_fn",
           "make_train_step"]


def _split_microbatches(batch: Dict[str, torch.Tensor], n: int):
    """Every leaf (B, ...) reshaped to (n, B/n, ...)."""
    def sp(x):
        b = x.shape[0]
        if b % n:
            raise ValueError(f"batch {b} does not split into {n} "
                             f"microbatches")
        return x.reshape(n, b // n, *x.shape[1:])

    return map_tree(sp, batch)


def make_loss_fn(cfg: ArchConfig, impl: str = "cuda") -> Callable:
    def loss_fn(params, batch):
        return lm.train_loss(params, batch, cfg, impl=impl)

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
        grads = torch.autograd.grad(loss, leaves)
        return (loss.detach(), map_tree(torch.Tensor.detach, metrics),
                tree_unflatten(params, grads))

    micro = _split_microbatches(batch, grad_accum)
    acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for p in leaves]
    loss_sum = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for i in range(grad_accum):
        loss, _ = loss_fn(params, map_tree(lambda x: x[i], micro))
        for a, g in zip(acc, torch.autograd.grad(loss, leaves)):
            a.add_(g)
        loss_sum = loss_sum + loss.detach()
    for a in acc:
        a.div_(grad_accum)
    loss = loss_sum / grad_accum
    return loss, {"ce_loss": loss}, tree_unflatten(params, acc)


def make_train_step(cfg: ArchConfig, opt: Optimizer, grad_accum: int = 1,
                    impl: str = "cuda") -> Callable:
    """(params, opt_state, batch, step) → (params, opt_state, metrics); the
    parameters and optimizer state are updated in place."""
    loss_fn = make_loss_fn(cfg, impl)

    def train_step(params, opt_state, batch, step):
        loss, metrics, grads = grads_with_accum(loss_fn, params, batch,
                                                grad_accum)
        new_params, new_opt, opt_metrics = opt.update(grads, opt_state,
                                                      params, step)
        return new_params, new_opt, {"loss": loss, **metrics, **opt_metrics}

    return train_step


def make_compressed_train_step(*args, **kwargs):
    raise NotImplementedError(
        "the int8 error-feedback data-parallel step needs a device mesh, "
        "which the port does not have yet (ROADMAP A9)")

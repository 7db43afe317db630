"""Shared model pieces of the port (from ``repro.models.common``).

Only what the recurrent blocks use: parameter declarations and their
initialization, :func:`rms_norm` and :func:`decayed_cumsum`.  The
reference's logical dimension names exist for sharding, which the port
leaves out, so a :class:`Param` here is a shape, an initializer and a
scale.  Parameter trees are nested ``dict``s of tensors.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

__all__ = [
    "Param",
    "cast_tree",
    "decayed_cumsum",
    "init_params",
    "map_tree",
    "rms_norm",
    "stack_layer_defs",
]

Tree = Any


@dataclasses.dataclass(frozen=True)
class Param:
    """A parameter declaration: shape and initializer."""

    shape: Tuple[int, ...]
    init: str = "normal"           # normal | zeros | ones | embed
    scale: Optional[float] = None  # stddev override (default: fan-in)

    def std(self) -> float:
        """The reference's stddev for a ``normal``/``embed`` leaf, computed
        from the declared (stacked) shape as ``repro.models.common
        .init_params`` does."""
        if self.scale is not None:
            return self.scale
        if self.init == "embed":
            return 1.0 / math.sqrt(self.shape[-1])
        fan_in = (self.shape[0] if len(self.shape) == 1
                  else math.prod(self.shape[:-1]))
        return 1.0 / math.sqrt(max(fan_in, 1))


def map_tree(fn: Callable[[Any], Any], tree: Tree) -> Tree:
    """Apply ``fn`` to every leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def stack_layer_defs(defs: Tree, n_layers: int) -> Tree:
    """Prepend a layers dimension to every :class:`Param`."""
    return map_tree(
        lambda p: Param((n_layers,) + p.shape, p.init, p.scale), defs)


def init_params(defs: Tree, generator: torch.Generator,
                device: torch.device) -> Tree:
    """Materialize a Param tree as float32 tensors: zeros, ones, or normal
    draws from ``generator`` with the reference's scales.  Leaves are drawn
    in sorted key order, so a seed gives the same tree every time (not the
    reference's numbers: JAX and torch generators differ)."""
    def draw(p: Param) -> torch.Tensor:
        if p.init == "zeros":
            return torch.zeros(p.shape, device=device)
        if p.init == "ones":
            return torch.ones(p.shape, device=device)
        return torch.randn(p.shape, generator=generator,
                           device=device) * p.std()

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(tree[k]) for k in sorted(tree)}
        return draw(tree)

    return walk(defs)


def cast_tree(tree: Tree, dtype: torch.dtype) -> Tree:
    """Every leaf in ``dtype``; a leaf already in it is the same tensor."""
    return map_tree(lambda t: t.to(dtype), tree)


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x²) + eps) * (1 + gamma)`` in ``x``'s dtype, with the
    squares summed in float32, as the reference."""
    var = (torch.sum(x * x, dim=-1, keepdim=True, dtype=torch.float32)
           / x.shape[-1])
    scale = torch.rsqrt(var + eps).to(x.dtype)
    return x * scale * (1.0 + gamma.to(x.dtype))


def decayed_cumsum(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The decayed linear recurrence ``h_t = a_t * h_{t-1} + b_t``.

    a, b (T, ...); h0 (...).  Returns (h at every step (T, ...), final h).
    The reference evaluates it as an associative scan over chunks; a
    sequential loop gives the same values up to float rounding, and for
    T = 1 (every serving step) the same operations: ``a * h0 + b``.
    """
    h = h0
    hs = []
    for t in range(a.shape[0]):
        h = a[t] * h + b[t]
        hs.append(h)
    return torch.stack(hs), h

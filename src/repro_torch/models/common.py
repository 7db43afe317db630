"""Shared model pieces of the port (from ``repro.models.common``).

Parameter declarations and their initialization, :func:`rms_norm`,
``ACTIVATIONS``, RoPE (:func:`rope_freqs`, :func:`apply_rope`), the
decayed recurrence of the recurrent blocks (:func:`decayed_cumsum`, one
step at a time, and :func:`decayed_scan`, a chunk at once in log-depth)
and the training loss's :func:`chunked_softmax_xent`.  A :class:`Param`
is the reference's declaration: a shape, the logical name of each
dimension (which :mod:`repro_torch.parallel.sharding` maps to mesh
axes), an initializer and a scale.  Parameter trees are nested ``dict``s
of tensors.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

__all__ = [
    "ACTIVATIONS",
    "Param",
    "apply_rope",
    "cast_tree",
    "chunked_softmax_xent",
    "decayed_cumsum",
    "decayed_scan",
    "init_params",
    "map_tree",
    "rms_norm",
    "rope_freqs",
    "stack_layer_defs",
    "tree_leaves",
    "tree_paths",
    "tree_unflatten",
]

Tree = Any


@dataclasses.dataclass(frozen=True)
class Param:
    """A parameter declaration: shape, logical dim names, initializer."""

    shape: Tuple[int, ...]
    dims: Tuple[Optional[str], ...]
    init: str = "normal"           # normal | zeros | ones | embed
    scale: Optional[float] = None  # stddev override (default: fan-in)

    def __post_init__(self):
        if len(self.shape) != len(self.dims):
            raise ValueError(f"shape {self.shape} and dims {self.dims} "
                             f"differ in length")

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


def tree_paths(tree: Tree, prefix: str = ""):
    """``[(path, leaf)]`` of a nested dict in sorted key order, the order
    in which ``jax.tree_util`` flattens a dict; paths in its ``keystr``
    form (``['layers']['attn']['wq']``), so leaf i is the same leaf in
    both packages."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in tree_paths(tree[k], f"{prefix}['{k}']")]
    return [(prefix, tree)]


def tree_leaves(tree: Tree) -> list:
    """The leaves of a nested dict in sorted key order."""
    return [leaf for _, leaf in tree_paths(tree)]


def tree_unflatten(like: Tree, leaves) -> Tree:
    """A tree shaped like ``like`` holding ``leaves`` (in sorted key
    order)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)

    return build(like)


def stack_layer_defs(defs: Tree, n_layers: int) -> Tree:
    """Prepend a ``'layers'`` dimension to every :class:`Param`."""
    return map_tree(
        lambda p: Param((n_layers,) + p.shape, ("layers",) + p.dims, p.init,
                        p.scale), defs)


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


ACTIVATIONS = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
    "relu2": lambda x: torch.square(F.relu(x)),
}


def rope_freqs(head_dim: int, theta: float,
               device: Optional[torch.device] = None) -> torch.Tensor:
    """float32 inverse frequencies ``theta ** -(2i / head_dim)``."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x (..., S, H, hd); positions (..., S) or (S,).  float32 angles, the
    two halves rotated (the reference's split-halves layout), cast back to
    x's dtype."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    ang = positions[..., None].float() * freqs            # (..., S, hd/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


LOGIT_DIMS = ("act_batch", None, "vocab")


def _xent_chunk(xc, w_out, lc, mc, n_valid: Optional[int], rules=None):
    """Summed masked NLL and summed mask of one (B, chunk) slice."""
    from ..parallel.sharding import constrain, is_dtensor

    logits = constrain((xc @ w_out).float(), rules, LOGIT_DIMS)
    if is_dtensor(logits) and logits.device_mesh.size() > 1:
        return _xent_local(logits, lc, mc, n_valid, rules)
    logits = _mask_padded(logits, n_valid, logits.shape[-1])
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, lc[..., None].long())[..., 0]
    mc = mc.float()
    return ((lse - gold) * mc).sum(), mc.sum()


def _mask_padded(logits, n_valid: Optional[int], vocab: int, lo: int = 0):
    """``logits`` (..., V_block), the block of a ``vocab``-wide row that
    starts at class ``lo``, with the padded classes (``n_valid`` and up)
    at -1e30."""
    if n_valid is None or n_valid >= vocab:
        return logits
    ids = lo + torch.arange(logits.shape[-1], device=logits.device)
    return logits.masked_fill(ids >= n_valid, -1e30)


def _xent_local(logits, lc, mc, n_valid: Optional[int], rules):
    """:func:`_xent_chunk`'s sums on vocab-sharded DTensor logits (B, C,
    V): each rank reduces its block of the vocab, and sums over the vocab
    axis give the row maxima, the softmax denominators and the gold
    logits, as XLA partitions the reference's reductions; sums over the
    batch axes give the two totals, replicated."""
    import torch.distributed as dist

    from ..parallel import collectives
    from ..parallel.sharding import local_call, mesh_axis_size

    mesh = rules.mesh
    vocab_ax, batch_ax = rules.axis("vocab"), rules.axis("act_batch")
    n_v = mesh_axis_size(mesh, vocab_ax)
    v_group = collectives.axis_group(mesh, vocab_ax) if n_v > 1 else None
    b_group = (collectives.axis_group(mesh, batch_ax)
               if mesh_axis_size(mesh, batch_ax) > 1 else None)
    v_lo = (collectives.axis_index(mesh, vocab_ax) * (logits.shape[-1] // n_v)
            if n_v > 1 else 0)

    def vsum(t):
        return collectives.sum_forward(t, v_group) if v_group else t

    def fn(lg, lab, msk):
        lg = _mask_padded(lg, n_valid, logits.shape[-1], v_lo)
        m = lg.detach().amax(dim=-1, keepdim=True)
        if v_group is not None:
            dist.all_reduce(m, op=dist.ReduceOp.MAX, group=v_group)
        lse = m[..., 0] + torch.log(vsum(torch.exp(lg - m).sum(-1)))
        loc = lab.long() - v_lo
        ok = (loc >= 0) & (loc < lg.shape[-1])
        gold = lg.gather(-1, loc.clamp(0, lg.shape[-1] - 1)[..., None])
        gold = vsum(torch.where(ok, gold[..., 0], torch.zeros_like(lse)))
        msk = msk.float()
        out = torch.stack([((lse - gold) * msk).sum(), msk.sum()])
        return collectives.sum_forward(out, b_group) if b_group else out

    bspec = (batch_ax, None)
    out = local_call(fn, mesh, (logits, lc, mc),
                     (rules.spec(LOGIT_DIMS), bspec, bspec),
                     (None,) * len(mesh.axis_names))
    return out[0], out[1]


def chunked_softmax_xent(x: torch.Tensor, w_out: torch.Tensor,
                         labels: torch.Tensor,
                         mask: Optional[torch.Tensor] = None,
                         seq_chunk: int = 512,
                         n_valid: Optional[int] = None, rules=None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean CE of ``softmax(x @ w_out)`` against labels over seq chunks.

    x (B, S, D); w_out (D, V); labels (B, S).  Logits are float32 and only
    one (B, chunk, V) block of them lives at a time: under autograd each
    chunk runs inside :func:`torch.utils.checkpoint.checkpoint`, so its
    logits are recomputed in the backward instead of kept.  ``n_valid``:
    the real vocab when V is padded (padded classes masked).  Returns
    ``(loss, total weight)``.  ``rules`` lays the logits out as
    ``(act_batch, None, vocab)`` (the reference's ``logit_spec``); on
    DTensors over more than one rank each rank reduces its block
    (:func:`_xent_local`).
    """
    b, s, _ = x.shape
    seq_chunk = min(seq_chunk, s)
    if s % seq_chunk:
        raise ValueError(f"sequence {s} is not a multiple of the chunk "
                         f"{seq_chunk}")
    if mask is None:
        mask = torch.ones((b, s), dtype=x.dtype, device=x.device)
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, s, seq_chunk):
        part = (x[:, i:i + seq_chunk], w_out, labels[:, i:i + seq_chunk],
                mask[:, i:i + seq_chunk], n_valid, rules)
        if torch.is_grad_enabled():
            nll, m = checkpoint(_xent_chunk, *part, use_reentrant=False)
        else:
            nll, m = _xent_chunk(*part)
        tot = tot + nll
        cnt = cnt + m
    return tot / torch.clamp(cnt, min=1.0), cnt


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


def decayed_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor
                 ) -> torch.Tensor:
    """The recurrence ``h_t = a_t * h_{t-1} + b_t`` from ``h_{-1} = h0``,
    solved for every t of the leading axis at once: h (T, ...).

    a (T, ...) broadcastable against b (T, ...).  h0 is folded into the
    first step, then a log-depth doubling scan (Hillis-Steele) composes
    the affine maps in ceil(log2 T) rounds of whole-tensor products: the
    counterpart of the reference's ``jax.lax.associative_scan`` with the
    same combine, ``(a1, b1) then (a2, b2) = (a1 * a2, b1 * a2 + b2)``, on
    another tree, so the sums round differently.  For T = 1 it is
    ``a * h0 + b``, the operations of :func:`decayed_cumsum`'s step.
    """
    b = torch.cat([a[:1] * h0 + b[:1], b[1:]])
    t, o = a.shape[0], 1
    while o < t:
        b = torch.cat([b[:o], torch.addcmul(b[o:], a[o:], b[:-o])])
        if 2 * o < t:  # the last round needs no longer products of a
            a = torch.cat([a[:o], a[:-o] * a[o:]])
        o *= 2
    return b

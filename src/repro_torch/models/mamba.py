"""Selective SSM (S6 / Mamba) head and the Hymba hybrid block (the port's
``repro.models.mamba``).

The selective scan  h_t = exp(Δ_t ⊙ A) h_{t-1} + Δ_t B_t x_t,  y_t = C_t·h_t
has two forms in :func:`mamba_fwd`, with the same dtypes as the
reference: the projections and the causal conv in ``cfg.compute_dtype``,
Δ, the decay and the state in float32.

* ``chunk=None``: Δ, B and C projected for all T tokens at once and the
  state stepped token by token (:func:`~.common.decayed_cumsum`).  The
  recurrent serving engine (``serve.recurrent_lm``) runs this form, whose
  T = 1 step its token streams were checked with.
* ``chunk=C`` (the ``lm`` paths: training, prefill, decode):
  :func:`selective_scan`, where the reference scans chunks of 16 under a
  checkpoint, each solved by ``jax.lax.associative_scan``.  The port's
  form is an autograd Function of its own over blocks of :data:`SPAN`
  tokens: in a block, every chunk of C tokens runs the recurrence from a
  zero state, all chunks at once, one token a launch; then the states
  entering the chunks follow, one small step a chunk, and each chunk's
  states take their start state's share through its decay from the start,
  exp(A · cumsum Δ).  The forward keeps only its inputs and the state
  entering each block; the backward recomputes a block and runs the
  adjoint recurrence the same way.  So no (T, B, d_inner, N) tensor
  (1.68 GB a layer at hymba-1.5b's training shape) outlives a block, and
  the work is O(T) in ~C + T/C launches a block.  The first port, the
  reference's chunks with a log-depth doubling scan inside, took 41 s a
  hymba-1.5b training step on an H100: ~10⁶ launches and O(T log C)
  traffic.  For T = 1 both forms run the same operations.

Hymba (arXiv:2411.13676): attention heads and a Mamba head run in
parallel on the same normed input; each path is output-normed, then the
two are averaged.  Meta-tokens are out of scope, as in the reference.
``rules`` (on a bound mesh, DTensors) constrain the activations where the
reference does, and the scan runs on each rank's batch and d_inner block.

The SSM functions take the float32 parameters ``p`` and optionally
``pf``, the same tree cast to the compute dtype once (as in
:mod:`.rwkv6`).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..parallel.sharding import (constrain, is_dtensor, local_call,
                                 partial_on)
from .attention import (attention_decode, attention_defs, attention_fwd,
                        attention_prefill)
from .common import Param, cast_tree, decayed_cumsum, rms_norm

__all__ = ["CHUNK", "SPAN", "hymba_block_decode", "hymba_block_fwd",
           "hymba_block_prefill", "hymba_defs", "hymba_mix",
           "init_mamba_state", "mamba_defs", "mamba_dims", "mamba_fwd",
           "mamba_state_dims", "mamba_state_specs", "selective_scan"]

#: Tokens a chunk of the ``lm`` paths' scan (the reference takes 16),
#: and tokens a block: a block's (L, B, d_inner, N) states exist only
#: while the block runs.
CHUNK = 32
SPAN = 1024


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
        "w_in": Param((d, 2 * di), ("fsdp", "d_ff")),
        "conv_w": Param((k, di), (None, "d_ff"), scale=0.1),
        "conv_b": Param((di,), ("d_ff",), init="zeros"),
        "w_x": Param((di, r + 2 * n), ("d_ff", None)),
        "w_dt": Param((r, di), (None, "d_ff")),
        "b_dt": Param((di,), ("d_ff",), init="zeros"),
        "a_log": Param((di, n), ("d_ff", "ssm_state"), init="ones"),
        "d_skip": Param((di,), ("d_ff",), init="ones"),
        "w_out": Param((di, d), ("d_ff", "fsdp")),
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


def _pad_tokens(x: torch.Tensor, length: int) -> torch.Tensor:
    """x (T, ...) with zero tokens appended up to ``length``."""
    if x.shape[0] == length:
        return x
    return torch.cat([x, x.new_zeros((length - x.shape[0],) + x.shape[1:])])


def _chunk_major(x: torch.Tensor, chunk: int) -> torch.Tensor:
    """x (L, ...) with L a multiple of ``chunk`` → (chunk, L / chunk, ...)
    contiguous: token t of every chunk is one contiguous slice."""
    return x.view(-1, chunk, *x.shape[1:]).transpose(0, 1).contiguous()


def _token_major(x: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`_chunk_major`: (C, n, ...) → (C·n, ...)."""
    return x.transpose(0, 1).reshape(-1, *x.shape[2:])


def _block_states(delta, dx, bm, a, h_in):
    """The states h (C, n, B, di, N) of one block of n chunks of C tokens,
    in chunk-major order (:func:`_chunk_major`: delta, dx (C, n, B, di),
    bm (C, n, B, N)), from h_in (B, di, N), and the decays exp(Δ A) of
    the same shape.

    Every chunk first runs the recurrence from a zero state, all chunks at
    once, one token step a launch; then the states entering the chunks
    follow one small step a chunk, with each chunk's decay from its start
    exp(A · Σ Δ) (a cumulative sum, exponent <= 0); last, each chunk's
    states take their start state's share.  O(L) work in C + n launches,
    where a log-depth scan would take O(L log C).
    """
    chunk, n = delta.shape[:2]
    da = torch.exp(delta[..., None] * a)
    hs = dx[..., None] * bm[..., None, :]
    for t in range(1, chunk):
        hs[t].addcmul_(da[t], hs[t - 1])
    decay = torch.exp(delta.cumsum(0)[..., None] * a)
    starts = torch.empty((n,) + h_in.shape, dtype=h_in.dtype,
                         device=h_in.device)
    h = h_in
    for c in range(n):
        starts[c] = h
        h = decay[-1, c] * h + hs[-1, c]
    hs.addcmul_(decay, starts[None])
    return hs, da


def _block_grads(delta, dx, bm, cm, gy, a, h_in, g_out):
    """The backward of one block (chunk-major inputs as
    :func:`_block_states`, cm (C, n, B, N), gy (C, n, B, di)): from the
    gradient gy of its outputs and g_out (B, di, N) of the state it hands
    on, the gradients of Δ, Δ·x, B, C (per token, chunk-major), A (summed)
    and h_in.  The states are recomputed; the adjoint recurrence
    G_t = C_t gy_t + exp(Δ_{t+1} A) G_{t+1} runs as the forward does,
    backwards: chunks from a zero gradient, then the gradients leaving the
    chunks, one small step a chunk, then each chunk's share."""
    hs, da = _block_states(delta, dx, bm, a, h_in)
    chunk, n = delta.shape[:2]
    g = gy[..., None] * cm[..., None, :]
    for t in range(chunk - 2, -1, -1):
        g[t].addcmul_(da[t + 1], g[t + 1])
    after = torch.zeros_like(delta)                          # Σ Δ_u, u > t
    after[:-1] = delta[1:].flip(0).cumsum(0).flip(0)
    decay = torch.exp(after[..., None] * a)                  # t+1 .. chunk end
    g_end = torch.empty((n,) + g_out.shape, dtype=g_out.dtype,
                        device=g_out.device)
    carry = g_out
    for c in range(n - 1, -1, -1):
        g_end[c] = carry
        carry = da[0, c] * (g[0, c] + decay[0, c] * carry)
    g.addcmul_(decay, g_end[None])
    # P_t = dL/d(Δ_t A) = G_t h_{t-1} exp(Δ_t A), into the decay's buffer;
    # a chunk's first token follows the previous chunk's last.
    p = decay
    torch.mul(g[1:], hs[:-1], out=p[1:])
    torch.mul(g[0], torch.cat([h_in[None], hs[-1, :-1]]), out=p[0])
    p.mul_(da)
    flat = lambda x: x.view(-1, *x.shape[2:])  # noqa: E731
    return ((p * a).sum(-1),                                 # Δ
            torch.einsum("tbdn,tbn->tbd", flat(g), flat(bm)),    # Δ·x
            torch.einsum("tbdn,tbd->tbn", flat(g), flat(dx)),    # B
            torch.einsum("tbdn,tbd->tbn", flat(hs), flat(gy)),   # C
            (p * delta[..., None]).sum((0, 1, 2)),           # A
            carry)                                           # h_in


class _SelectiveScan(torch.autograd.Function):
    """y_t = C_t · h_t with h_t = exp(Δ_t A) h_{t-1} + (Δ_t x_t) B_t, over
    blocks of :data:`SPAN` tokens, each in chunks of ``chunk``
    (:func:`_block_states`).  The forward keeps only its inputs and the
    state entering each block; the backward recomputes a block's states
    and runs the adjoint recurrence (:func:`_block_grads`).  So no
    (T, B, d_inner, N) tensor outlives a block, with or without autograd,
    and no ``torch.utils.checkpoint`` is needed."""

    @staticmethod
    def forward(ctx, delta, dx, bm, cm, a, h0, chunk):
        t = delta.shape[0]
        length = -(-t // chunk) * chunk
        delta, dx, bm, cm = (_pad_tokens(u, length)
                             for u in (delta, dx, bm, cm))
        y = torch.empty_like(delta)
        h, starts = h0, []
        for i in range(0, length, SPAN):
            j = min(i + SPAN, length)
            starts.append(h)
            d, x_, b_, c_ = (_chunk_major(u[i:j], chunk)
                             for u in (delta, dx, bm, cm))
            hs, _ = _block_states(d, x_, b_, a, h)
            y[i:j] = _token_major(torch.einsum("cnbdk,cnbk->cnbd", hs, c_))
            h = hs[-1, -1].clone()
            del hs
        ctx.save_for_backward(delta, dx, bm, cm, a, torch.stack(starts))
        ctx.chunk, ctx.t = chunk, t
        return y[:t], h

    @staticmethod
    def backward(ctx, gy, gh):
        delta, dx, bm, cm, a, starts = ctx.saved_tensors
        length, chunk = delta.shape[0], ctx.chunk
        gy = _pad_tokens(gy, length)
        g = torch.zeros_like(starts[0]) if gh is None else gh
        grads = [torch.empty_like(u) for u in (delta, dx, bm, cm)]
        g_a = torch.zeros_like(a)
        blocks = list(range(0, length, SPAN))
        for k in range(len(blocks) - 1, -1, -1):
            i = blocks[k]
            j = min(i + SPAN, length)
            *per_token, ga, g = _block_grads(
                *(_chunk_major(u[i:j], chunk)
                  for u in (delta, dx, bm, cm, gy)), a, starts[k], g)
            for buf, val in zip(grads, per_token):
                buf[i:j] = _token_major(val.view(chunk, -1, *val.shape[-2:]))
            g_a += ga
        t = ctx.t
        return (*(buf[:t] for buf in grads), g_a, g, None)


def selective_scan(delta: torch.Tensor, dx: torch.Tensor, bm: torch.Tensor,
                   cm: torch.Tensor, a: torch.Tensor, h0: torch.Tensor,
                   chunk: int = CHUNK) -> Tuple[torch.Tensor, torch.Tensor]:
    """delta, dx = Δ·x (T, B, di); bm, cm (T, B, N); a = A (di, N); h0
    (B, di, N); all float32 → (y (T, B, di), final state (B, di, N)), in
    chunks of ``chunk`` tokens (:class:`_SelectiveScan`).  For T = 1 it
    is the stepped form's own step."""
    if delta.shape[0] == 1:
        da = torch.exp(delta[..., None] * a)
        db = dx[..., None] * bm[:, :, None, :]
        hs, h = decayed_cumsum(da, db, h0)
        return torch.einsum("tbdn,tbn->tbd", hs, cm), h
    return _SelectiveScan.apply(delta, dx, bm, cm, a, h0, chunk)


def _scan_local(delta, dx, bm, cm, a, h0, chunk, rules):
    """:func:`selective_scan` on DTensors: each rank scans its batch block
    and its d_inner block (``d_ff``); the products over d_inner in the
    backward give partial gradients of B and C, and each batch block its
    share of A's.  A zero state (``h0`` None) is made on the rank."""
    mesh = rules.mesh
    tok = (None, rules.axis("act_batch"), rules.axis("d_ff"))
    bc = (None, rules.axis("act_batch"), None)
    st = (rules.axis("act_batch"), rules.axis("d_ff"), None)
    grad_bc = partial_on(bc, rules.axis("d_ff"), mesh)
    # A is the same on every batch shard: its gradient sums over them
    grad_a = partial_on((rules.axis("d_ff"), None), rules.axis("act_batch"),
                        mesh)

    def fn(delta_, dx_, bm_, cm_, a_, h_):
        if h_ is None:
            h_ = torch.zeros(delta_.shape[1:] + a_.shape[1:],
                             device=delta_.device)
        return selective_scan(delta_, dx_, bm_, cm_, a_, h_, chunk)

    return local_call(fn, mesh, (delta, dx, bm, cm, a, h0),
                      (tok, tok, bc, bc, (rules.axis("d_ff"), None), st),
                      [tok, st], (None, None, grad_bc, grad_bc, grad_a, None))


def mamba_fwd(p, x: torch.Tensor, cfg: ArchConfig,
              state: Optional[Dict[str, torch.Tensor]] = None, pf=None,
              chunk: Optional[int] = None, rules=None):
    """x (B, T, D) → (y (B, T, D), ``{'h', 'conv'}``).  ``chunk`` picks the
    form (module doc): None steps token by token, an int solves chunks of
    that many tokens (the last may be shorter)."""
    dt_ = cfg.compute_dtype
    pf = pf if pf is not None else cast_tree(p, dt_)
    b, t, _ = x.shape
    di, r, n = mamba_dims(cfg)
    # (on DTensors the projection's gradient comes back in its own
    # layout, so each rank forms its block of w_in's gradient)
    xz = constrain(x @ pf["w_in"], rules, ("act_batch", "seq", "d_ff"))
    xm, z = torch.chunk(xz, 2, dim=-1)
    xm = constrain(xm, rules, ("act_batch", "seq", "d_ff"))
    tail = None if state is None else state["conv"]
    xm, new_tail = _causal_conv(xm, pf["conv_w"], pf["conv_b"], tail)
    xm = F.silu(xm)

    a = -torch.exp(p["a_log"].float())                       # (di, N)
    if is_dtensor(xm):
        # The projections token-major (B, T, ...), then to (T, B, ...): a
        # product over a transposed batch-sharded view would flatten it
        # into a layout DTensor cannot split back.  (The plain path keeps
        # the time-major products, whose backward rounds differently.)
        proj = constrain(xm @ pf["w_x"], rules, ("act_batch", "seq", None))
        dt_r, bm, cm = torch.split(proj, [r, n, n], dim=-1)
        delta = F.softplus((dt_r @ pf["w_dt"]).float() + p["b_dt"].float())
        dx = delta * xm.float()
        delta, dx, bm, cm = (u.transpose(0, 1) for u in (delta, dx,
                                                          bm.float(),
                                                          cm.float()))
    else:
        xt = xm.transpose(0, 1)                              # (T, B, di)
        proj = xt @ pf["w_x"]                                # (T, B, r+2N)
        dt_r, bm, cm = torch.split(proj, [r, n, n], dim=-1)
        delta = F.softplus((dt_r @ pf["w_dt"]).float() + p["b_dt"].float())
        dx, bm, cm = delta * xt.float(), bm.float(), cm.float()
    h0 = None if state is None else state["h"]
    if is_dtensor(delta):
        y, h_final = _scan_local(delta, dx, bm, cm, a, h0, chunk or 1, rules)
    else:
        h0 = torch.zeros((b, di, n), device=x.device) if h0 is None else h0
        if chunk is None:
            da = torch.exp(delta[..., None] * a)             # (T, B, di, N)
            db = dx[..., None] * bm[:, :, None, :]
            hs, h_final = decayed_cumsum(da, db, h0)
            y = torch.einsum("tbdn,tbn->tbd", hs, cm)
        else:
            y, h_final = selective_scan(delta, dx, bm, cm, a, h0, chunk)
    y = y.transpose(0, 1).to(dt_)
    y = y + pf["d_skip"] * xm
    y = y * F.silu(z)
    out = constrain(y @ pf["w_out"], rules, ("act_batch", "seq", "d_model"))
    return out, {"h": h_final, "conv": new_tail}


def init_mamba_state(cfg: ArchConfig, batch: int,
                     device: torch.device) -> Dict[str, torch.Tensor]:
    """A zero state: ``h`` (B, d_inner, N) float32, ``conv`` (B, K-1,
    d_inner) in the compute dtype."""
    di, _, n = mamba_dims(cfg)
    return {
        "h": torch.zeros((batch, di, n), device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, di),
                            dtype=cfg.compute_dtype, device=device),
    }


def mamba_state_dims(cfg: ArchConfig) -> Dict[str, tuple]:
    """The reference's logical dims of each state leaf (for sharding
    specs)."""
    return {
        "h": ("cache_batch", "d_ff", "ssm_state"),
        "conv": ("cache_batch", None, "d_ff"),
    }


# ---------------------------------------------------------------------------
# Hymba parallel hybrid block
# ---------------------------------------------------------------------------


def hymba_defs(cfg: ArchConfig, q_heads: int, kv_heads: int
               ) -> Dict[str, Any]:
    d = cfg.d_model
    return {
        "attn": attention_defs(cfg, q_heads, kv_heads),
        "mamba": mamba_defs(cfg),
        "norm_attn": Param((d,), ("d_model",), init="zeros"),
        "norm_mamba": Param((d,), ("d_model",), init="zeros"),
    }


def hymba_mix(p, attn_out: torch.Tensor, mamba_out: torch.Tensor,
              cfg: ArchConfig) -> torch.Tensor:
    """Per-path output norm, then the average (Hymba §3.1)."""
    a = rms_norm(attn_out, p["norm_attn"])
    m = rms_norm(mamba_out, p["norm_mamba"])
    return 0.5 * (a + m)


def hymba_block_fwd(p, x: torch.Tensor, cfg: ArchConfig, is_global: bool,
                    positions: torch.Tensor, impl: str = "cuda", rules=None
                    ) -> torch.Tensor:
    """Train / no-cache path; the attention through the flash kernels
    (``impl`` as in ``attention_fwd``)."""
    attn_out = attention_fwd(p["attn"], x, cfg, is_global, positions,
                             impl=impl, rules=rules)
    mamba_out, _ = mamba_fwd(p["mamba"], x, cfg, chunk=CHUNK, rules=rules)
    return hymba_mix(p, attn_out, mamba_out, cfg)


def hymba_block_prefill(p, x: torch.Tensor, cfg: ArchConfig,
                        is_global: bool, cache, rules=None):
    """Prefill from an empty state: the attention fills ``cache['kv']`` in
    place; returns (out, ``{'kv', 'ssm'}``) with the new SSM state."""
    attn_out, kv = attention_prefill(p["attn"], x, cfg, is_global,
                                     cache["kv"], rules)
    mamba_out, ssm = mamba_fwd(p["mamba"], x, cfg, chunk=CHUNK, rules=rules)
    return hymba_mix(p, attn_out, mamba_out, cfg), {"kv": kv, "ssm": ssm}


def hymba_block_decode(p, x: torch.Tensor, cfg: ArchConfig, is_global: bool,
                       cache, pos: int, rules=None):
    """Decode (C = 1) or extend (C > 1) from the cache's KV and SSM state;
    returns (out, ``{'kv', 'ssm'}``)."""
    attn_out, kv = attention_decode(p["attn"], x, cfg, is_global,
                                    cache["kv"], pos, rules)
    mamba_out, ssm = mamba_fwd(p["mamba"], x, cfg, state=cache["ssm"],
                               chunk=CHUNK, rules=rules)
    return hymba_mix(p, attn_out, mamba_out, cfg), {"kv": kv, "ssm": ssm}

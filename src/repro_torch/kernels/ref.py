"""Plain PyTorch versions of the port's kernels (the port's oracles).

Each function states in tensor operations what one CUDA kernel of
``kernels/csrc`` computes, mirroring the JAX oracle of the same name in
``repro.kernels.ref``.  The CPU tests hold them against the JAX package;
``chip_smoke.py`` holds each CUDA kernel against them on the card; and the
dispatch layer (:mod:`.ops`) runs them for tensors that lie on the CPU.

Unlike the functional JAX oracles, the write functions update their pools
in place (the JAX engine donates its pools to the same effect) and return
them, so both packages' call sites read alike.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = [
    "tiled_transpose",
    "spmv_ell",
    "spmv_ell_panel",
    "csr_to_ell",
    "strided_gather",
    "strided_scatter",
    "recurrent_state_read",
    "recurrent_state_write",
    "indirect_gather",
    "indirect_scatter",
    "moe_slots",
    "moe_dispatch",
    "moe_combine",
    "paged_decode_attention",
    "paged_prefill_attention",
    "paged_verify_attention",
    "speculative_accept",
    "paged_kv_append",
    "paged_kv_write_chunk",
    "paged_kv_destinations",
    "paged_kv_write",
    "int8_quantize",
    "quantize_kv",
    "dequantize_pages",
    "mha",
    "flash_attention_fwd",
    "flash_attention_bwd",
]


# ---------------------------------------------------------------------------
# Tiled in-situ matrix transpose (ismt workload)
# ---------------------------------------------------------------------------


def tiled_transpose(x: torch.Tensor) -> torch.Tensor:
    """The last two axes swapped, as a new contiguous tensor."""
    return x.transpose(-1, -2).contiguous()


# ---------------------------------------------------------------------------
# Sparse matrix-vector product (spmv / prank workloads)
# ---------------------------------------------------------------------------


def spmv_ell(vals: torch.Tensor, cols: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """ELL-format SpMV: y[r] = sum_k vals[r,k] * x[cols[r,k]].

    Column indices are clamped to ``[0, len(x) - 1]`` (the reference's
    ``take(mode='clip')``).  Padding entries carry ``vals == 0``, so they
    contribute nothing.
    """
    xg = x[cols.long().clamp(0, x.shape[0] - 1)]
    return (vals * xg).sum(-1)


def spmv_ell_panel(vals: torch.Tensor, cols: torch.Tensor, x: torch.Tensor,
                   panel_ids: torch.Tensor, panel: int = 512) -> torch.Tensor:
    """Panel-streamed ELL SpMV, step by step as ``_spmv_panel_body``.

    ``panel_ids`` is ``(row_blocks, steps)``: step ``s`` of row block ``b``
    covers the columns ``s*kb .. (s+1)*kb - 1`` of the block's rows
    (``kb = K / steps``) and gathers them from the ``panel``-wide slice of
    ``x`` at ``panel_ids[b, s] * panel``, the id clamped to the panels of
    ``x``.  An entry whose column lies outside that panel is masked to
    zero, not clipped, and each step's partial row sum is added to ``y`` in
    step order.
    """
    r, k = vals.shape
    row_blocks, steps = panel_ids.shape
    row_block, kb = r // row_blocks, k // steps
    pid = panel_ids.long().clamp(0, x.shape[0] // panel - 1)
    base = (pid * panel).repeat_interleave(row_block, 0)       # (R, steps)
    base = base.repeat_interleave(kb, 1)                       # (R, K)
    local = cols.long() - base
    valid = (local >= 0) & (local < panel)
    xg = x[base + local.clamp(0, panel - 1)]
    contrib = torch.where(valid, vals * xg, torch.zeros_like(vals))
    partial = contrib.view(r, steps, kb).sum(-1)               # (R, steps)
    y = torch.zeros(r, dtype=vals.dtype, device=vals.device)
    for s in range(steps):
        y = y + partial[:, s]
    return y


def csr_to_ell(indptr: np.ndarray, indices: np.ndarray, data: np.ndarray,
               n_rows: int, pad_to: Optional[int] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
    """CSR arrays to padded ELL ``(vals, cols)`` numpy arrays.

    Row ``r``'s nonzeros fill the leading ``indptr[r+1] - indptr[r]``
    entries of its ELL row; the rest are zeros (value and column 0).  The
    width is the longest row, or ``pad_to``.
    """
    indptr = np.asarray(indptr)
    counts = np.diff(indptr)
    k = int(counts.max()) if pad_to is None else pad_to
    vals = np.zeros((n_rows, k), dtype=data.dtype)
    cols = np.zeros((n_rows, k), dtype=indices.dtype)
    lo, hi = int(indptr[0]), int(indptr[n_rows])
    rows = np.repeat(np.arange(n_rows), counts[:n_rows])
    pos = np.arange(lo, hi) - indptr[rows]
    if pos.size and int(pos.max()) >= k:
        raise ValueError(f"a row has {int(pos.max()) + 1} nonzeros, more "
                         f"than the ELL width {k}")
    vals[rows, pos] = data[lo:hi]
    cols[rows, pos] = indices[lo:hi]
    return vals, cols


# ---------------------------------------------------------------------------
# Packed strided stream converters
# ---------------------------------------------------------------------------


def _strided_rows(base: int, stride: int, count: int,
                  device: torch.device) -> torch.Tensor:
    return base + stride * torch.arange(count, device=device)


def strided_gather(src: torch.Tensor, base: int, stride: int,
                   count: int) -> torch.Tensor:
    """out[k] = src[base + k*stride], rows clipped to those of ``src`` (the
    reference's ``take(mode='clip')``)."""
    idx = _strided_rows(base, stride, count, src.device)
    return src[idx.clamp(0, src.shape[0] - 1)]


def strided_scatter(dst: torch.Tensor, packed: torch.Tensor, base: int,
                    stride: int) -> torch.Tensor:
    """dst[base + k*stride] = packed[k], in place; returns ``dst``.  A row
    outside ``[0, len(dst))`` is dropped (the reference's scatter mode)."""
    idx = _strided_rows(base, stride, packed.shape[0], dst.device)
    keep = (idx >= 0) & (idx < dst.shape[0])
    dst[idx[keep]] = packed[keep]
    return dst


def recurrent_state_read(pool: torch.Tensor, slot: int) -> torch.Tensor:
    """out[l] = pool[l, slot]: one sequence's state rows from a
    ``(L, B, *row)`` pool, as a new tensor."""
    return pool[:, slot].clone()


def recurrent_state_write(pool: torch.Tensor, slot: int,
                          value: torch.Tensor) -> torch.Tensor:
    """pool[l, slot] = value[l], in place; returns ``pool``."""
    pool[:, slot] = value
    return pool


# ---------------------------------------------------------------------------
# Packed indirect stream converters
# ---------------------------------------------------------------------------


def indirect_gather(src: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """out[k] = src[indices[k]], indices clipped to the rows of ``src``
    (the reference's ``take(mode='clip')``)."""
    idx = indices.long().clamp(0, src.shape[0] - 1)
    return src[idx]


def indirect_scatter(dst: torch.Tensor, packed: torch.Tensor,
                     indices: torch.Tensor) -> torch.Tensor:
    """dst[indices[k]] = packed[k], in place; returns ``dst``.

    An index outside ``[0, len(dst))`` drops its row, which is how the
    callers discard inactive and padding rows.  Duplicate in-range indices
    have no defined order; the paged callers never repeat one.
    """
    idx = indices.long()
    keep = (idx >= 0) & (idx < dst.shape[0])
    dst[idx[keep]] = packed[keep]
    return dst


# ---------------------------------------------------------------------------
# MoE dispatch / combine (packed token routing)
# ---------------------------------------------------------------------------


def moe_slots(expert_idx: torch.Tensor, num_experts: int, capacity: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The dispatch's slot arithmetic: the reference's integers.

    expert_idx (T, K).  Returns (slot (T·K,) int64: the buffer row of each
    assignment ``token * K + k``, or ``E·C`` where it is dropped; keep
    (T·K,) bool; src (E·C,) int32: the assignment each row holds, or -1).
    An assignment's rank within its expert is a cumulative sum of
    one-hots in assignment order, read at its own expert; ranks at or past
    ``capacity`` drop.  The one-hots are summed as (E, T·K) rows, a scan
    along the inner axis: the reference's (T·K, E) scan along the outer
    axis gives the same integers but took ~25 ms on the card at T·K =
    65,536 (H100, in PyTorch's outer-axis scan kernel).
    """
    flat_e = expert_idx.reshape(-1).long()                    # (TK,)
    onehot = torch.nn.functional.one_hot(flat_e, num_experts).t()
    counts = torch.cumsum(onehot.to(torch.int32).contiguous(), dim=1,
                          dtype=torch.int32)                  # (E, TK)
    pos_in_e = counts.gather(0, flat_e[None])[0].long() - 1   # rank in expert
    keep = pos_in_e < capacity
    n_slots = num_experts * capacity
    slot = torch.where(keep, flat_e * capacity + pos_in_e,
                       torch.full_like(flat_e, n_slots))
    src = torch.full((n_slots + 1,), -1, dtype=torch.int32,
                     device=expert_idx.device)
    src = src.scatter(0, slot, torch.arange(
        slot.numel(), dtype=torch.int32, device=expert_idx.device))[:-1]
    return slot, keep, src


def moe_dispatch(tokens: torch.Tensor, expert_idx: torch.Tensor,
                 num_experts: int, capacity: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pack tokens into per-expert buffers (the reference's oracle).

    tokens (T, D); expert_idx (T, K) top-k expert of each token.  Returns
    (buffers (E, C, D), src (E, C) int32: the assignment ``token * K + k``
    a slot holds or -1 for an empty one, keep (T, K) bool: whether each
    assignment found room).  The buffer is a take of the K-fold repeated
    tokens at ``src``, zero where it is -1; differentiable in ``tokens``.
    """
    t, d = tokens.shape
    k = expert_idx.shape[1]
    _, keep, src = moe_slots(expert_idx, num_experts, capacity)
    tok_rep = tokens.repeat_interleave(k, dim=0)              # (TK, D)
    buf = torch.where((src >= 0)[:, None],
                      tok_rep[src.long().clamp(min=0)], 0.0)
    return (buf.reshape(num_experts, capacity, d),
            src.reshape(num_experts, capacity), keep.reshape(t, k))


def moe_combine(outputs: torch.Tensor, src_index: torch.Tensor,
                gate_weights: torch.Tensor, num_tokens: int) -> torch.Tensor:
    """Un-pack expert outputs back to token order with gate weighting (the
    reference's oracle): a scatter-add of the (E, C, D) rows to their
    assignments (empty slots add zero rows), then ``einsum('tkd,tk->td')``
    with the gates in the outputs' dtype."""
    e, c, d = outputs.shape
    k = gate_weights.shape[1]
    flat_out = outputs.reshape(e * c, d)
    flat_src = src_index.reshape(e * c).long()
    contrib = torch.zeros((num_tokens * k, d), dtype=outputs.dtype,
                          device=outputs.device)
    contrib = contrib.index_add(0, flat_src.clamp(min=0), torch.where(
        (flat_src >= 0)[:, None], flat_out, 0.0))
    contrib = contrib.reshape(num_tokens, k, d)
    return torch.einsum("tkd,tk->td", contrib,
                        gate_weights.to(outputs.dtype))


# ---------------------------------------------------------------------------
# Paged attention
# ---------------------------------------------------------------------------


def _scale(d: int, scale: Optional[float]) -> float:
    return scale if scale is not None else 1.0 / math.sqrt(d)


# ---------------------------------------------------------------------------
# Flash attention (training path)
# ---------------------------------------------------------------------------

NEG_INF = -1e30  # the kernels' finite mask sentinel


def _attn_mask(q_len: int, kv_len: int, causal: bool, window: Optional[int],
               device: torch.device, q_offset: int = 0) -> torch.Tensor:
    """(q_len, kv_len) boolean mask; True = attend."""
    qi = q_offset + torch.arange(q_len, device=device)[:, None]
    kj = torch.arange(kv_len, device=device)[None, :]
    m = torch.ones((q_len, kv_len), dtype=torch.bool, device=device)
    if causal:
        m &= qi >= kj
    if window is not None:
        m &= qi - kj < window
    return m


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        causal: bool = True, window: Optional[int] = None, q_offset: int = 0,
        scale: Optional[float] = None) -> torch.Tensor:
    """Reference attention (``repro.kernels.ref.mha``), the oracle of the
    flash kernels.  q (B, H, S, D); k, v (B, KVH, Skv, D); GQA by repeat.

    Scores in q's dtype, softmax in float32 with -inf masking; a fully
    masked row gives zeros.
    """
    b, h, sq, d = q.shape
    kvh = k.shape[1]
    if kvh != h:
        rep = h // kvh
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * _scale(d, scale)
    mask = _attn_mask(sq, k.shape[2], causal, window, q.device, q_offset)
    logits = logits.masked_fill(~mask, float("-inf"))
    w = torch.nan_to_num(torch.softmax(logits, dim=-1), nan=0.0)
    return torch.einsum("bhqk,bhkd->bhqd", w, v.float()).to(q.dtype)


def _group_scores(q: torch.Tensor, k: torch.Tensor, g: int, rep: int,
                  sc: float) -> torch.Tensor:
    """float32 scores of KV head ``g``'s query heads: (B, rep, Sq, Skv)."""
    qg = q[:, g * rep:(g + 1) * rep].float()
    return qg @ k[:, g:g + 1].float().transpose(-1, -2) * sc


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: Optional[int] = None,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """What the flash forward kernels compute: ``(o, lse)``.

    q (B, H, Sq, D); k, v (B, KVH, Skv, D), GQA head ``h`` reading KV head
    ``h // (H / KVH)``; query i sits at position i.  float32 arithmetic
    whatever the input dtype; the mask is ``causal`` and/or ``window`` over
    the true Skv (nothing is padded).  ``o`` in q's dtype, ``lse = m +
    log l`` (B, H, Sq) float32.  A fully masked row gives ``o = 0`` and
    ``lse = -1e30``: the kernels' ``l == 0 → 1`` rule.  Scores are formed
    one KV group at a time, so at most (B, H/KVH, Sq, Skv) float32 live.
    """
    b, h, sq, d = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    rep = h // kvh
    sc = _scale(d, scale)
    mask = _attn_mask(sq, skv, causal, window, q.device)
    o = torch.empty((b, kvh, rep, sq, d), dtype=torch.float32, device=q.device)
    lse = torch.empty((b, kvh, rep, sq), dtype=torch.float32, device=q.device)
    for g in range(kvh):
        s = _group_scores(q, k, g, rep, sc).masked_fill(~mask, NEG_INF)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m).masked_fill(~mask, 0.0)
        del s
        l = p.sum(dim=-1, keepdim=True)
        l = torch.where(l == 0.0, torch.ones_like(l), l)
        o[:, g] = (p @ v[:, g:g + 1].float()) / l
        lse[:, g] = (m + torch.log(l))[..., 0]
    return o.reshape(b, h, sq, d).to(q.dtype), lse.reshape(b, h, sq)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        causal: bool = True, window: Optional[int] = None,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """What the two backward kernels compute: ``(dq, dk, dv)``.

    The formulas of the reference's ``_dkv_body`` / ``_dq_body`` on whole
    score matrices: ``p = exp(s - lse)`` under the mask, ``dv = pᵀ·do``,
    ``dp = do·vᵀ``, ``ds = p·(dp - delta)·scale`` with ``delta =
    rowsum(do·o)``, ``dq = ds·k``, ``dk = dsᵀ·q``; dk and dv summed over
    each GQA group.  float32 arithmetic; results in the inputs' dtypes.
    """
    b, h, sq, d = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    rep = h // kvh
    sc = _scale(d, scale)
    mask = _attn_mask(sq, skv, causal, window, q.device)
    delta = (do.float() * o.float()).sum(dim=-1)
    dq = torch.empty((b, h, sq, d), dtype=torch.float32, device=q.device)
    dk = torch.empty((b, kvh, skv, d), dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    for g in range(kvh):
        heads = slice(g * rep, (g + 1) * rep)
        s = _group_scores(q, k, g, rep, sc)
        p = torch.where(mask, torch.exp(s - lse[:, heads, :, None]), 0.0)
        del s
        dog = do[:, heads].float()
        dv[:, g] = (p.transpose(-1, -2) @ dog).sum(dim=1)
        dp = dog @ v[:, g:g + 1].float().transpose(-1, -2)
        ds = p * (dp - delta[:, heads, :, None]) * sc
        del p, dp
        dq[:, heads] = ds @ k[:, g:g + 1].float()
        dk[:, g] = (ds.transpose(-1, -2) @ q[:, heads].float()).sum(dim=1)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def paged_decode_attention(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    page_table: torch.Tensor,
    lengths: torch.Tensor,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Decode attention over a paged KV cache (``repro.kernels.ref``
    ``paged_decode_attention``).

    q (B, H, D); k/v_pages (P, page, KVH, D) fp32 or bf16 (the gathered
    rows are widened to fp32, exactly); page_table (B, pages_per_seq)
    int32 physical page ids; lengths (B,) live tokens.  A sequence of
    length 0 gives exact zeros.
    """
    b, h, d = q.shape
    pages_per_seq = page_table.shape[1]
    page, kvh = k_pages.shape[1], k_pages.shape[2]
    skv = pages_per_seq * page
    table = page_table.long()
    kg = k_pages[table].float().reshape(b, skv, kvh, d).transpose(1, 2)
    vg = v_pages[table].float().reshape(b, skv, kvh, d).transpose(1, 2)
    rep = h // kvh
    kg = kg.repeat_interleave(rep, dim=1)
    vg = vg.repeat_interleave(rep, dim=1)
    logits = torch.einsum("bhd,bhkd->bhk", q, kg).float() * _scale(d, scale)
    pos = torch.arange(skv, device=q.device)
    mask = pos[None, :] < lengths.long()[:, None]
    logits = logits.masked_fill(~mask[:, None, :], float("-inf"))
    w = torch.softmax(logits, dim=-1)
    w = torch.nan_to_num(w, nan=0.0)
    return torch.einsum("bhk,bhkd->bhd", w, vg.float()).to(q.dtype)


def paged_prefill_attention(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    ctx_rows: torch.Tensor,
    starts: torch.Tensor,
    counts: torch.Tensor,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Causal chunk attention over a paged KV pool (``repro.kernels.ref``
    ``paged_prefill_attention``).

    q (R, C, H, D): row r's query ``c`` sits at ``starts[r] + c`` and sees
    positions ``0 .. starts[r] + c``, capped at ``starts[r] + counts[r]``.
    ctx_rows (R, ctx_pages) leading page-table entries; starts/counts (R,).
    Pools fp32 or bf16 (widened to fp32 after the gather).  The mask uses
    a finite sentinel (the float32 minimum) and zeroes masked weights, so
    rows with ``counts == 0`` give exact zeros, never NaN.
    """
    r, c, h, d = q.shape
    page, kvh = k_pages.shape[1], k_pages.shape[2]
    ctx_pages = ctx_rows.shape[1]
    skv = ctx_pages * page
    flat = ctx_rows.reshape(-1).long()
    kg = k_pages[flat].float().reshape(r, skv, kvh, d)
    vg = v_pages[flat].float().reshape(r, skv, kvh, d)
    rep = h // kvh
    kg = kg.repeat_interleave(rep, dim=2)                   # (R, S, H, D)
    vg = vg.repeat_interleave(rep, dim=2)
    starts = starts.long()
    counts = counts.long()
    pos = starts[:, None] + torch.arange(c, device=q.device)   # (R, C)
    kv_pos = torch.arange(skv, device=q.device)
    live = torch.where(counts > 0, starts + counts, torch.zeros_like(counts))
    mask = (kv_pos[None, None, :] <= pos[:, :, None]) & (
        kv_pos[None, None, :] < live[:, None, None]
    )                                                       # (R, C, S)
    s = torch.einsum("rchd,rshd->rchs", q, kg).float() * _scale(d, scale)
    s = s.masked_fill(~mask[:, :, None, :], torch.finfo(s.dtype).min)
    w = torch.softmax(s, dim=-1)
    w = w.masked_fill(~mask[:, :, None, :], 0.0)
    out = torch.einsum("rchs,rshd->rchd", w, vg.float())
    return out.to(q.dtype)


def paged_verify_attention(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    ctx_rows: torch.Tensor,
    lengths: torch.Tensor,
    counts: torch.Tensor,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Multi-query speculative verify attention (``repro.kernels.ref``
    ``paged_verify_attention``).

    q (B, K, H, D): query ``i`` of row ``r`` is the token at position
    ``lengths[r] + i``, its K/V already written to the pool; ``counts``
    (B,) valid queries per row (0 = padding row, zeros).  A verify chunk is
    a causal prefill chunk at the context tail, so this is
    :func:`paged_prefill_attention` with ``starts = lengths``.
    """
    return paged_prefill_attention(q, k_pages, v_pages, ctx_rows, lengths,
                                   counts, scale=scale)


def speculative_accept(drafts: torch.Tensor, greedy: torch.Tensor,
                       counts: torch.Tensor) -> torch.Tensor:
    """Greedy first-mismatch acceptance (``repro.kernels.ref``
    ``speculative_accept``): how many of the K scored tokens each row emits.

    drafts (B, K-1), greedy (B, K), counts (B,) int32.  Returns
    ``min(a + 1, counts)`` as int32, where ``a`` is the length of the
    draft prefix that matches the model's own argmax.  Integer ops on the
    device only: nothing is read back to the host.
    """
    match = (drafts == greedy[:, : drafts.shape[1]]).to(torch.int32)
    a = torch.cumprod(match, dim=1).sum(dim=1)
    return torch.minimum(a + 1, counts.to(a.dtype)).to(torch.int32)


# ---------------------------------------------------------------------------
# Paged KV writes: the full-pool oracles, and the write kernel's plain version
# ---------------------------------------------------------------------------


def paged_kv_append(
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    page_table: torch.Tensor,
    lengths: torch.Tensor,
    active: Optional[torch.Tensor] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
):
    """Append one KV token per sequence into the paged pool, in place.

    Sequence ``b`` writes its row to ``(page_table[b, len_b // page],
    len_b % page)``.  Inactive sequences (``active`` bool, or 0/1 ints),
    appends that fall past the table row and page ids of ``P`` or more
    write nothing (a negative id wraps, as in the reference); inactive ones
    keep their length.  Rows are stored in the pool's dtype (rounded to
    nearest even into a bf16 pool).  With the ``(P, page, KVH)`` scale
    pools given, rows are quantized on write (:func:`quantize_kv`): codes
    into the pages, scales into the scale pools at the same slots.

    Returns ``(k_pages, v_pages, new_lengths)``, plus ``(k_scale,
    v_scale)`` when quantizing.
    """
    p, page, kvh, d = k_pages.shape
    n_pages = page_table.shape[1]
    quantized = k_scale is not None
    if quantized:
        k_new, k_s = quantize_kv(k_new)
        v_new, v_s = quantize_kv(v_new)
    lens = lengths.long()
    if active is None:
        active = torch.ones_like(lens, dtype=torch.bool)
    active = active.bool()
    slot = (lens // page).clamp(0, n_pages - 1)
    pids = page_table.long().gather(1, slot[:, None])[:, 0]
    keep = active & (lens < n_pages * page) & (pids < p)
    flat = (pids * page + lens % page)[keep]
    k_pages.view(p * page, kvh, d)[flat] = k_new[keep].to(k_pages.dtype)
    v_pages.view(p * page, kvh, d)[flat] = v_new[keep].to(v_pages.dtype)
    new_len = lengths + active.to(lengths.dtype)
    if quantized:
        k_scale.view(p * page, kvh)[flat] = k_s[keep]
        v_scale.view(p * page, kvh)[flat] = v_s[keep]
        return k_pages, v_pages, new_len, k_scale, v_scale
    return k_pages, v_pages, new_len


def paged_kv_write_chunk(
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    rows: torch.Tensor,
    starts: torch.Tensor,
    counts: torch.Tensor,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
):
    """Write one prefill chunk per sequence into the paged pool, in place.

    Sequence ``r`` writes its ``counts[r]`` leading rows of ``k_new[r]`` /
    ``v_new[r]`` (each ``(C, KVH, D)``) at positions ``starts[r] + c``
    through its page-table row ``rows[r]``; rows with ``counts == 0``, and
    page ids of ``P`` or more, write nothing.  A position past the table
    row takes its last entry, as the reference's oracle does (the kernel
    drops it: :func:`paged_kv_write`).  Stores in the pool's dtype, as
    :func:`paged_kv_append`; quantizes on write when the scale pools are
    given.  Returns ``(k_pages, v_pages)``, plus ``(k_scale,
    v_scale)`` when quantizing.
    """
    p, page, kvh, d = k_pages.shape
    r, c = k_new.shape[:2]
    n_pages = rows.shape[1]
    quantized = k_scale is not None
    if quantized:
        k_new, k_s = quantize_kv(k_new)
        v_new, v_s = quantize_kv(v_new)
    ar = torch.arange(c, device=rows.device)
    pos = starts.long()[:, None] + ar                          # (R, C)
    pids = rows.long().gather(1, (pos // page).clamp(0, n_pages - 1))
    valid = ((ar[None, :] < counts.long()[:, None])
             & (pids < p)).reshape(-1)
    flat = (pids * page + pos % page).reshape(-1)[valid]
    k_pages.view(p * page, kvh, d)[flat] = \
        k_new.reshape(-1, kvh, d)[valid].to(k_pages.dtype)
    v_pages.view(p * page, kvh, d)[flat] = \
        v_new.reshape(-1, kvh, d)[valid].to(v_pages.dtype)
    if quantized:
        k_scale.view(p * page, kvh)[flat] = k_s.reshape(-1, kvh)[valid]
        v_scale.view(p * page, kvh)[flat] = v_s.reshape(-1, kvh)[valid]
        return k_pages, v_pages, k_scale, v_scale
    return k_pages, v_pages


def paged_kv_destinations(rows: torch.Tensor, starts: torch.Tensor,
                          counts: torch.Tensor, chunk: int, page: int,
                          pool_pages: int) -> torch.Tensor:
    """``(R, C)`` flat pool row (``pid * page + pos % page``) of each token
    ``(r, c)`` of a paged write at ``pos = starts[r] + c``, or -1 where the
    token is dropped: ``c >= counts[r]``, ``pos`` outside ``[0, n_pages *
    page)``, or the page id ``rows[r, pos // page]`` outside ``[0,
    pool_pages)`` — the rule the write kernel applies in each warp."""
    n_pages = rows.shape[1]
    ar = torch.arange(chunk, device=rows.device)
    pos = starts.long()[:, None] + ar
    pids = rows.long().gather(1, (pos // page).clamp(0, n_pages - 1))
    keep = ((ar[None, :] < counts.long()[:, None]) & (pos >= 0)
            & (pos < n_pages * page) & (pids >= 0) & (pids < pool_pages))
    return torch.where(keep, pids * page + pos % page, -1)


def paged_kv_write(
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    rows: torch.Tensor,
    starts: torch.Tensor,
    counts: torch.Tensor,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
):
    """The paged K/V write kernel's plain version, in place.

    Token ``(r, c)`` of ``k_new`` / ``v_new`` ``(R, C, KVH, D)`` goes
    straight to its pool row (:func:`paged_kv_destinations`); dropped
    tokens write nothing.  An append is ``C = 1`` with ``lengths`` as
    ``starts`` and ``active`` as ``counts``.  fp32 rows go into an fp32
    pool as they are and into a bf16 pool rounded to nearest even
    (``Tensor.to``, as the kernel's ``__float2bfloat16_rn``); with the
    scale pools given they are quantized on write (:func:`quantize_kv`).
    Returns the pools it was given.
    """
    p, page, kvh, d = k_pages.shape
    r, c = k_new.shape[:2]
    dest = paged_kv_destinations(rows, starts, counts, c, page, p).reshape(-1)
    keep = dest >= 0
    flat = dest[keep]
    kn = k_new.reshape(-1, kvh, d)[keep]
    vn = v_new.reshape(-1, kvh, d)[keep]
    if k_scale is not None:
        kn, ks = quantize_kv(kn)
        vn, vs = quantize_kv(vn)
        k_scale.view(p * page, kvh)[flat] = ks
        v_scale.view(p * page, kvh)[flat] = vs
    k_pages.view(p * page, kvh, d)[flat] = kn.to(k_pages.dtype)
    v_pages.view(p * page, kvh, d)[flat] = vn.to(v_pages.dtype)
    if k_scale is not None:
        return k_pages, v_pages, k_scale, v_scale
    return k_pages, v_pages


# ---------------------------------------------------------------------------
# Int8 KV quantization
# ---------------------------------------------------------------------------

#: The float32 reciprocal of 127 (``1.0f / 127.0f``), held exactly.
INV_127 = float(np.float32(1.0) / np.float32(127.0))


def int8_quantize(x: torch.Tensor, dim: int = -1
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-slice int8 quantization: returns (codes, scale).

    The scale is ``amax * INV_127``, a multiply by the float32 reciprocal
    of 127, on every device: that is what the reference computes where it
    runs, under ``jax.jit`` (XLA rewrites ``amax / 127.0`` as that
    multiply), and what the paged K/V write kernel computes.  An unjitted
    ``amax / 127.0`` can round the scale one bit away."""
    amax = x.abs().amax(dim=dim, keepdim=True)
    scale = torch.where(amax > 0, amax * INV_127, torch.ones_like(amax)).float()
    q = torch.round(x / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(token, kv-head) int8 quantization of new KV rows.

    ``x`` is ``(..., KVH, D)``; returns the int8 codes (same shape) and the
    fp32 scales ``(..., KVH)`` — the scale-pool layout.
    """
    q, scale = int8_quantize(x, dim=-1)
    return q, scale[..., 0]


def dequantize_pages(pages: torch.Tensor, scale: torch.Tensor,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``(..., page, KVH, D)`` int8 codes times their ``(..., page, KVH)``
    fp32 scales — the one broadcast rule the kernels apply after a load."""
    return (pages.float() * scale[..., None]).to(dtype)

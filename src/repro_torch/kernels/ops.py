"""Dispatch layer: the port's kernels behind one call each.

The functions keep the names and argument order of ``repro.kernels.ops``.
Each takes ``impl`` in ``{'cuda', 'ref'}``:

* ``'cuda'`` (default): a tensor on the GPU goes to the hand-written CUDA
  kernel of ``csrc/`` (built by :mod:`.build` at first use), and the call
  raises if the kernel cannot run; a tensor on the CPU goes to the kernel's
  plain PyTorch version in :mod:`.ref`.  There is no fallback from the
  kernel to the plain version.
* ``'ref'``: the plain version on any device — the oracle a run on the card
  is held against.

``paged_kv_append`` and ``paged_kv_write_chunk`` are composed over the two
indirect converter kernels, and ``recurrent_state_read`` /
``recurrent_state_write`` over the two strided ones, as in the reference.
The writes update the pools in place, where the JAX engine donates them;
the pools are returned all the same so the call sites of both packages
read alike.  ``paged_verify`` launches the prefill kernel with
``starts = lengths``; ``speculative_accept`` is plain integer tensor code
on any device, as in the reference, which has no kernel for it.

The paper's workloads run through ``tiled_transpose`` (ismt) and
``spmv_ell`` (spmv, pagerank); ``spmv_ell_panel_kernel`` is the panel-
streamed SpMV, which the reference calls directly since its ``ops`` has no
wrapper for it.  Unlike the reference's wrappers, these pad nothing: the
kernels mask the ragged edge of a tile or row block.

Each of the ten kernel wrappers counts its launches in an integer
attribute, ``launches``, raised by one only where the kernel is launched
(:func:`launch_counts`, :func:`reset_launch_counts`).  ``paged_verify``
counts under its own name, not the prefill kernel's.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Optional

import torch

from . import ref
from .build import library

__all__ = [
    "KERNELS",
    "indirect_gather",
    "indirect_scatter",
    "launch_counts",
    "paged_decode_attention",
    "paged_kv_append",
    "paged_kv_write_chunk",
    "paged_prefill_attention",
    "paged_verify",
    "recurrent_state_read",
    "recurrent_state_write",
    "reset_launch_counts",
    "speculative_accept",
    "spmv_ell",
    "spmv_ell_panel_kernel",
    "strided_gather",
    "strided_scatter",
    "tiled_transpose",
]

_IMPLS = ("cuda", "ref")


def _use_kernel(impl: str, x: torch.Tensor) -> bool:
    if impl not in _IMPLS:
        raise ValueError(f"impl must be one of {_IMPLS}, got {impl!r}")
    if impl == "ref" or x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for tensors on {x.device}")
    return True


# ---------------------------------------------------------------------------
# ctypes plumbing
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

_CONVERTER_ARGS = [_P] * 3 + [_L] * 3 + [_P]
_STRIDED_ARGS = [_P] * 2 + [_L] * 5 + [_P]
_SIGNATURES = {  # C entry: (library, argument types)
    "repro_indirect_gather": ("stream_converters", _CONVERTER_ARGS),
    "repro_indirect_scatter": ("stream_converters", _CONVERTER_ARGS),
    "repro_strided_gather": ("stream_converters", _STRIDED_ARGS),
    "repro_strided_scatter": ("stream_converters", _STRIDED_ARGS),
    "repro_paged_decode": ("paged_decode", [_P] * 8 + [_I] * 6 + [_F, _I, _P]),
    "repro_paged_prefill": ("paged_prefill",
                            [_P] * 9 + [_I] * 7 + [_F, _I, _P]),
    "repro_tiled_transpose": ("transpose", [_P] * 2 + [_L] * 2 + [_I, _P]),
    "repro_spmv_ell": ("spmv", [_P] * 4 + [_L] + [_I] * 2 + [_P]),
    "repro_spmv_ell_panel": ("spmv", [_P] * 5 + [_L] + [_I] * 5 + [_P]),
}


@functools.lru_cache(maxsize=None)
def _c_function(symbol: str):
    source, argtypes = _SIGNATURES[symbol]
    fn = getattr(library(source), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _launch(symbol: str, *args) -> None:
    """Call a C entry and raise on the ``cudaGetLastError()`` it returns."""
    err = _c_function(symbol)(*args)
    if err != 0:
        describe = library("stream_converters").repro_cuda_error_string
        describe.argtypes = [ctypes.c_int]
        describe.restype = ctypes.c_char_p
        raise RuntimeError(
            f"{symbol} failed: CUDA error {err} "
            f"({describe(err).decode()})"
        )


def _ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr() if t is not None else None)


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _int32(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    _check(t.device == device, f"index tensor on {t.device}, data on {device}")
    return t.to(torch.int32).contiguous()


def _counted(fn):
    fn.launches = 0
    return fn


def _row_bytes(t: torch.Tensor) -> int:
    return math.prod(t.shape[1:]) * t.element_size()


# ---------------------------------------------------------------------------
# Stream converters
# ---------------------------------------------------------------------------


@_counted
def strided_gather(src: torch.Tensor, base: int, stride: int, count: int,
                   impl: str = "cuda") -> torch.Tensor:
    """out[k] = src[base + k*stride] — packed strided read.

    ``src`` is ``(n_rows, *row)`` of any dtype; rows are copied as bytes.
    ``base``, ``stride`` and ``count`` are the whole descriptor: no index
    tensor exists.  Rows outside ``[0, n_rows)`` are clipped to the
    nearest row.
    """
    if not _use_kernel(impl, src):
        return ref.strided_gather(src, base, stride, count)
    _check(src.is_contiguous() and src.dim() >= 1 and src.shape[0] > 0,
           "strided_gather: src must be a contiguous non-empty tensor")
    _check(count >= 0, f"strided_gather: count {count} < 0")
    out = torch.empty((count,) + tuple(src.shape[1:]), dtype=src.dtype,
                      device=src.device)
    _launch("repro_strided_gather", _ptr(src), _ptr(out), src.shape[0],
            int(base), int(stride), count, _row_bytes(src), _stream(src))
    strided_gather.launches += 1
    return out


@_counted
def strided_scatter(dst: torch.Tensor, packed: torch.Tensor, base: int,
                    stride: int, impl: str = "cuda") -> torch.Tensor:
    """dst[base + k*stride] = packed[k] — packed strided write, in place.

    Returns ``dst``.  A row outside ``[0, len(dst))`` is dropped; rows
    that repeat (``stride == 0``) have no defined order.
    """
    if not _use_kernel(impl, dst):
        return ref.strided_scatter(dst, packed, base, stride)
    _check(dst.is_contiguous() and dst.dim() >= 1,
           "strided_scatter: dst must be contiguous (it is written in place)")
    _check(packed.device == dst.device and packed.dtype == dst.dtype
           and tuple(packed.shape[1:]) == tuple(dst.shape[1:]),
           f"strided_scatter: packed {tuple(packed.shape)} {packed.dtype} "
           f"does not match dst rows {tuple(dst.shape)} {dst.dtype}")
    packed = packed.contiguous()
    _launch("repro_strided_scatter", _ptr(dst), _ptr(packed), dst.shape[0],
            int(base), int(stride), packed.shape[0], _row_bytes(dst),
            _stream(dst))
    strided_scatter.launches += 1
    return dst


def _flat_state_view(pool: torch.Tensor, slot: int) -> torch.Tensor:
    """(L, B, *row) pool → its (L·B, row) view, after checking ``slot``."""
    _check(pool.dim() >= 2 and pool.is_contiguous(),
           f"state pool must be a contiguous (L, B, *row) tensor, got "
           f"{tuple(pool.shape)}")
    _check(0 <= slot < pool.shape[1],
           f"slot {slot} outside the pool's {pool.shape[1]} slots")
    return pool.view(pool.shape[0] * pool.shape[1], -1)


def recurrent_state_read(pool: torch.Tensor, slot: int,
                         impl: str = "cuda") -> torch.Tensor:
    """One sequence's state rows from an ``(L, B, *row)`` pool, ``(L, *row)``.

    Slot ``s`` of a layer-major pool is rows ``s, s+B, s+2B, ...`` of the
    flat ``(L·B, row)`` view: one strided burst with base = slot, stride =
    B, count = L, whatever the row's width or dtype.
    """
    if not _use_kernel(impl, pool):
        return ref.recurrent_state_read(pool, slot)
    l, b = pool.shape[:2]
    out = strided_gather(_flat_state_view(pool, slot), slot, b, l, impl=impl)
    return out.view((l,) + tuple(pool.shape[2:]))


def recurrent_state_write(pool: torch.Tensor, slot: int, value: torch.Tensor,
                          impl: str = "cuda") -> torch.Tensor:
    """Write one sequence's ``(L, *row)`` state rows into an ``(L, B, *row)``
    pool, in place, as one strided burst; returns ``pool``."""
    if not _use_kernel(impl, pool):
        return ref.recurrent_state_write(pool, slot, value)
    l, b = pool.shape[:2]
    _check(tuple(value.shape) == (l,) + tuple(pool.shape[2:]),
           f"state value {tuple(value.shape)} does not match pool rows "
           f"{tuple(pool.shape)}")
    flat = _flat_state_view(pool, slot)
    strided_scatter(flat, value.reshape(l, -1), slot, b, impl=impl)
    return pool


@_counted
def indirect_gather(src: torch.Tensor, indices: torch.Tensor,
                    impl: str = "cuda") -> torch.Tensor:
    """out[k] = src[indices[k]] — packed indirect read.

    ``src`` is ``(n_rows, *row)`` of any dtype; rows are copied as bytes.
    Indices are clipped to ``[0, n_rows)``.
    """
    if not _use_kernel(impl, src):
        return ref.indirect_gather(src, indices)
    _check(src.is_contiguous() and src.dim() >= 1 and src.shape[0] > 0,
           "indirect_gather: src must be a contiguous non-empty tensor")
    idx = _int32(indices, src.device)
    _check(idx.dim() == 1, "indirect_gather: indices must be 1-D")
    out = torch.empty((idx.shape[0],) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    _launch("repro_indirect_gather", _ptr(src), _ptr(idx), _ptr(out),
            src.shape[0], idx.shape[0], _row_bytes(src), _stream(src))
    indirect_gather.launches += 1
    return out


@_counted
def indirect_scatter(dst: torch.Tensor, packed: torch.Tensor,
                     indices: torch.Tensor, impl: str = "cuda"
                     ) -> torch.Tensor:
    """dst[indices[k]] = packed[k] — packed indirect write, in place.

    Returns ``dst``.  An index outside ``[0, len(dst))`` drops its row.
    Duplicate in-range indices have no defined order (the kernel's blocks
    race); the paged callers never repeat one.
    """
    if not _use_kernel(impl, dst):
        return ref.indirect_scatter(dst, packed, indices)
    _check(dst.is_contiguous() and dst.dim() >= 1,
           "indirect_scatter: dst must be contiguous (it is written in place)")
    _check(packed.device == dst.device and packed.dtype == dst.dtype
           and tuple(packed.shape[1:]) == tuple(dst.shape[1:]),
           f"indirect_scatter: packed {tuple(packed.shape)} {packed.dtype} "
           f"does not match dst rows {tuple(dst.shape)} {dst.dtype}")
    packed = packed.contiguous()
    idx = _int32(indices, dst.device)
    _check(idx.shape == (packed.shape[0],),
           "indirect_scatter: one index per packed row")
    _launch("repro_indirect_scatter", _ptr(dst), _ptr(packed), _ptr(idx),
            dst.shape[0], packed.shape[0], _row_bytes(dst), _stream(dst))
    indirect_scatter.launches += 1
    return dst


# ---------------------------------------------------------------------------
# Paged attention
# ---------------------------------------------------------------------------


def _check_pools(k_pages, v_pages, k_scale, v_scale, device) -> bool:
    """Validate the pool layout the attention kernels take; returns whether
    the pools are int8 codes with scales."""
    quantized = k_scale is not None
    want = torch.int8 if quantized else torch.float32
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        _check(t.device == device and t.dim() == 4 and t.is_contiguous()
               and t.dtype == want,
               f"{name} must be a contiguous (P, page, KVH, D) {want} pool "
               f"on {device}, got {tuple(t.shape)} {t.dtype} on {t.device}")
    if quantized:
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            _check(t is not None and t.device == device
                   and t.dtype == torch.float32 and t.is_contiguous()
                   and tuple(t.shape) == tuple(k_pages.shape[:3]),
                   f"{name} must be a contiguous (P, page, KVH) float32 pool")
    return quantized


@_counted
def paged_decode_attention(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    page_table: torch.Tensor,
    lengths: torch.Tensor,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    impl: str = "cuda",
) -> torch.Tensor:
    """Decode one token per sequence against the paged pool.

    q (B, H, D) float32; pools (P, page, KVH, D); page_table (B, n_pages);
    lengths (B,).  ``k_scale``/``v_scale`` — ``(P, page, KVH)`` fp32 — mark
    int8 pools; the kernel dequantizes each page after its load, the plain
    version the whole pool up front (:func:`ref.dequantize_pages`).
    """
    if not _use_kernel(impl, q):
        if k_scale is not None:
            k_pages = ref.dequantize_pages(k_pages, k_scale)
            v_pages = ref.dequantize_pages(v_pages, v_scale)
        return ref.paged_decode_attention(
            q, k_pages, v_pages, page_table, lengths, scale=scale
        )
    _check(q.dtype == torch.float32 and q.dim() == 3,
           f"q must be (B, H, D) float32, got {tuple(q.shape)} {q.dtype}")
    q = q.contiguous()
    b, h, d = q.shape
    quantized = _check_pools(k_pages, v_pages, k_scale, v_scale, q.device)
    _, page, kvh, dk = k_pages.shape
    _check(dk == d and h % kvh == 0,
           f"q heads {h} x {d} do not group over pool heads {kvh} x {dk}")
    table = _int32(page_table, q.device)
    lens = _int32(lengths, q.device)
    _check(table.dim() == 2 and table.shape[0] == b and lens.shape == (b,),
           "page_table must be (B, n_pages) and lengths (B,)")
    out = torch.empty_like(q)
    sc = scale if scale is not None else 1.0 / math.sqrt(d)
    _launch("repro_paged_decode", _ptr(q), _ptr(k_pages), _ptr(v_pages),
            _ptr(k_scale), _ptr(v_scale), _ptr(table), _ptr(lens), _ptr(out),
            b, h, kvh, d, page, table.shape[1], sc, int(quantized),
            _stream(q))
    paged_decode_attention.launches += 1
    return out


@_counted
def paged_prefill_attention(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    ctx_rows: torch.Tensor,
    starts: torch.Tensor,
    counts: torch.Tensor,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    impl: str = "cuda",
) -> torch.Tensor:
    """Causal chunk attention for batched prefill, straight from the pool.

    q (R, C, H, D) float32: row r's query c sits at ``starts[r] + c``;
    ctx_rows (R, ctx_pages) leading page-table entries; starts/counts (R,).
    Rows with ``counts == 0`` give zeros.  Scale pools as in
    :func:`paged_decode_attention`.
    """
    if not _use_kernel(impl, q):
        if k_scale is not None:
            k_pages = ref.dequantize_pages(k_pages, k_scale)
            v_pages = ref.dequantize_pages(v_pages, v_scale)
        return ref.paged_prefill_attention(
            q, k_pages, v_pages, ctx_rows, starts, counts, scale=scale
        )
    out = _prefill_kernel(q, k_pages, v_pages, ctx_rows, starts, counts,
                          k_scale, v_scale, scale)
    paged_prefill_attention.launches += 1
    return out


def _prefill_kernel(q, k_pages, v_pages, ctx_rows, starts, counts, k_scale,
                    v_scale, scale) -> torch.Tensor:
    """Check the arguments and launch ``paged_prefill.cu``; the caller
    counts the launch under its own name."""
    _check(q.dtype == torch.float32 and q.dim() == 4,
           f"q must be (R, C, H, D) float32, got {tuple(q.shape)} {q.dtype}")
    q = q.contiguous()
    r, c, h, d = q.shape
    quantized = _check_pools(k_pages, v_pages, k_scale, v_scale, q.device)
    _, page, kvh, dk = k_pages.shape
    _check(dk == d and h % kvh == 0,
           f"q heads {h} x {d} do not group over pool heads {kvh} x {dk}")
    rows = _int32(ctx_rows, q.device)
    st = _int32(starts, q.device)
    ct = _int32(counts, q.device)
    _check(rows.dim() == 2 and rows.shape[0] == r and st.shape == (r,)
           and ct.shape == (r,),
           "ctx_rows must be (R, ctx_pages) and starts/counts (R,)")
    out = torch.empty_like(q)
    sc = scale if scale is not None else 1.0 / math.sqrt(d)
    _launch("repro_paged_prefill", _ptr(q), _ptr(k_pages), _ptr(v_pages),
            _ptr(k_scale), _ptr(v_scale), _ptr(rows), _ptr(st), _ptr(ct),
            _ptr(out), r, c, h, kvh, d, page, rows.shape[1], sc,
            int(quantized), _stream(q))
    return out


@_counted
def paged_verify(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    ctx_rows: torch.Tensor,
    lengths: torch.Tensor,
    counts: torch.Tensor,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    impl: str = "cuda",
) -> torch.Tensor:
    """Score K speculative queries per sequence in one page walk.

    q (B, K, H, D) float32: query ``i`` of row ``b`` sits at
    ``lengths[b] + i`` (the feed token, then the drafts), its K/V already
    in the pool; ctx_rows (B, ctx_pages); lengths/counts (B,), counts 0..K
    (0 = padding row, zeros).  A verify chunk is a causal prefill chunk at
    the context tail, so this launches the prefill kernel with
    ``starts = lengths`` — the reference's ``paged_verify_attention_kernel``
    calls its prefill kernel the same way — and counts the launch here.
    """
    if not _use_kernel(impl, q):
        if k_scale is not None:
            k_pages = ref.dequantize_pages(k_pages, k_scale)
            v_pages = ref.dequantize_pages(v_pages, v_scale)
        return ref.paged_verify_attention(
            q, k_pages, v_pages, ctx_rows, lengths, counts, scale=scale
        )
    out = _prefill_kernel(q, k_pages, v_pages, ctx_rows, lengths, counts,
                          k_scale, v_scale, scale)
    paged_verify.launches += 1
    return out


def speculative_accept(drafts: torch.Tensor, greedy: torch.Tensor,
                       counts: torch.Tensor) -> torch.Tensor:
    """Greedy first-mismatch acceptance: how many verify tokens each row
    emits (see :func:`ref.speculative_accept`).  O(B·K) integer ops on the
    tensors' device with no host read-back; no kernel, as in the
    reference."""
    return ref.speculative_accept(drafts, greedy, counts)


# ---------------------------------------------------------------------------
# Paged KV writes, composed over the converters
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
    impl: str = "cuda",
):
    """Append one KV token per sequence into the paged pool, in place.

    ``impl='cuda'`` is one indirect scatter per pool over the row-flattened
    pool; ``impl='ref'`` the full-pool oracle.  Inactive sequences, and
    appends past the table row, are routed to an out-of-range index and
    dropped.  With the ``(P, page, KVH)`` scale pools given the rows are
    quantized on write, codes and scales through the same indices.

    Returns ``(k_pages, v_pages, new_lengths)``, plus ``(k_scale,
    v_scale)`` when quantizing.
    """
    if impl == "ref":
        return ref.paged_kv_append(
            k_pages, v_pages, k_new, v_new, page_table, lengths, active,
            k_scale=k_scale, v_scale=v_scale,
        )
    p, page, kvh, d = k_pages.shape
    n_pages = page_table.shape[1]
    quantized = k_scale is not None
    if quantized:
        k_new, k_s = ref.quantize_kv(k_new)
        v_new, v_s = ref.quantize_kv(v_new)
    lens = lengths.long()
    if active is None:
        active = torch.ones_like(lens, dtype=torch.bool)
    slot = (lens // page).clamp(0, n_pages - 1)
    pids = page_table.long().gather(1, slot[:, None])[:, 0]
    flat_idx = torch.where(
        active & (lens < n_pages * page), pids * page + lens % page,
        torch.full_like(pids, p * page),
    )

    def write(pool, new, width):
        indirect_scatter(pool.view(p * page, width), new.reshape(-1, width),
                         flat_idx, impl=impl)

    write(k_pages, k_new, kvh * d)
    write(v_pages, v_new, kvh * d)
    new_len = lengths + active.to(lengths.dtype)
    if quantized:
        write(k_scale, k_s, kvh)
        write(v_scale, v_s, kvh)
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
    impl: str = "cuda",
):
    """Batched chunked-prefill write, bounded by the pages the chunk touches.

    ``impl='ref'`` is the full-pool oracle.  ``impl='cuda'`` follows the
    reference's converter path: each sequence's chunk spans at most
    ``W = ceil(C/page) + 1`` pages, so it gathers those W pages (one
    indirect read), scatters the chunk's rows into the gathered window, and
    writes the touched pages back (one indirect write) — R·W pages of
    traffic, never the whole pool.  Window slots that cover no valid token
    are routed out of range on the way back, so a stale copy never
    clobbers another sequence's page.  With scale pools the chunk is
    quantized on write and the scales take the same window walk.

    Returns ``(k_pages, v_pages)``, plus ``(k_scale, v_scale)`` when
    quantizing; all are updated in place.
    """
    if impl == "ref":
        return ref.paged_kv_write_chunk(
            k_pages, v_pages, k_new, v_new, rows, starts, counts,
            k_scale=k_scale, v_scale=v_scale,
        )
    p, page, kvh, d = k_pages.shape
    r, c = k_new.shape[:2]
    n_pages = rows.shape[1]
    quantized = k_scale is not None
    if quantized:
        k_new, k_s = ref.quantize_kv(k_new)
        v_new, v_s = ref.quantize_kv(v_new)
    dev = rows.device
    st = starts.long()
    ct = counts.long()
    w = -(-c // page) + 1
    p_lo = st // page                                              # (R,)
    lp = p_lo[:, None] + torch.arange(w, device=dev)               # (R, W)
    pids = rows.long().gather(1, lp.clamp(0, n_pages - 1))         # (R, W)
    # A window slot is real iff it covers >= 1 valid token of its sequence.
    p_hi = (st + (ct - 1).clamp(min=0)) // page
    real = (lp <= p_hi[:, None]) & (ct[:, None] > 0) & (lp < n_pages)
    back = torch.where(real, pids, torch.full_like(pids, p)).reshape(-1)
    # Local scatter index of token (r, c) inside the (R, W, page) window.
    ar = torch.arange(c, device=dev)
    pos = st[:, None] + ar                                         # (R, C)
    valid = ar[None, :] < ct[:, None]
    wp = pos // page - p_lo[:, None]
    loc = (torch.arange(r, device=dev)[:, None] * w + wp) * page + pos % page
    loc = torch.where(valid, loc, torch.full_like(loc, r * w * page))
    loc = loc.reshape(-1)
    src = pids.clamp(0, p - 1).reshape(-1)

    def write(pool, new, width):
        flat = pool.view(p, page * width)
        win = indirect_gather(flat, src, impl=impl)                # (R*W, ..)
        indirect_scatter(win.view(r * w * page, width),
                         new.reshape(-1, width), loc, impl=impl)
        indirect_scatter(flat, win, back, impl=impl)

    write(k_pages, k_new, kvh * d)
    write(v_pages, v_new, kvh * d)
    if quantized:
        write(k_scale, k_s, kvh)
        write(v_scale, v_s, kvh)
        return k_pages, v_pages, k_scale, v_scale
    return k_pages, v_pages


# ---------------------------------------------------------------------------
# Workload kernels: tiled transpose and ELL SpMV
# ---------------------------------------------------------------------------

_INT32_MAX = 2**31 - 1


@_counted
def tiled_transpose(x: torch.Tensor, block: int = 128,
                    impl: str = "cuda") -> torch.Tensor:
    """``x.T`` of a 2-D tensor, as a new contiguous ``(c, r)`` tensor.

    The kernel moves elements of 1, 2, 4 or 8 bytes as raw bits, so the
    result is bitwise for every dtype it takes.  ``block`` is the
    reference's tile; the kernel's tile is fixed by shared memory (32 x 32)
    and masks the ragged edge, so ``block`` only has to be positive.
    """
    _check(block > 0, f"tiled_transpose: block {block} <= 0")
    if not _use_kernel(impl, x):
        return ref.tiled_transpose(x)
    _check(x.dim() == 2, f"tiled_transpose: x must be 2-D, got "
           f"{tuple(x.shape)}")
    _check(x.element_size() in (1, 2, 4, 8),
           f"tiled_transpose: no kernel for {x.element_size()}-byte "
           f"elements ({x.dtype})")
    x = x.contiguous()
    r, c = x.shape
    out = torch.empty((c, r), dtype=x.dtype, device=x.device)
    _launch("repro_tiled_transpose", _ptr(x), _ptr(out), r, c,
            x.element_size(), _stream(x))
    tiled_transpose.launches += 1
    return out


def _check_ell(vals: torch.Tensor, cols: torch.Tensor, x: torch.Tensor,
               name: str):
    """The ELL operands as the kernels take them: contiguous fp32 values
    and x, int32 columns of the same (R, K) shape, on x's device."""
    _check(vals.dtype == torch.float32 and x.dtype == torch.float32,
           f"{name}: the kernel takes float32 vals and x, got {vals.dtype} "
           f"and {x.dtype}")
    _check(vals.dim() == 2 and tuple(cols.shape) == tuple(vals.shape)
           and x.dim() == 1,
           f"{name}: vals and cols must be (R, K) and x (C,), got "
           f"{tuple(vals.shape)}, {tuple(cols.shape)}, {tuple(x.shape)}")
    _check(vals.device == x.device, f"{name}: vals on {vals.device}, x on "
           f"{x.device}")
    _check(0 < x.shape[0] <= _INT32_MAX and vals.shape[1] <= _INT32_MAX,
           f"{name}: C = {x.shape[0]} and K = {vals.shape[1]} must lie in "
           f"[1, 2**31 - 1]")
    return vals.contiguous(), _int32(cols, x.device), x.contiguous()


@_counted
def spmv_ell(vals: torch.Tensor, cols: torch.Tensor, x: torch.Tensor,
             row_block: int = 8, impl: str = "cuda") -> torch.Tensor:
    """y = A @ x with A as padded ELL ``vals``/``cols`` ``(R, K)``, x
    ``(C,)`` float32; columns are clamped to ``[0, C-1]``.

    ``row_block`` is the reference's rows per grid step; the kernel sizes
    its thread groups to K and masks rows past R, so any R works and
    ``row_block`` only has to be positive.
    """
    _check(row_block > 0, f"spmv_ell: row_block {row_block} <= 0")
    if not _use_kernel(impl, x):
        return ref.spmv_ell(vals, cols, x)
    vals, cols, x = _check_ell(vals, cols, x, "spmv_ell")
    r, k = vals.shape
    y = torch.empty(r, dtype=torch.float32, device=x.device)
    _launch("repro_spmv_ell", _ptr(vals), _ptr(cols), _ptr(x), _ptr(y), r, k,
            x.shape[0], _stream(x))
    spmv_ell.launches += 1
    return y


@_counted
def spmv_ell_panel_kernel(vals: torch.Tensor, cols: torch.Tensor,
                          x: torch.Tensor, panel_ids: torch.Tensor,
                          panel: int = 512, impl: str = "cuda"
                          ) -> torch.Tensor:
    """Panel-streamed SpMV: x arrives one ``panel``-wide slice per step.

    ``panel_ids`` ``(row_blocks, steps)`` names the x panel each step of
    each row block needs (the indirect stream descriptor driving the x
    copies).  Step ``s`` covers columns ``s*K/steps ..`` of the block's
    rows; an entry outside its step's panel is masked.  Raises where the
    reference asserts or cannot tile: ``R % row_blocks``, ``K % steps``,
    ``C % panel``.
    """
    r, k = vals.shape
    _check(panel_ids.dim() == 2, "spmv_ell_panel_kernel: panel_ids must be "
           "(row_blocks, steps)")
    row_blocks, steps = panel_ids.shape
    _check(row_blocks > 0 and r % row_blocks == 0,
           f"spmv_ell_panel_kernel: R = {r} is not a multiple of "
           f"{row_blocks} row blocks")
    _check(steps > 0 and k % steps == 0,
           f"spmv_ell_panel_kernel: K = {k} is not a multiple of {steps} "
           f"steps")
    _check(panel > 0 and x.shape[0] % panel == 0,
           f"spmv_ell_panel_kernel: C = {x.shape[0]} is not a multiple of "
           f"the panel {panel}")
    if not _use_kernel(impl, x):
        return ref.spmv_ell_panel(vals, cols, x, panel_ids, panel)
    vals, cols, x = _check_ell(vals, cols, x, "spmv_ell_panel_kernel")
    pids = _int32(panel_ids, x.device)
    row_block = r // row_blocks
    smem = (2 * panel + row_block) * 4
    _check(smem <= 232448, f"spmv_ell_panel_kernel: two panels of {panel} "
           f"and {row_block} row sums need {smem} bytes of shared memory, "
           f"more than a block's 232448")
    y = torch.empty(r, dtype=torch.float32, device=x.device)
    _launch("repro_spmv_ell_panel", _ptr(vals), _ptr(cols), _ptr(x),
            _ptr(pids), _ptr(y), row_blocks, row_block, k, steps, panel,
            x.shape[0], _stream(x))
    spmv_ell_panel_kernel.launches += 1
    return y


# ---------------------------------------------------------------------------
# Launch counts
# ---------------------------------------------------------------------------

#: The ten kernel wrappers, each with its ``launches`` count.
KERNELS = (indirect_gather, indirect_scatter, paged_decode_attention,
           paged_prefill_attention, paged_verify, strided_gather,
           strided_scatter, tiled_transpose, spmv_ell, spmv_ell_panel_kernel)


def launch_counts() -> Dict[str, int]:
    """``{kernel wrapper name: launches}`` since the last reset."""
    return {fn.__name__: fn.launches for fn in KERNELS}


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0

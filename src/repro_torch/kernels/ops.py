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

``paged_kv_append`` and ``paged_kv_write_chunk`` launch the paged K/V
write kernel (``paged_kv_write``: every valid token into its page, K and V,
codes and scales, one launch a layer), where the reference composes them
over the indirect converters; ``recurrent_state_read`` /
``recurrent_state_write`` are composed over the two strided converters, as
in the reference.  The writes update the pools in place, where the JAX
engine donates them;
the pools are returned all the same so the call sites of both packages
read alike.  ``paged_verify`` launches the prefill kernel with
``starts = lengths``; ``speculative_accept`` is plain integer tensor code
on any device, as in the reference, which has no kernel for it.

Training attention runs through ``flash_attention``, one
``torch.autograd.Function`` on every device: with no gradient to take it
launches the forward kernel (``flash_attention`` counts it); under autograd
its forward launches the forward-with-lse kernel (``flash_attention_fwd``)
and its backward the two backward passes (``flash_attention_bwd``, one
count per backward call).  On a CPU tensor the same Function runs the
plain versions.

MoE token routing runs through ``moe_dispatch`` and ``moe_combine``, as
in the reference composites over the indirect converters: integer slot
arithmetic in tensor code, each data movement one ``indirect_scatter`` or
``indirect_gather`` inside a ``torch.autograd.Function`` whose backward
is the other converter (kernels on the card, plain versions on the CPU).

The paper's workloads run through ``tiled_transpose`` (ismt) and
``spmv_ell`` (spmv, pagerank); ``spmv_ell_panel_kernel`` is the panel-
streamed SpMV, which the reference calls directly since its ``ops`` has no
wrapper for it.  Unlike the reference's wrappers, these pad nothing: the
kernels mask the ragged edge of a tile or row block.

Each of the fourteen kernel wrappers counts its launches in an integer
attribute, ``launches``, raised by one only where the kernel is launched
(:func:`launch_counts`, :func:`reset_launch_counts`).  ``paged_verify``
counts under its own name, not the prefill kernel's.

``indirect_gather``, ``spmv_ell``, ``spmv_ell_panel_kernel`` and the three
paged attention wrappers launch by a plan chosen on the host
(:mod:`.plans`) from the shapes and the pointers' alignment (the gather's
copy unit, the SpMV's lanes a row and load width, the panel SpMV's route
and tiling, the attention kernels' spans, tiles and shared memory); each
keeps its last plan as ``.plan``.  The attention wrappers also allocate the
plan's scratch for the span partials; their C entries launch the span
blocks and then the combine, one count a call.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Optional

import torch

from . import ref
from .build import library
from .plans import attention_plan, gather_plan, panel_plan, spmv_plan

__all__ = [
    "KERNELS",
    "flash_attention",
    "flash_attention_bwd",
    "flash_attention_fwd",
    "indirect_gather",
    "indirect_scatter",
    "launch_counts",
    "moe_combine",
    "moe_dispatch",
    "paged_decode_attention",
    "paged_kv_append",
    "paged_kv_write",
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
# n pointers (the last one the strides array), then B, H, KVH, Sq, Skv, D,
# causal, has_window, window, scale, bf16, stream.
_FLASH_TAIL = lambda n: [_P] * n + [_I] * 9 + [_F, _I, _P]
_STRIDED_ARGS = [_P] * 2 + [_L] * 5 + [_P]
_SIGNATURES = {  # C entry: (library, argument types)
    # ... n_rows, count, row_bytes, then the plan: unit, slab, slabs,
    # grid_y, threads.
    "repro_indirect_gather": ("stream_converters",
                              [_P] * 3 + [_L] * 3 + [_I] * 5 + [_P]),
    "repro_indirect_scatter": ("stream_converters", _CONVERTER_ARGS),
    "repro_strided_gather": ("stream_converters", _STRIDED_ARGS),
    "repro_strided_scatter": ("stream_converters", _STRIDED_ARGS),
    # k_new, v_new, the four pools, table, starts, counts; rows, chunk,
    # n_pages, pool_pages, page, kvh, d, elem bytes (4, 2, 1), vec.
    "repro_paged_kv_write": ("stream_converters",
                             [_P] * 9 + [_L] + [_I] * 8 + [_P]),
    # ... out, scratch, shape ints, scale, elem bytes, then the plan (an
    # int array in the order of plans.ATTENTION_FIELDS) and the stream.
    "repro_paged_decode": ("paged_decode",
                           [_P] * 9 + [_I] * 6 + [_F, _I, _P, _P]),
    "repro_paged_prefill": ("paged_prefill",
                            [_P] * 10 + [_I] * 7 + [_F, _I, _P, _P]),
    "repro_tiled_transpose": ("transpose", [_P] * 2 + [_L] * 2 + [_I, _P]),
    # ... r, k, c, then the plan: vec, lanes, threads, blocks.
    "repro_spmv_ell": ("spmv", [_P] * 4 + [_L] + [_I] * 5 + [_L, _P]),
    # ... row_blocks, row_block, k, steps, panel, c, then the plan: route,
    # tile rows, pack, split, blocks, panels / vals / part bytes, smem.
    "repro_spmv_ell_panel": ("spmv", [_P] * 5 + [_L] + [_I] * 14 + [_P]),
    "repro_flash_attention": ("flash_attention", _FLASH_TAIL(5)),
    "repro_flash_attention_lse": ("flash_attention", _FLASH_TAIL(6)),
    "repro_flash_attention_bwd_dkv": ("flash_attention", _FLASH_TAIL(11)),
    "repro_flash_attention_bwd_dq": ("flash_attention", _FLASH_TAIL(8)),
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
    """``t`` as a contiguous int32 tensor: itself, with no conversion
    call, where it already is one (the paged steps are host-bound)."""
    _check(t.device == device, f"index tensor on {t.device}, data on {device}")
    if t.dtype == torch.int32 and t.is_contiguous():
        return t
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
    Indices are clipped to ``[0, n_rows)``.  On the card the launch follows
    :func:`.plans.gather_plan` (kept as ``indirect_gather.plan``).
    """
    if not _use_kernel(impl, src):
        return ref.indirect_gather(src, indices)
    _check(src.is_contiguous() and src.dim() >= 1 and src.shape[0] > 0,
           "indirect_gather: src must be a contiguous non-empty tensor")
    idx = _int32(indices, src.device)
    _check(idx.dim() == 1, "indirect_gather: indices must be 1-D")
    out = torch.empty((idx.shape[0],) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    plan = gather_plan(_row_bytes(src), src.data_ptr() | out.data_ptr(),
                       idx.shape[0])
    _gather_launch(src, idx, out, plan)
    indirect_gather.plan = plan
    indirect_gather.launches += 1
    return out


indirect_gather.plan = None  # the plan of the last launch


def _gather_launch(src, idx, out, plan) -> None:
    """Launch the gather kernel by ``plan`` (a :class:`.plans.GatherPlan`
    for these rows and pointers)."""
    _launch("repro_indirect_gather", _ptr(src), _ptr(idx), _ptr(out),
            src.shape[0], idx.shape[0], _row_bytes(src), plan.unit,
            plan.slab_bytes, plan.slabs, plan.grid_y, plan.threads,
            _stream(src))


@_counted
def indirect_scatter(dst: torch.Tensor, packed: torch.Tensor,
                     indices: torch.Tensor, impl: str = "cuda"
                     ) -> torch.Tensor:
    """dst[indices[k]] = packed[k] — packed indirect write, in place.

    Returns ``dst``.  An index outside ``[0, len(dst))`` drops its row.
    Duplicate in-range indices have no defined order (the kernel's blocks
    race).
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
# MoE dispatch / combine (composite over the indirect converters)
# ---------------------------------------------------------------------------


class _MoeDispatch(torch.autograd.Function):
    """``buf[slot[a]] = tokens[a // K]`` into a zeroed ``(E·C, D)`` buffer:
    one :func:`indirect_scatter` of the T·K token rows, a dropped
    assignment's sentinel ``slot = E·C`` falling outside and so dropped.
    The backward is one :func:`indirect_gather` of the buffer's gradient
    at ``slot``: the gather clips the sentinel to the live row ``E·C - 1``,
    so the dropped rows are zeroed before each token sums its K rows over
    an axis, in a fixed order and with no atomics."""

    @staticmethod
    def forward(ctx, tokens, slot, n_slots, k):
        t, d = tokens.shape
        rows = tokens.unsqueeze(1).expand(t, k, d).reshape(t * k, d)
        buf = tokens.new_zeros((n_slots, d))
        indirect_scatter(buf, rows, slot)
        ctx.save_for_backward(slot)
        ctx.n_slots, ctx.k = n_slots, k
        return buf

    @staticmethod
    def backward(ctx, g):
        (slot,) = ctx.saved_tensors
        rows = indirect_gather(g.contiguous(), slot)
        rows = rows.view(-1, ctx.k, rows.shape[-1])
        rows.masked_fill_((slot >= ctx.n_slots).view(-1, ctx.k, 1), 0)
        return rows.sum(dim=1), None, None, None


class _MoeCombine(torch.autograd.Function):
    """``rows[a] = outputs[inv[a]]``: one :func:`indirect_gather` of the
    ``(E·C, D)`` expert outputs into ``(T·K, D)``; a dropped assignment
    (``inv = E·C``, which the gather clips to a live row) is zeroed.  The
    backward is one :func:`indirect_scatter` of the row gradients to their
    buffer rows, into zeros: the unclipped sentinel drops a dropped row's
    gradient, and empty slots keep zero."""

    @staticmethod
    def forward(ctx, outputs, inv):
        rows = indirect_gather(outputs.contiguous(), inv)
        rows.masked_fill_((inv >= outputs.shape[0])[:, None], 0)
        ctx.save_for_backward(inv)
        ctx.n_slots = outputs.shape[0]
        return rows

    @staticmethod
    def backward(ctx, g):
        (inv,) = ctx.saved_tensors
        grad = g.new_zeros((ctx.n_slots, g.shape[-1]))
        indirect_scatter(grad, g.contiguous(), inv)
        return grad, None


def moe_dispatch(tokens: torch.Tensor, expert_idx: torch.Tensor,
                 num_experts: int, capacity: int, impl: str = "cuda"):
    """Pack tokens into (E, C, D) expert buffers by an indirect stream;
    returns ``(buffers, src (E, C) int32, keep (T, K) bool)``, as
    ``ref.moe_dispatch``.

    The slot arithmetic (each assignment's rank within its expert) is
    integer tensor code (``ref.moe_slots``); the data movement is one
    indirect scatter of the T·K token rows, and the gradient one indirect
    gather (``_MoeDispatch``): the kernels for tensors on the card, their
    plain versions on the CPU.  ``impl='ref'`` runs the oracle.
    """
    if impl not in _IMPLS:
        raise ValueError(f"impl must be one of {_IMPLS}, got {impl!r}")
    if impl == "ref":
        return ref.moe_dispatch(tokens, expert_idx, num_experts, capacity)
    t, d = tokens.shape
    k = expert_idx.shape[1]
    slot, keep, src = ref.moe_slots(expert_idx, num_experts, capacity)
    buf = _MoeDispatch.apply(tokens, _int32(slot, tokens.device),
                             num_experts * capacity, k)
    return (buf.view(num_experts, capacity, d),
            src.view(num_experts, capacity), keep.view(t, k))


def moe_combine(outputs: torch.Tensor, src_index: torch.Tensor,
                gate_weights: torch.Tensor, num_tokens: int,
                impl: str = "cuda") -> torch.Tensor:
    """Un-pack (E, C, D) expert outputs to token order and weight them by
    the gates: ``(T, D)``, as ``ref.moe_combine``.

    The dispatch permutation is inverted in integer tensor code (each
    assignment's buffer row, ``E·C`` where it was dropped); the rows
    come back by one indirect gather, and the gradient goes by one
    indirect scatter (``_MoeCombine``); then ``einsum('tkd,tk->td')`` with
    the gates in the outputs' dtype.  ``impl='ref'`` runs the oracle.
    """
    if impl not in _IMPLS:
        raise ValueError(f"impl must be one of {_IMPLS}, got {impl!r}")
    if impl == "ref":
        return ref.moe_combine(outputs, src_index, gate_weights, num_tokens)
    e, c, d = outputs.shape
    k = gate_weights.shape[1]
    flat_src = src_index.reshape(e * c).long()
    n_assign = num_tokens * k
    inv = torch.full((n_assign + 1,), e * c, dtype=torch.int32,
                     device=outputs.device)
    inv = inv.scatter(0, torch.where(flat_src >= 0, flat_src, n_assign),
                      torch.arange(e * c, dtype=torch.int32,
                                   device=outputs.device))[:-1]
    rows = _MoeCombine.apply(outputs.reshape(e * c, d), inv)
    return torch.einsum("tkd,tk->td", rows.view(num_tokens, k, d),
                        gate_weights.to(outputs.dtype))


# ---------------------------------------------------------------------------
# Paged attention
# ---------------------------------------------------------------------------


#: Pool dtype → the element bytes the paged kernels' C entries take.
_POOL_ELEM_BYTES = {torch.float32: 4, torch.bfloat16: 2, torch.int8: 1}


def _check_pools(k_pages, v_pages, k_scale, v_scale, device) -> int:
    """Validate the pool layout the paged kernels take; returns the pools'
    element bytes: 4 (fp32) or 2 (bf16) without scales, 1 (int8 codes)
    with their fp32 scale pools.  Anything else raises."""
    quantized = k_scale is not None
    want = ((torch.int8,) if quantized
            else (torch.float32, torch.bfloat16))
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        _check(t.device == device and t.dim() == 4 and t.is_contiguous()
               and t.dtype in want and t.dtype == k_pages.dtype,
               f"{name} must be a contiguous (P, page, KVH, D) pool on "
               f"{device} of k_pages' dtype, one of {list(want)} "
               f"{'with' if quantized else 'without'} scale pools; got "
               f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if quantized:
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            _check(t is not None and t.device == device
                   and t.dtype == torch.float32 and t.is_contiguous()
                   and tuple(t.shape) == tuple(k_pages.shape[:3]),
                   f"{name} must be a contiguous (P, page, KVH) float32 pool")
    return _POOL_ELEM_BYTES[k_pages.dtype]


def _attention_plan(kind, rows, chunk, h, kvh, d, page, table_pages,
                    elem_bytes, *tensors):
    """:func:`.plans.attention_plan` for a launch over ``tensors`` (q and
    the pools), whose base addresses bound the copy unit."""
    align = 0
    for t in tensors:
        align |= t.data_ptr()
    align = 16 if align % 16 == 0 else (4 if align % 4 == 0 else 1)
    return attention_plan(kind, rows, chunk, h, kvh, d, page, table_pages,
                          elem_bytes, align)


@functools.lru_cache(maxsize=1024)
def _plan_array(plan) -> ctypes.Array:
    fields = plan.launch_fields()
    return (ctypes.c_int * len(fields))(*fields)


def _softmax_scale(scale: Optional[float], d: int) -> float:
    return scale if scale is not None else 1.0 / math.sqrt(d)


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

    q (B, H, D) float32; pools (P, page, KVH, D) fp32 or bf16, or int8
    codes with ``k_scale``/``v_scale`` — ``(P, page, KVH)`` fp32; page_table
    (B, n_pages); lengths (B,).  The kernel widens each bf16 row to fp32
    after its load and dequantizes each int8 row; the plain version widens
    the gathered rows and dequantizes the whole pool up front
    (:func:`ref.dequantize_pages`).
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
    elem = _check_pools(k_pages, v_pages, k_scale, v_scale, q.device)
    _, page, kvh, dk = k_pages.shape
    _check(dk == d and h % kvh == 0,
           f"q heads {h} x {d} do not group over pool heads {kvh} x {dk}")
    table = _int32(page_table, q.device)
    lens = _int32(lengths, q.device)
    _check(table.dim() == 2 and table.shape[0] == b and lens.shape == (b,),
           "page_table must be (B, n_pages) and lengths (B,)")
    out = torch.empty_like(q)
    plan = _attention_plan("decode", b, 1, h, kvh, d, page, table.shape[1],
                           elem, q, k_pages, v_pages)
    scratch = torch.empty(plan.scratch_floats, dtype=torch.float32,
                          device=q.device)
    _launch("repro_paged_decode", _ptr(q), _ptr(k_pages), _ptr(v_pages),
            _ptr(k_scale), _ptr(v_scale), _ptr(table), _ptr(lens), _ptr(out),
            _ptr(scratch), b, h, kvh, d, page, table.shape[1],
            _softmax_scale(scale, d), elem, _plan_array(plan), _stream(q))
    paged_decode_attention.plan = plan
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.plan = None  # the plan of the last launch


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
    out, paged_prefill_attention.plan = _prefill_kernel(
        q, k_pages, v_pages, ctx_rows, starts, counts, k_scale, v_scale,
        scale)
    paged_prefill_attention.launches += 1
    return out


paged_prefill_attention.plan = None  # the plan of the last launch


def _prefill_kernel(q, k_pages, v_pages, ctx_rows, starts, counts, k_scale,
                    v_scale, scale):
    """Check the arguments and launch ``paged_prefill.cu``; returns the
    output and the plan.  The caller counts the launch under its own name
    and keeps the plan."""
    _check(q.dtype == torch.float32 and q.dim() == 4,
           f"q must be (R, C, H, D) float32, got {tuple(q.shape)} {q.dtype}")
    q = q.contiguous()
    r, c, h, d = q.shape
    elem = _check_pools(k_pages, v_pages, k_scale, v_scale, q.device)
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
    plan = _attention_plan("prefill", r, c, h, kvh, d, page, rows.shape[1],
                           elem, q, k_pages, v_pages)
    scratch = torch.empty(plan.scratch_floats, dtype=torch.float32,
                          device=q.device)
    _launch("repro_paged_prefill", _ptr(q), _ptr(k_pages), _ptr(v_pages),
            _ptr(k_scale), _ptr(v_scale), _ptr(rows), _ptr(st), _ptr(ct),
            _ptr(out), _ptr(scratch), r, c, h, kvh, d, page, rows.shape[1],
            _softmax_scale(scale, d), elem, _plan_array(plan), _stream(q))
    return out, plan


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
    out, paged_verify.plan = _prefill_kernel(
        q, k_pages, v_pages, ctx_rows, lengths, counts, k_scale, v_scale,
        scale)
    paged_verify.launches += 1
    return out


paged_verify.plan = None  # the plan of the last launch


def speculative_accept(drafts: torch.Tensor, greedy: torch.Tensor,
                       counts: torch.Tensor) -> torch.Tensor:
    """Greedy first-mismatch acceptance: how many verify tokens each row
    emits (see :func:`ref.speculative_accept`).  O(B·K) integer ops on the
    tensors' device with no host read-back; no kernel, as in the
    reference."""
    return ref.speculative_accept(drafts, greedy, counts)


# ---------------------------------------------------------------------------
# Paged KV writes: one kernel launch a layer
# ---------------------------------------------------------------------------


@_counted
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
    impl: str = "cuda",
):
    """Write every valid token of ``k_new`` / ``v_new`` ``(R, C, KVH, D)``
    fp32 straight into its page, in place: K and V in one launch, stored
    as the pools' elements (fp32; bf16 rounded to nearest even; int8 codes
    and scales with the scale pools given).

    Token ``(r, c)`` lands at position ``starts[r] + c`` through table row
    ``rows[r]``; it is dropped where ``c >= counts[r]``, the position lies
    outside the table row or its page id outside ``[0, P)``
    (:func:`ref.paged_kv_destinations`).  Repeated destinations have no
    defined order.  :func:`paged_kv_append` and :func:`paged_kv_write_chunk`
    run this kernel on the card.  Returns ``(k_pages, v_pages)``, plus
    ``(k_scale, v_scale)`` when quantizing.
    """
    if not _use_kernel(impl, k_pages):
        return ref.paged_kv_write(k_pages, v_pages, k_new, v_new, rows,
                                  starts, counts, k_scale, v_scale)
    dev = k_pages.device
    elem = _check_pools(k_pages, v_pages, k_scale, v_scale, dev)
    p, page, kvh, d = k_pages.shape
    r, c = k_new.shape[:2]
    for name, t in (("k_new", k_new), ("v_new", v_new)):
        _check(t.device == dev and t.dtype == torch.float32
               and t.is_contiguous() and t.shape == (r, c, kvh, d),
               f"paged_kv_write: {name} must be contiguous float32 "
               f"({r}, {c}, {kvh}, {d}) on {dev}, got {tuple(t.shape)} "
               f"{t.dtype} on {t.device}")
    table, starts, counts = (_int32(t, dev) for t in (rows, starts, counts))
    _check(table.dim() == 2 and table.shape[0] == r
           and starts.shape == (r,) and counts.shape == (r,),
           f"paged_kv_write: the table must be ({r}, n_pages) and "
           f"starts / counts ({r},), got {tuple(table.shape)}, "
           f"{tuple(starts.shape)}, {tuple(counts.shape)}")
    align = (k_new.data_ptr() | v_new.data_ptr() | k_pages.data_ptr()
             | v_pages.data_ptr())
    vec = 4 if d % 4 == 0 and align % 16 == 0 else 1
    _launch("repro_paged_kv_write", _ptr(k_new), _ptr(v_new), _ptr(k_pages),
            _ptr(v_pages), _ptr(k_scale), _ptr(v_scale), _ptr(table),
            _ptr(starts), _ptr(counts), r, c, table.shape[1], p, page, kvh,
            d, elem, vec, _stream(k_pages))
    paged_kv_write.launches += 1
    if k_scale is not None:
        return k_pages, v_pages, k_scale, v_scale
    return k_pages, v_pages


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

    ``impl='cuda'`` is one launch of the paged K/V write kernel
    (:func:`paged_kv_write` with ``C = 1``, ``lengths`` as the starts and
    ``active`` as the counts); ``impl='ref'`` the full-pool oracle.  The
    serving step launches :func:`paged_kv_write` itself and makes the new
    lengths once a step.  Inactive sequences (``active`` bool, or 0/1
    ints), appends past the table row and page ids outside ``[0, P)``
    write nothing.  With the ``(P, page, KVH)`` scale pools given the rows
    are quantized on write, codes and scales at the same slots.

    Returns ``(k_pages, v_pages, new_lengths)``, plus ``(k_scale,
    v_scale)`` when quantizing.
    """
    if impl == "ref":
        return ref.paged_kv_append(
            k_pages, v_pages, k_new, v_new, page_table, lengths, active,
            k_scale=k_scale, v_scale=v_scale,
        )
    if active is None:
        active = torch.ones_like(lengths, dtype=torch.int32)
    paged_kv_write(k_pages, v_pages, k_new[:, None], v_new[:, None],
                   page_table, lengths, active, k_scale, v_scale, impl=impl)
    new_len = lengths + active.to(lengths.dtype)
    if k_scale is not None:
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
    """Batched chunked-prefill write: sequence ``r`` writes its ``counts[r]``
    leading rows of ``k_new[r]`` / ``v_new[r]`` at ``starts[r] + c``, in
    place.

    ``impl='ref'`` is the full-pool oracle.  ``impl='cuda'`` is one launch
    of the paged K/V write kernel (:func:`paged_kv_write`), which stores
    each token straight into its page (the reference's converter path
    gathers the pages the chunk touches, scatters the chunk into them and
    writes them back, because a TPU DMA moves whole blocks).  With scale
    pools the chunk is quantized on write.

    Returns ``(k_pages, v_pages)``, plus ``(k_scale, v_scale)`` when
    quantizing; all are updated in place.
    """
    if impl == "ref":
        return ref.paged_kv_write_chunk(
            k_pages, v_pages, k_new, v_new, rows, starts, counts,
            k_scale=k_scale, v_scale=v_scale,
        )
    return paged_kv_write(k_pages, v_pages, k_new, v_new, rows, starts,
                          counts, k_scale, v_scale, impl=impl)


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
    its lanes to K (:func:`.plans.spmv_plan`, kept as ``spmv_ell.plan``)
    and masks rows past R, so any R works and ``row_block`` only has to be
    positive.
    """
    _check(row_block > 0, f"spmv_ell: row_block {row_block} <= 0")
    if not _use_kernel(impl, x):
        return ref.spmv_ell(vals, cols, x)
    vals, cols, x = _check_ell(vals, cols, x, "spmv_ell")
    r, k = vals.shape
    y = torch.empty(r, dtype=torch.float32, device=x.device)
    plan = spmv_plan(r, k, (vals.data_ptr() | cols.data_ptr()) % 16 == 0)
    _spmv_launch(vals, cols, x, y, plan)
    spmv_ell.plan = plan
    spmv_ell.launches += 1
    return y


spmv_ell.plan = None  # the plan of the last launch


def _spmv_launch(vals, cols, x, y, plan) -> None:
    """Launch the ELL SpMV kernel by ``plan`` (a :class:`.plans.SpmvPlan`
    for these operands)."""
    r, k = vals.shape
    _launch("repro_spmv_ell", _ptr(vals), _ptr(cols), _ptr(x), _ptr(y), r, k,
            x.shape[0], plan.vec, plan.lanes, plan.threads, plan.blocks,
            _stream(x))


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
    ``C % panel``.  On the card the launch follows :func:`.plans.panel_plan`
    (kept as ``spmv_ell_panel_kernel.plan``), which raises where a row
    block's panels do not fit in a block's shared memory.
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
    aligned = all(t.data_ptr() % 16 == 0 for t in (vals, cols, x))
    plan = panel_plan(row_blocks, row_block, k, steps, panel, aligned)
    y = torch.empty(r, dtype=torch.float32, device=x.device)
    _launch("repro_spmv_ell_panel", _ptr(vals), _ptr(cols), _ptr(x),
            _ptr(pids), _ptr(y), row_blocks, row_block, k, steps, panel,
            x.shape[0], 0 if plan.route == "bulk" else 1, plan.tile_rows,
            plan.pack, plan.split, plan.blocks, plan.panels_bytes,
            plan.vals_bytes, plan.part_bytes, plan.smem_bytes, _stream(x))
    spmv_ell_panel_kernel.plan = plan
    spmv_ell_panel_kernel.launches += 1
    return y


spmv_ell_panel_kernel.plan = None  # the plan of the last launch


# ---------------------------------------------------------------------------
# Flash attention (training path)
# ---------------------------------------------------------------------------

_FLASH_DTYPES = (torch.float32, torch.bfloat16)
_FLASH_HEAD_DIMS = (64, 80, 128)
_DKV_KEYS = 128  # keys of a bf16 dk/dv block (flash_attention.cu tc::kRows)


def _tile_width(d: int) -> int:
    """Columns a row of head dim ``d`` takes in the bf16 kernels' tiles:
    whole 64-column boxes (``tc::width``; D = 80 runs padded to 128)."""
    return -(-d // 64) * 64


def _flash_shapes(q, k, v, name):
    """Check what the flash kernels take and return (B, H, KVH, Sq, Skv, D)."""
    _check(q.dim() == 4 and k.dim() == 4 and v.shape == k.shape,
           f"{name}: q must be (B, H, Sq, D) and k, v (B, KVH, Skv, D), got "
           f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, sq, d = q.shape
    _, kvh, skv, dk = k.shape
    _check(k.shape[0] == b and dk == d and kvh > 0 and h % kvh == 0,
           f"{name}: q heads {h} x {d} do not group over kv heads "
           f"{kvh} x {dk}")
    _check(d in _FLASH_HEAD_DIMS, f"{name}: the kernel takes head dims "
           f"{_FLASH_HEAD_DIMS}, got {d}")
    _check(q.dtype in _FLASH_DTYPES and k.dtype == q.dtype
           and v.dtype == q.dtype,
           f"{name}: q, k, v must share one of {_FLASH_DTYPES}, got "
           f"{q.dtype}, {k.dtype}, {v.dtype}")
    _check(k.device == q.device and v.device == q.device,
           f"{name}: q, k, v on {q.device}, {k.device}, {v.device}")
    return b, h, kvh, sq, skv, d


def _rows_contiguous(t: torch.Tensor) -> torch.Tensor:
    """``t`` if its last axis is contiguous (any other strides go to the
    kernel as they are), else a contiguous copy."""
    return t if t.stride(-1) == 1 else t.contiguous()


def _check_tma(name, *tensors):
    """The bf16 kernels load these by TMA: 16-byte-aligned data and byte
    strides that are multiples of 16 (dimensions of size 1 are never
    stepped)."""
    for t in tensors:
        if t.dtype != torch.bfloat16:
            continue
        bad = [st for n, st in zip(t.shape[:3], t.stride()[:3])
               if n > 1 and (st * t.element_size()) % 16]
        _check(t.data_ptr() % 16 == 0 and not bad,
               f"{name}: the bf16 kernels load by TMA, which needs 16-byte-"
               f"aligned data and strides of a multiple of 16 bytes; got a "
               f"view with strides {tuple(t.stride())} at address "
               f"{t.data_ptr():#x}")


def _strides(*tensors):
    """The (b, h, s) element strides of each tensor, as a C array."""
    vals = [st for t in tensors for st in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _flash_tail(shapes, causal, window, scale, x):
    """B, H, KVH, Sq, Skv, D, causal, has_window, window, scale, bf16,
    stream: the launch arguments after the pointers.  A window of Sq or
    more masks nothing a query can reach (qi - kj < Sq always), so it goes
    to the kernel as Sq, which keeps its index sums inside int32."""
    b, h, kvh, sq, skv, d = shapes
    win = 0 if window is None else min(int(window), sq)
    return (b, h, kvh, sq, skv, d, int(bool(causal)), int(window is not None),
            win, ref._scale(d, scale), int(x.dtype == torch.bfloat16),
            _stream(x))


def _launch_flash_fwd(q, k, v, causal, window, scale, with_lse: bool):
    shapes = _flash_shapes(q, k, v, "flash_attention")
    q, k, v = (_rows_contiguous(t) for t in (q, k, v))
    _check_tma("flash_attention", q, k, v)
    b, h, _, sq, _, _ = shapes
    o = torch.empty_like(q)  # q's layout: (B, S, H, D) views stay so
    tail = _flash_tail(shapes, causal, window, scale, q)
    if not with_lse:
        _launch("repro_flash_attention", _ptr(q), _ptr(k), _ptr(v), _ptr(o),
                _strides(q, k, v, o), *tail)
        return o, None
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    _launch("repro_flash_attention_lse", _ptr(q), _ptr(k), _ptr(v), _ptr(o),
            _ptr(lse), _strides(q, k, v, o), *tail)
    return o, lse


@_counted
def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: Optional[int] = None,
                        scale: Optional[float] = None, impl: str = "cuda"):
    """``(o, lse)``: the forward whose residuals the backward needs
    (``flash_attention_fwd_kernel``); lse ``(B, H, Sq)`` float32."""
    if not _use_kernel(impl, q):
        return ref.flash_attention_fwd(q, k, v, causal, window, scale)
    out = _launch_flash_fwd(q, k, v, causal, window, scale, with_lse=True)
    flash_attention_fwd.launches += 1
    return out


@_counted
def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        causal: bool = True, window: Optional[int] = None,
                        scale: Optional[float] = None, impl: str = "cuda"):
    """``(dq, dk, dv)`` from the forward's residuals and ``do``
    (``flash_attention_bwd_kernel``): the dk/dv entry computes ``delta =
    rowsum(do·o)`` with a kernel of its own and then runs the dk/dv pass,
    the dq entry the dq pass; the two count as one launch.  Each gradient
    has its input's dtype and layout."""
    if not _use_kernel(impl, q):
        return ref.flash_attention_bwd(q, k, v, o, lse, do, causal, window,
                                       scale)
    shapes = _flash_shapes(q, k, v, "flash_attention_bwd")
    _check(do.shape == q.shape and do.dtype == q.dtype
           and o.shape == q.shape and o.dtype == q.dtype,
           f"flash_attention_bwd: do {tuple(do.shape)} {do.dtype} and o "
           f"{tuple(o.shape)} {o.dtype} must match q {tuple(q.shape)} "
           f"{q.dtype}")
    _check(lse.shape == q.shape[:3] and lse.dtype == torch.float32,
           f"flash_attention_bwd: lse must be (B, H, Sq) float32, got "
           f"{tuple(lse.shape)} {lse.dtype}")
    q, k, v, do, o = (_rows_contiguous(t) for t in (q, k, v, do, o))
    _check_tma("flash_attention_bwd", q, k, v, do)
    lse = lse.contiguous()
    delta = torch.empty_like(lse)  # written by the dk/dv entry
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    partial = None  # the bf16 dk/dv pass's fp32 sums: 2 tile widths a key
    if q.dtype == torch.bfloat16:
        b, _, kvh, _, skv, d = shapes
        rows = b * kvh * -(-skv // _DKV_KEYS) * _DKV_KEYS
        partial = torch.empty(rows * 2 * _tile_width(d), dtype=torch.float32,
                              device=q.device)
    tail = _flash_tail(shapes, causal, window, scale, q)
    _launch("repro_flash_attention_bwd_dkv", _ptr(q), _ptr(k), _ptr(v),
            _ptr(do), _ptr(o), _ptr(lse), _ptr(delta), _ptr(dk), _ptr(dv),
            _ptr(partial), _strides(q, k, v, do, o, dk, dv), *tail)
    _launch("repro_flash_attention_bwd_dq", _ptr(q), _ptr(k), _ptr(v),
            _ptr(do), _ptr(lse), _ptr(delta), _ptr(dq),
            _strides(q, k, v, do, dq), *tail)
    flash_attention_bwd.launches += 1
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The reference's ``_flash_vjp``: forward saves ``(q, k, v, o, lse)``,
    backward recomputes p from lse (``flash_attention_fwd`` /
    ``flash_attention_bwd``, kernels or plain versions by device)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, impl):
        o, lse = flash_attention_fwd(q, k, v, causal, window, scale,
                                     impl=impl)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (causal, window, scale, impl)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        causal, window, scale, impl = ctx.args
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, causal, window,
                                         scale, impl=impl)
        return dq, dk, dv, None, None, None, None


@_counted
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None, block_q: int = 128,
                    block_k: int = 128, impl: str = "cuda") -> torch.Tensor:
    """Flash attention, trainable: q (B, H, Sq, D); k, v (B, KVH, Skv, D)
    → o (B, H, Sq, D) in q's dtype and layout.

    With grad mode off, or no input requiring grad, this is the forward
    kernel alone (``flash_attention_kernel``); otherwise the autograd
    Function above.  Any strides with a contiguous last axis go to the
    kernels as they are.  Nothing is padded: the kernels mask with the true
    Skv, so a ragged non-causal Skv is exact (the reference's wrapper pads
    K/V to the block and lets the padded keys into the softmax).
    ``block_q``/``block_k`` are the reference's tiles, kept for its
    signature; the kernels pick their own 64-row tiles, so the two only
    have to be positive.  Head dims 64, 80 and 128, fp32 or bf16.
    """
    _check(block_q > 0 and block_k > 0,
           f"flash_attention: blocks {block_q} x {block_k} must be positive")
    if impl not in _IMPLS:
        raise ValueError(f"impl must be one of {_IMPLS}, got {impl!r}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, causal, window, scale, impl)
    if not _use_kernel(impl, q):
        return ref.flash_attention_fwd(q, k, v, causal, window, scale)[0]
    o, _ = _launch_flash_fwd(q, k, v, causal, window, scale, with_lse=False)
    flash_attention.launches += 1
    return o


# ---------------------------------------------------------------------------
# Launch counts
# ---------------------------------------------------------------------------

#: The fourteen kernel wrappers, each with its ``launches`` count.
KERNELS = (indirect_gather, indirect_scatter, paged_kv_write,
           paged_decode_attention, paged_prefill_attention, paged_verify,
           strided_gather, strided_scatter, tiled_transpose, spmv_ell,
           spmv_ell_panel_kernel, flash_attention, flash_attention_fwd,
           flash_attention_bwd)


def launch_counts() -> Dict[str, int]:
    """``{kernel wrapper name: launches}`` since the last reset."""
    return {fn.__name__: fn.launches for fn in KERNELS}


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0

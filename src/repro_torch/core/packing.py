"""Packing semantics and traffic accounting (copy of ``repro.core.packing``).

``pack_*`` / ``unpack_*`` are the reference semantics of AXI-Pack bursts,
what the data looks like after the beat packer has run, as plain tensor
functions: ``unpack_*`` returns a new tensor, as the reference's functional
``.at[].set`` does.  :func:`strided_traffic` and :func:`indirect_traffic`
count the bytes one strided or indirect stream moves under BASE and PACK;
the paper's workloads (:mod:`repro_torch.workloads`) report them.

The rest is the serving accounting: the exact bytes a serving step moves
under BASE (packing-oblivious, padded, full-width) and PACK (paged,
packed) semantics.  The scheduler records one :class:`Traffic` per step;
the numbers are computed from shapes and lengths on the host, so they are
the same whichever device runs the step.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

__all__ = [
    "pack_strided",
    "unpack_strided",
    "pack_indirect",
    "unpack_indirect",
    "Traffic",
    "strided_traffic",
    "indirect_traffic",
    "packed_token_bytes",
    "paged_decode_traffic",
    "prefill_page_counts",
    "paged_prefill_traffic",
    "prefix_share_traffic",
    "spec_verify_traffic",
    "recurrent_decode_traffic",
    "recurrent_prefill_traffic",
]


def _strided_rows(base: int, stride: int, count: int,
                  device: torch.device) -> torch.Tensor:
    return base + stride * torch.arange(count, device=device)


def pack_strided(src: torch.Tensor, base: int, stride: int,
                 count: int) -> torch.Tensor:
    """Gather ``count`` rows of ``src`` at ``base + k*stride`` into a dense
    block.

    ``src`` has shape (n_rows, *row); the result has shape (count, *row).
    With stride == 1 this is a contiguous slice whose start is clamped so
    the slice lies inside ``src``, as ``lax.dynamic_slice`` clamps it.
    """
    if stride == 1:
        base = min(max(base, 0), src.shape[0] - count)
        return src[base:base + count].clone()
    return src[_strided_rows(base, stride, count, src.device)]


def unpack_strided(dst: torch.Tensor, packed: torch.Tensor, base: int,
                   stride: int) -> torch.Tensor:
    """A copy of ``dst`` with the rows of ``packed`` at ``base + k*stride``
    (a contiguous start clamped as in :func:`pack_strided`)."""
    count = packed.shape[0]
    out = dst.clone()
    if stride == 1:
        base = min(max(base, 0), dst.shape[0] - count)
        out[base:base + count] = packed
    else:
        out[_strided_rows(base, stride, count, dst.device)] = packed
    return out


def pack_indirect(src: torch.Tensor, indices: torch.Tensor,
                  base: int = 0) -> torch.Tensor:
    """Gather rows ``src[base + indices[k]]`` into a dense block.

    The index tensor is memory-resident (the in-memory indexed semantics of
    ``vlimxei``): callers never materialize per-element addresses.
    """
    return src[base + indices.long()]


def unpack_indirect(dst: torch.Tensor, packed: torch.Tensor,
                    indices: torch.Tensor, base: int = 0,
                    mode: str = "set") -> torch.Tensor:
    """A copy of ``dst`` with the rows of ``packed`` at
    ``base + indices[k]``.

    ``mode='set'`` mirrors the hardware write converter (last-writer-wins
    for duplicate indices, order unspecified); ``mode='add'`` accumulates
    (``index_add``), as MoE combine and embedding gradients use it.
    """
    idx = base + indices.long()
    if mode == "add":
        return dst.index_add(0, idx, packed)
    out = dst.clone()
    out[idx] = packed
    return out


# ---------------------------------------------------------------------------
# Traffic accounting: exact bytes moved under each system's semantics.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Traffic:
    """HBM/bus traffic for one logical transfer, per system.

    ``base_bytes`` counts one full bus/transaction granule per element (the
    narrow-beat penalty); ``pack_bytes`` counts densely packed lines;
    ``index_bus_bytes`` is index traffic crossing the core-side bus (zero for
    PACK, whose indirection is endpoint-side).  ``shared_pages`` counts
    physical pages this transfer *reused* instead of re-writing (prefix
    sharing): reuse moves no payload, so those records show
    ``pack_bytes == 0`` while ``useful_bytes`` stays the full value — the
    dedup-before-packing multiplier of the irredundant-layout argument.
    """

    useful_bytes: int
    base_bytes: int
    pack_bytes: int
    index_bus_bytes_base: int
    index_bus_bytes_pack: int = 0
    shared_pages: int = 0

    @property
    def base_efficiency(self) -> float:
        tot = self.base_bytes + self.index_bus_bytes_base
        return self.useful_bytes / tot if tot else 1.0

    @property
    def pack_efficiency(self) -> float:
        tot = self.pack_bytes + self.index_bus_bytes_pack
        return self.useful_bytes / tot if tot else 1.0


def strided_traffic(
    count: int, elem_bytes: int, stride: int, granule_bytes: int = 32
) -> Traffic:
    """Traffic for a strided stream on a ``granule_bytes``-wide bus."""
    useful = count * elem_bytes
    if stride == 1:
        moved = int(np.ceil(useful / granule_bytes)) * granule_bytes
        return Traffic(useful, moved, moved, 0)
    base = count * granule_bytes                      # one narrow beat/elem
    pack = int(np.ceil(useful / granule_bytes)) * granule_bytes
    return Traffic(useful, base, pack, 0)


def indirect_traffic(
    count: int, elem_bytes: int, index_bytes: int, granule_bytes: int = 32
) -> Traffic:
    """Traffic for an indirect stream; indices are packed lines either way."""
    useful = count * elem_bytes
    idx = int(np.ceil(count * index_bytes / granule_bytes)) * granule_bytes
    base = count * granule_bytes
    pack = int(np.ceil(useful / granule_bytes)) * granule_bytes
    # PACK fetches indices endpoint-side: they cost memory bandwidth but not
    # core-side bus bytes; we still report them for the HBM energy proxy.
    return Traffic(useful, base, pack, idx, 0)


def packed_token_bytes(
    token_bytes: int, elem_bits: int = 32, scale_bytes_per_token: int = 0
) -> int:
    """Per-token bytes PACK actually moves for a KV stream.

    ``token_bytes`` is the *FP32-equivalent* (full-width) per-token
    footprint; ``elem_bits`` the real element width on the stream.  Narrow
    elements pack densely, so the payload scales by ``elem_bits / 32`` — the
    paper's packing-factor argument (``bus / elem`` elements per beat,
    §II-C/§III-E): 8-bit elements quadruple the FP32 packing factor.
    ``scale_bytes_per_token`` adds the sideband metadata a quantized pool
    fetches next to the codes (the per-(token, kv-head) fp32 scales), which
    is real bandwidth and is charged to PACK like the index fetch is.
    """
    return token_bytes * elem_bits // 32 + scale_bytes_per_token


def paged_decode_traffic(
    lengths,
    page_size: int,
    pages_per_seq: int,
    token_bytes: int,
    index_bytes: int = 4,
    granule_bytes: int = 32,
    elem_bits: int = 32,
    scale_bytes_per_token: int = 0,
) -> Traffic:
    """Traffic of one batched paged-KV decode step, BASE vs PACK.

    * **BASE** is the serving system without indirection or packing: a
      contiguous *full-width* KV cache padded to the maximum sequence
      length, so every decode step streams ``batch × pages_per_seq ×
      page_size`` token rows at ``token_bytes`` each regardless of sequence
      length or element width — the narrow-beat penalty: a narrower element
      still occupies a full-width slot.  No index traffic.
    * **PACK** is the paged path: only the mapped pages of each sequence move
      (whole pages — the packing granule of this stream) at the *packed*
      width (:func:`packed_token_bytes` — ``elem_bits`` narrow elements
      packed densely, plus the quantization-scale sideband), and the
      page-table entries are the indirect-stream index fetch.  The indices
      are resolved near memory, so they are charged to
      ``index_bus_bytes_pack`` (the HBM side), never to the core-side bus —
      but they do lower ``pack_efficiency``, matching the r/(r+1) ceiling
      argument of §III-E.
    * ``useful_bytes`` is the exact live KV at the packed width:
      ``sum(lengths) × packed_token_bytes``.

    ``token_bytes`` is the FP32-equivalent per-token KV footprint across
    everything a decode step reads (K and V, all layers, all KV heads);
    ``elem_bits`` is the pool's element width (8 for int8 pools, which
    quarters PACK bytes and the BASE efficiency alike).
    """
    lens = np.asarray(lengths, dtype=np.int64)
    batch = int(lens.shape[0])
    packed = packed_token_bytes(token_bytes, elem_bits, scale_bytes_per_token)
    pages_touched = int(np.sum(-(-lens // page_size)))
    useful = int(np.sum(lens)) * packed
    base = batch * pages_per_seq * page_size * token_bytes
    pack = pages_touched * page_size * packed
    pack = int(np.ceil(pack / granule_bytes)) * granule_bytes if pack else 0
    idx = pages_touched * index_bytes
    idx = int(np.ceil(idx / granule_bytes)) * granule_bytes if idx else 0
    return Traffic(useful, base, pack, 0, idx)


def prefill_page_counts(
    starts, counts, page_size: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-row (context, chunk) page counts of one batched prefill step.

    ``context[r]`` is the leading ``ceil((starts[r]+counts[r])/page)`` table
    entries the chunk's attention walks; ``chunk[r]`` the pages positions
    ``starts[r] .. starts[r]+counts[r]-1`` land in (the indirect write).
    Padding rows (``counts[r] == 0``) touch nothing and count zero pages.

    This is the single source of page math shared by the
    :func:`paged_prefill_traffic` byte accounting and the
    :func:`repro.core.streams.prefill_table_streams` descriptors — the same
    pages the ``paged_prefill_attention`` kernel's index map resolves.
    """
    st = np.asarray(starts, dtype=np.int64)
    ct = np.asarray(counts, dtype=np.int64)
    live = st + ct
    ctx = np.where(ct > 0, -(-live // page_size), 0)
    chunk = np.where(ct > 0, (live - 1) // page_size - st // page_size + 1, 0)
    return ctx, chunk


def paged_prefill_traffic(
    starts,
    counts,
    page_size: int,
    pages_per_seq: int,
    token_bytes: int,
    index_bytes: int = 4,
    granule_bytes: int = 32,
    elem_bits: int = 32,
    scale_bytes_per_token: int = 0,
) -> Traffic:
    """Traffic of one batched chunked-prefill step, BASE vs PACK.

    Each sequence writes ``counts[r]`` KV rows at positions ``starts[r]..``
    and its attention re-reads the context built so far.

    * **BASE** streams the full padded row per sequence for the context read
      (``pages_per_seq × page_size`` tokens at the full ``token_bytes``
      width — narrow elements still occupy full-width slots) plus one
      transaction granule per written row — the packing-oblivious scatter.
    * **PACK** reads only the pages covering ``starts + counts`` tokens,
      writes only the pages the chunk touches (whole pages, the stream's
      packing granule), both at the *packed* width
      (:func:`packed_token_bytes`: ``elem_bits`` narrow elements packed
      densely plus the quantization-scale sideband), and fetches the
      corresponding page-table entries near memory
      (``index_bus_bytes_pack``).
    * ``useful_bytes`` is the live context read plus the rows written, at
      the packed width.
    """
    st = np.asarray(starts, dtype=np.int64)
    ct = np.asarray(counts, dtype=np.int64)
    live = np.where(ct > 0, st + ct, 0)
    packed = packed_token_bytes(token_bytes, elem_bits, scale_bytes_per_token)
    ctx, chunk = prefill_page_counts(starts, counts, page_size)
    ctx_pages = int(np.sum(ctx))
    chunk_pages = int(np.sum(chunk))
    useful = int(np.sum(live) + np.sum(ct)) * packed
    batch = int(np.count_nonzero(ct))
    base = (batch * pages_per_seq * page_size * token_bytes
            + int(np.sum(ct)) * granule_bytes)
    pack = (ctx_pages + chunk_pages) * page_size * packed
    pack = int(np.ceil(pack / granule_bytes)) * granule_bytes if pack else 0
    idx = (ctx_pages + chunk_pages) * index_bytes
    idx = int(np.ceil(idx / granule_bytes)) * granule_bytes if idx else 0
    return Traffic(useful, base, pack, 0, idx)


def prefix_share_traffic(
    shared_tokens: int,
    n_pages: int,
    page_size: int,
    token_bytes: int,
    index_bytes: int = 4,
    granule_bytes: int = 32,
    elem_bits: int = 32,
    scale_bytes_per_token: int = 0,
) -> Traffic:
    """Traffic of mapping an already-resident prompt prefix, BASE vs PACK.

    When admission finds ``n_pages`` page-aligned prefix pages already in
    the pool, the sharing path moves *no KV payload* — it bumps refcounts
    and fetches the ``n_pages`` page-table entries it repoints (charged to
    ``index_bus_bytes_pack``, near-memory like every other table fetch).

    * **BASE** is the dedup-oblivious server: it re-prefills the prefix, so
      it streams ``shared_tokens`` full-width KV writes (one transaction
      granule per row, the packing-oblivious scatter — the write half of
      :func:`paged_prefill_traffic`'s BASE, which is exactly the work
      sharing elides; the context re-reads it also skips are already
      reflected in the *absent* prefill records).
    * **PACK** moves only the table fetch: ``pack_bytes == 0``.
    * ``useful_bytes`` is the prefix KV at the packed width — the bytes the
      pool now serves without them ever crossing the bus again.

    ``pack_efficiency`` of such a record is ``useful / index`` and typically
    far exceeds 1: that is the dedup multiplier on top of packing, and why
    :class:`Traffic` carries ``shared_pages`` so aggregates can report it
    separately rather than silently inflating the packing ratio.
    """
    packed = packed_token_bytes(token_bytes, elem_bits, scale_bytes_per_token)
    useful = shared_tokens * packed
    base = shared_tokens * max(token_bytes, granule_bytes)
    idx = n_pages * index_bytes
    idx = int(np.ceil(idx / granule_bytes)) * granule_bytes if idx else 0
    return Traffic(useful, base, 0, 0, idx, shared_pages=n_pages)


def spec_verify_traffic(
    lengths,
    scored,
    page_size: int,
    pages_per_seq: int,
    token_bytes: int,
    index_bytes: int = 4,
    granule_bytes: int = 32,
    elem_bits: int = 32,
    scale_bytes_per_token: int = 0,
) -> Traffic:
    """Traffic of one speculative K-token verify step, BASE vs PACK.

    ``lengths[r]`` is row ``r``'s context before the step and ``scored[r]``
    how many query tokens (feed + drafts, 0 for inactive rows) the verify
    kernel scored in its single walk.  The page math is prefill's with
    ``starts = lengths`` — a verify chunk *is* a causal chunk at the
    context tail — but the **BASE counterfactual is different**, and it is
    the point of the whole speculative path:

    * **BASE** is the non-speculative narrow decoder emitting the same
      tokens one at a time: ``scored[r]`` separate full-width padded walks
      per row (``sum(scored) × pages_per_seq × page_size × token_bytes``)
      plus one transaction granule per written row.  This is what PR-7's
      decode path actually pays per K tokens.
    * **PACK** walks each row's context pages **once** for all K queries
      (the packed indirect burst amortized over the time axis, not just
      the batch axis) and writes only the chunk pages — both at the packed
      width (:func:`packed_token_bytes`), with the page-table entries
      fetched near memory (``index_bus_bytes_pack``).
    * ``useful_bytes`` is one context read plus the rows written, at the
      packed width — same form as prefill.

    The BASE/PACK ratio therefore approaches ``K ×`` the plain-decode
    ratio at full acceptance, degrading gracefully with ``scored``.
    """
    lens = np.asarray(lengths, dtype=np.int64)
    sc = np.asarray(scored, dtype=np.int64)
    live = np.where(sc > 0, lens + sc, 0)
    packed = packed_token_bytes(token_bytes, elem_bits, scale_bytes_per_token)
    ctx, chunk = prefill_page_counts(lens, sc, page_size)
    ctx_pages = int(np.sum(ctx))
    chunk_pages = int(np.sum(chunk))
    useful = int(np.sum(live) + np.sum(sc)) * packed
    base = (int(np.sum(sc)) * pages_per_seq * page_size * token_bytes
            + int(np.sum(sc)) * granule_bytes)
    pack = (ctx_pages + chunk_pages) * page_size * packed
    pack = int(np.ceil(pack / granule_bytes)) * granule_bytes if pack else 0
    idx = (ctx_pages + chunk_pages) * index_bytes
    idx = int(np.ceil(idx / granule_bytes)) * granule_bytes if idx else 0
    return Traffic(useful, base, pack, 0, idx)


def recurrent_decode_traffic(
    n_active: int,
    batch: int,
    state_bytes: int,
    granule_bytes: int = 32,
) -> Traffic:
    """Traffic of one recurrent (RWKV/Mamba) decode step, BASE vs PACK.

    The strided-burst sibling of :func:`paged_decode_traffic`: a decode
    step is a read-modify-write of each active sequence's fixed-size state
    (``state_bytes`` per sequence — all layers, all state tensors), laid
    out (layer, slot) so one sequence's rows sit at a fixed stride of
    ``batch`` rows (the :func:`repro.core.streams.recurrent_state_streams`
    descriptors).  No index vector exists — the stride *is* the
    descriptor — so unlike the indirect dialect there is no
    ``index_bus_bytes`` term at all.

    * **BASE** is the padded-batch server: it streams the whole (layer,
      batch) state pool through (read + write) regardless of how many
      slots are live — ``2 × batch × state_bytes``.
    * **PACK** issues one strided burst pair per active slot, moving
      exactly its rows (densely packed; granule-rounded):
      ``2 × n_active × state_bytes``.
    * ``useful_bytes`` equals PACK's payload — recurrent state has no dead
      tokens inside a row, so the strided PACK efficiency is ≈ 1 by
      construction while BASE efficiency is the occupancy ``A / batch``.
      That contrast (indirect pays the r/(r+1) index tax, strided does
      not) is exactly the Fig. 3 comparison the serving benchmark reports.
    """
    useful = 2 * int(n_active) * int(state_bytes)
    pack = int(np.ceil(useful / granule_bytes)) * granule_bytes if useful else 0
    base = 2 * int(batch) * int(state_bytes)
    return Traffic(useful, base, pack, 0)


def recurrent_prefill_traffic(
    counts,
    batch: int,
    state_bytes: int,
    granule_bytes: int = 32,
) -> Traffic:
    """Traffic of one batched recurrent prefill chunk, BASE vs PACK.

    A fused prefill chunk loads each pending sequence's state once, scans
    ``counts[r]`` prompt tokens on-chip, and writes the state back once —
    so PACK moves the same ``2 × state_bytes`` per active row a decode
    step does, *independent of the chunk length* (the recurrent analogue
    of prefill's context-read amortization).

    * **BASE** is the packing-oblivious server that re-streams the padded
      (layer, batch) pool per token position of the chunk:
      ``2 × batch × max(counts) × state_bytes``.
    * **PACK** / ``useful_bytes``: ``2 × n_active × state_bytes``,
      granule-rounded (strided bursts are dense — no index term).
    """
    ct = np.asarray(counts, dtype=np.int64)
    n_active = int(np.count_nonzero(ct))
    chunk = int(ct.max()) if ct.size else 0
    useful = 2 * n_active * int(state_bytes)
    pack = int(np.ceil(useful / granule_bytes)) * granule_bytes if useful else 0
    base = 2 * int(batch) * chunk * int(state_bytes)
    return Traffic(useful, base, pack, 0)

"""Packed irregular stream descriptors (numpy copy of ``repro.core.streams``).

A :class:`StridedStream` or :class:`IndirectStream` describes an irregular
access sequence the way an AXI-Pack request does: cheap integer metadata
travelling ahead of the data, with an indirect stream's index vector kept
in memory.  The paged serving path builds one :class:`IndirectStream` per
sequence and step, whose indices are the page-table entries the CUDA
kernels resolve on the card; the recurrent path one :class:`StridedStream`
per state tensor, slot and direction, whose base and stride are the whole
address the strided converter kernels are launched with.  The paper's
workload models (:mod:`repro_torch.workloads.paper`) build them per loop
iteration, and :func:`word_addresses` maps them onto the banked endpoint
of :mod:`.banksim`.
"""
from __future__ import annotations

import dataclasses
import enum
import math
from typing import Optional, Sequence, Tuple

import numpy as np

from .packing import packed_token_bytes, prefill_page_counts

__all__ = [
    "BurstKind",
    "StreamDescriptor",
    "ContiguousStream",
    "StridedStream",
    "IndirectStream",
    "elements_per_beat",
    "beats_for",
    "page_table_streams",
    "prefill_table_streams",
    "share_table_streams",
    "verify_table_streams",
    "recurrent_state_streams",
    "word_addresses",
]


class BurstKind(enum.Enum):
    """The three burst families AXI-Pack distinguishes.

    ``BASE`` corresponds to an ordinary AXI4 contiguous burst (the ``base``
    converter in the paper's controller); ``STRIDED`` and ``INDIRECT`` are the
    two new packed burst types signalled by the ``pack``/``indir`` user bits.
    """

    BASE = "base"
    STRIDED = "strided"
    INDIRECT = "indirect"


def elements_per_beat(bus_bits: int, elem_bits: int) -> int:
    """How many elements a single packed bus beat carries (n = D/W in §II-C)."""
    if elem_bits > bus_bits:
        raise ValueError(f"element ({elem_bits}b) wider than bus ({bus_bits}b)")
    return bus_bits // elem_bits


def beats_for(n_elems: int, bus_bits: int, elem_bits: int) -> int:
    """Beats needed to carry ``n_elems`` densely packed elements."""
    if n_elems == 0:
        return 0
    return math.ceil(n_elems * elem_bits / bus_bits)


@dataclasses.dataclass(frozen=True)
class StreamDescriptor:
    """Base class for stream descriptors.

    Attributes:
      base: element offset of the first element in the source array (in
        elements, mirroring the paper's bus-aligned semantics).
      elem_bits: element width in bits (AR/AW ``size`` field under AXI-Pack).
      count: number of elements in the stream (burst length × packing factor).
    """

    base: int
    elem_bits: int
    count: int

    kind: BurstKind = dataclasses.field(default=BurstKind.BASE, init=False)

    def element_offsets(self) -> np.ndarray:
        """Absolute element offsets touched by the stream, in stream order."""
        raise NotImplementedError

    @property
    def bytes(self) -> int:
        return self.count * self.elem_bits // 8


@dataclasses.dataclass(frozen=True)
class ContiguousStream(StreamDescriptor):
    """A plain AXI4 burst: ``count`` elements starting at ``base``."""

    def __post_init__(self):
        object.__setattr__(self, "kind", BurstKind.BASE)

    def element_offsets(self) -> np.ndarray:
        return self.base + np.arange(self.count, dtype=np.int64)


@dataclasses.dataclass(frozen=True)
class StridedStream(StreamDescriptor):
    """A packed strided burst: elements at ``base + k*stride``.

    ``stride`` is in elements, like the user-field stride of AXI-Pack. A
    stride of 1 degenerates to a contiguous burst and is routed to the base
    converter (the paper's never-slower-than-AXI4 guarantee).
    """

    stride: int = 1

    def __post_init__(self):
        object.__setattr__(
            self, "kind", BurstKind.BASE if self.stride == 1 else BurstKind.STRIDED
        )

    def element_offsets(self) -> np.ndarray:
        return self.base + self.stride * np.arange(self.count, dtype=np.int64)


@dataclasses.dataclass(frozen=True)
class IndirectStream(StreamDescriptor):
    """A packed indirect burst: elements at ``base + index[k]``.

    The index array lives in memory (``indices``), matching the new
    ``vlimxei``/``vsimxei`` in-memory indexed instructions: indirection is
    resolved at the endpoint, so indices never consume core-side bandwidth.

    Attributes:
      indices: int array of ``count`` element offsets (relative to ``base``).
      index_bits: index element width (8/16/32), which sets the element:index
        ratio r and the r/(r+1) utilization ceiling of §III-E.
      remap_only: the stream repoints table entries without moving element
        payload (prefix sharing): only the index fetch touches memory.  The
        element fields still describe the pages being reused, so accounting
        can value the remap, but simulators must drain just the index lines.
    """

    indices: Optional[np.ndarray] = None
    index_bits: int = 32
    remap_only: bool = False

    def __post_init__(self):
        object.__setattr__(self, "kind", BurstKind.INDIRECT)
        if self.indices is None:
            raise ValueError("IndirectStream requires an index array")
        idx = np.asarray(self.indices)
        if idx.ndim != 1 or idx.shape[0] != self.count:
            raise ValueError(
                f"index array shape {idx.shape} does not match count={self.count}"
            )

    @property
    def ratio(self) -> float:
        """Element:index size ratio r — sets the r/(r+1) packing ceiling."""
        return self.elem_bits / self.index_bits

    @property
    def index_bytes(self) -> int:
        return self.count * self.index_bits // 8

    def element_offsets(self) -> np.ndarray:
        return self.base + np.asarray(self.indices, dtype=np.int64)


def page_table_streams(
    page_table,
    lengths,
    page_size: int,
    token_bytes: int,
    index_bits: int = 32,
    kv_elem_bits: int = 32,
    scale_bytes_per_token: int = 0,
) -> Tuple["IndirectStream", ...]:
    """Batched indirect-stream descriptors for a paged-KV decode step.

    A paged KV cache is the serving-side instance of the paper's indirect
    stream: the *element* is one physical KV page (``page_size`` tokens ×
    the packed per-token width), and the per-sequence page-table row is the
    memory-resident index vector.  One :class:`IndirectStream` is returned
    per sequence with a non-zero length, covering exactly the pages a decode
    step touches (``ceil(len / page_size)`` leading table entries).

    ``token_bytes`` is the FP32-equivalent per-token footprint;
    ``kv_elem_bits`` the real element width of the pool on the stream.
    Narrow elements shrink the page element
    (:func:`repro.core.packing.packed_token_bytes`): an int8 pool's page
    descriptor carries a quarter of the fp32 bits plus the scale sideband —
    the ``elements_per_beat`` packing factor quadrupling, visible in the
    descriptor itself.

    The scheduler builds these descriptors each step and derives both the
    kernel operands (page ids / lengths) and the
    :func:`repro.core.packing.paged_decode_traffic` accounting from them, so
    the serving path and the Fig. 3 bus model share one source of truth.
    """
    pt = np.asarray(page_table)
    lens = np.asarray(lengths)
    elem_bits = page_size * packed_token_bytes(
        token_bytes, kv_elem_bits, scale_bytes_per_token
    ) * 8
    out = []
    for row, ln in zip(pt, lens):
        n = -(-int(ln) // page_size)
        if n == 0:
            continue
        out.append(
            IndirectStream(
                base=0,
                elem_bits=elem_bits,
                count=n,
                indices=np.asarray(row[:n], dtype=np.int64),
                index_bits=index_bits,
            )
        )
    return tuple(out)


def prefill_table_streams(
    page_table,
    starts,
    counts,
    page_size: int,
    token_bytes: int,
    index_bits: int = 32,
    kv_elem_bits: int = 32,
    scale_bytes_per_token: int = 0,
) -> Tuple["IndirectStream", ...]:
    """Batched indirect-stream descriptors for one chunked-prefill step.

    The prefill-side sibling of :func:`page_table_streams`: per sequence
    with a non-zero chunk, *two* indirect streams whose element is one
    physical KV page —

    * the **context read**: the leading ``ceil((start+count)/page)`` table
      entries the ``paged_prefill_attention`` kernel walks (its scalar-
      prefetch index vector, verbatim), and
    * the **chunk write**: the entries covering positions
      ``start .. start+count-1`` that ``paged_kv_write_chunk`` scatters
      through.

    ``kv_elem_bits``/``scale_bytes_per_token`` shrink the page element for
    narrow (int8) pools exactly as in :func:`page_table_streams`.

    Page math is shared with :func:`repro.core.packing.paged_prefill_traffic`
    via :func:`repro.core.packing.prefill_page_counts`, so the descriptors,
    the byte accounting, and the kernel's DMA walk are one source of truth.
    """
    pt = np.asarray(page_table)
    st = np.asarray(starts)
    ct = np.asarray(counts)
    ctx, chunk = prefill_page_counts(st, ct, page_size)
    elem_bits = page_size * packed_token_bytes(
        token_bytes, kv_elem_bits, scale_bytes_per_token
    ) * 8
    out = []
    for row, s, n, nc, nw in zip(pt, st, ct, ctx, chunk):
        if n == 0:
            continue
        out.append(
            IndirectStream(
                base=0,
                elem_bits=elem_bits,
                count=int(nc),
                indices=np.asarray(row[: int(nc)], dtype=np.int64),
                index_bits=index_bits,
            )
        )
        p_lo = int(s) // page_size
        out.append(
            IndirectStream(
                base=0,
                elem_bits=elem_bits,
                count=int(nw),
                indices=np.asarray(
                    row[p_lo : p_lo + int(nw)], dtype=np.int64
                ),
                index_bits=index_bits,
            )
        )
    return tuple(out)


def share_table_streams(
    page_ids: Sequence[int],
    page_size: int,
    token_bytes: int,
    index_bits: int = 32,
    kv_elem_bits: int = 32,
    scale_bytes_per_token: int = 0,
) -> Tuple["IndirectStream", ...]:
    """Descriptor for mapping an already-resident prompt prefix (dedup).

    The admission-time sibling of :func:`page_table_streams`: when a new
    request's page-aligned prompt prefix is already in the pool, the only
    memory operation is fetching the ``len(page_ids)`` table entries being
    repointed — no KV payload moves.  The returned stream is ``remap_only``;
    its element fields still carry the packed page width so the byte value
    of the reuse (:func:`repro.core.packing.prefix_share_traffic`) and the
    descriptor agree on what was deduplicated.
    """
    if not len(page_ids):
        return ()
    elem_bits = page_size * packed_token_bytes(
        token_bytes, kv_elem_bits, scale_bytes_per_token
    ) * 8
    return (
        IndirectStream(
            base=0,
            elem_bits=elem_bits,
            count=len(page_ids),
            indices=np.asarray(page_ids, dtype=np.int64),
            index_bits=index_bits,
            remap_only=True,
        ),
    )


def verify_table_streams(
    page_table,
    lengths,
    scored,
    page_size: int,
    token_bytes: int,
    index_bits: int = 32,
    kv_elem_bits: int = 32,
    scale_bytes_per_token: int = 0,
) -> Tuple["IndirectStream", ...]:
    """Indirect-stream descriptors for one speculative K-token verify step.

    A verify chunk is a causal prefill chunk appended at the context tail,
    so the descriptors *are* :func:`prefill_table_streams` with
    ``starts = lengths`` — per active row one context-read stream over the
    leading ``ceil((length + scored)/page)`` table entries (the single
    clamped walk ``paged_verify`` amortizes over all K queries, where plain
    decode would emit ``scored`` separate walks) and one chunk-write stream
    over the pages the K appended tokens land in.  Shares its page math
    with :func:`repro.core.packing.spec_verify_traffic` through
    :func:`repro.core.packing.prefill_page_counts`.
    """
    return prefill_table_streams(
        page_table, lengths, scored, page_size, token_bytes,
        index_bits=index_bits, kv_elem_bits=kv_elem_bits,
        scale_bytes_per_token=scale_bytes_per_token,
    )


def recurrent_state_streams(
    slots: Sequence[int],
    batch: int,
    n_layers: int,
    row_bytes: Sequence[int],
) -> Tuple["StridedStream", ...]:
    """Strided read-modify-write descriptors for one recurrent decode step.

    The strided-burst sibling of :func:`page_table_streams`: recurrent
    (RWKV/Mamba) serving state is fixed-size per sequence and lives in
    pools of shape ``(n_layers, batch, *row)``.  Flattened to
    ``(n_layers × batch)`` rows, one sequence's state sits at rows
    ``slot, slot + batch, slot + 2·batch, …`` — a textbook strided stream:
    ``base = slot``, ``stride = batch``, ``count = n_layers``, with the
    whole per-layer row as the element.  No memory-resident index vector
    exists; the stride in the request descriptor is the entire addressing
    metadata (the ``pack``/``indir=0`` encoding of the paper).

    A decode step both reads and writes the state, so *two* descriptors
    are emitted per (active slot, state tensor): the read burst and the
    write-back burst.  ``row_bytes`` carries one per-layer row footprint
    per state tensor (RWKV6 has one — the (H, 64, 64) wkv state; Mamba has
    two — the SSM state and the conv tail).

    With ``batch == 1`` the stride degenerates to 1 and the descriptor
    routes to the BASE converter (the never-slower-than-AXI4 guarantee),
    exactly like :class:`StridedStream` always does.

    The family builds these each step and derives the
    :func:`repro.core.packing.recurrent_decode_traffic` accounting from the
    same (slots, batch, layers, bytes) quantities, so descriptors and byte
    accounting share one source of truth — mirroring the paged path.
    """
    out = []
    for slot in slots:
        for rb in row_bytes:
            for _ in range(2):  # read burst + write-back burst
                out.append(
                    StridedStream(
                        base=int(slot),
                        elem_bits=int(rb) * 8,
                        count=int(n_layers),
                        stride=int(batch),
                    )
                )
    return tuple(out)


def word_addresses(
    stream: StreamDescriptor, word_bits: int = 32
) -> np.ndarray:
    """Map a stream's element offsets to memory *word* addresses.

    The banked controller operates on W-bit words (the bank width); an element
    smaller than a word still occupies one word access, while an element
    spanning multiple words issues several.  Returns the flat sequence of word
    addresses in stream order (used by the bank-conflict simulator).
    """
    offs = stream.element_offsets()
    if stream.elem_bits <= word_bits:
        scale = word_bits // stream.elem_bits
        return offs // scale
    words_per_elem = stream.elem_bits // word_bits
    base_words = offs * words_per_elem
    return (base_words[:, None] + np.arange(words_per_elem)[None, :]).reshape(-1)

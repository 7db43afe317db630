"""Launch plans of the gather, the ELL and panel SpMVs and the paged
attention kernels, chosen on the host.

Plain Python, no torch: :mod:`.ops` computes a plan from the call's shapes
and pointer alignment and passes its fields to the C entry, which launches
by them as given (grid, threads, shared memory and its regions), so this
module is the layout's one owner and the CPU tests check every plan
without a card.  A call no plan can serve raises ``ValueError``; nothing
falls back.

**Gather** (``stream_converters.cu``, ``indirect_gather_kernel``).  Rows
are copied in units of 16, 4 or 1 bytes, the widest that the row length
and both base pointers allow, so any width copies bitwise.  A block of
``threads`` threads copies one unit a thread a pass: block ``(k, y)``
moves slabs ``y, y + grid_y, ...`` of gathered row ``k``, slab ``j`` being
bytes ``[j * slab_bytes, min((j + 1) * slab_bytes, row_bytes))`` with
``slab_bytes = threads * unit``.  ``grid_y`` covers the row, so every slab
of every row is in flight at once (up to 65,535 blocks a row).  A row of
more than ``GATHER_MAX_UNITS`` units has no plan.

**ELL SpMV** (``spmv.cu``, ``spmv_ell_kernel``).  ``lanes`` lanes (a
power of two up to 32) serve a row; a load is ``vec`` entries of ``vals``
and of ``cols`` (4, one 16-byte word each, where K is a multiple of 4 and
both are 16-byte aligned, else 1).  Load ``i`` of a row belongs to lane
``i % lanes``.  ``lanes`` is the smallest power of two that gives each
load of a row its own lane (8 at K = 32: a warp reads four whole 128-byte
rows a load), at most 32.

**Panel SpMV** (``spmv.cu``, ``spmv_ell_panel_kernel``).  A block owns a
tile of rows: ``pack`` whole row blocks, or (``split`` > 1) a part of one
row block.  It stages every step's x panel of its row blocks and the
tile's ``vals`` and ``cols`` in shared memory at once, then computes.
Routes:

* ``bulk``: ``cp.async.bulk`` copies on one ``mbarrier``; ``vals`` and
  ``cols`` with an evict-first L2 policy, the panels evict-last.  Taken
  where x, ``vals`` and ``cols`` are 16-byte aligned, ``panel % 4 == 0``
  and ``row_block * K % 4 == 0`` (tiles of whole 16 bytes).
* ``cp.async``: every thread issues ``cp.async`` copies of 16 bytes where a
  region allows it and 4 bytes elsewhere.  Taken for every other call.

**Paged attention** (``paged_decode.cu``, ``paged_prefill.cu``, both over
``paged_split.cuh``).  Each row's context is cut into spans of ``span``
positions, a constant of the kernel (``DECODE_SPAN``, ``PREFILL_SPAN``)
rounded up to whole pages and whole kv tiles.  Block ``(s, tile * KVH +
g, r)`` walks span ``s`` of row ``r`` for kv head ``g`` and one tile of
query rows (``tq`` positions times the group's ``rep`` heads), in kv tiles
of ``kv_tile = head_dim / 4`` positions double-buffered with ``cp.async``,
and writes each query row's partial max, sum and accumulator.  A combine
launch then adds, for each query, the spans it sees, in span order.  So a
query's bits depend on its own q, pages, start and count and on the span,
never on the batch, the table's width or the tile it rides in.  Blocks
whose span starts at or past the last position their tile sees exit
before loading anything.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass

__all__ = ["ATTENTION_FIELDS", "AttentionPlan", "GatherPlan", "PanelPlan",
           "SMEM_PER_BLOCK", "SpmvPlan", "attention_plan", "gather_plan",
           "panel_plan", "spmv_plan"]

#: Dynamic shared memory one block may use on Hopper (H100, H200).
SMEM_PER_BLOCK = 232448
GRID_Y_MAX = 65535
GATHER_THREADS = 256      # a block's threads: a 4 KB slab of 16-byte units
GATHER_MAX_UNITS = 1 << 30  # the kernel indexes a row's units in 32 bits
SPMV_THREADS = 256        # spmv_ell_kernel's block (its __launch_bounds__)
PANEL_ROUTES = ("bulk", "cp.async")
PANEL_TILE_BYTES = 16384  # vals + cols bytes a tile aims at
DECODE_SPAN = 32          # context positions a decode block walks
PREFILL_SPAN = 64         # ... a prefill / verify block
ATTN_TILE_FLOATS = 8192   # a query tile's rows x head_dim, at most
ATTN_HEAD_DIMS = (16, 32, 64, 128)
ATTN_MAX_THREADS = 256    # the kernels' __launch_bounds__
#: Pool element bytes the paged attention kernels take.
ATTN_ELEM_BYTES = {4: "fp32", 2: "bf16", 1: "int8"}
COMBINE_THREADS = 256


def _unit(*values: int) -> int:
    """The widest copy unit (16, 4 or 1 bytes) that divides every value."""
    m = 0
    for v in values:
        m |= v
    return 16 if m % 16 == 0 else (4 if m % 4 == 0 else 1)


@dataclass(frozen=True)
class GatherPlan:
    unit: int         # bytes per copy: 16, 4 or 1
    threads: int      # a block's threads, one unit each a pass
    slabs: int        # slabs per row, of ``slab_bytes``
    grid_x: int       # gathered rows
    grid_y: int       # blocks per row; block y copies slabs y, y + grid_y, ..

    @property
    def route(self) -> str:
        return f"{self.unit}-byte units"

    @property
    def slab_bytes(self) -> int:
        return self.threads * self.unit

    def slab_range(self, row_bytes: int, j: int):
        """Bytes ``[lo, hi)`` of slab ``j`` of a row."""
        lo = j * self.slab_bytes
        return lo, min(lo + self.slab_bytes, row_bytes)

    def block_slabs(self, y: int) -> range:
        """The slabs that block ``y`` of a row copies."""
        return range(y, self.slabs, self.grid_y)


def gather_plan(row_bytes: int, align: int, count: int) -> GatherPlan:
    """The plan for ``count`` rows of ``row_bytes`` bytes, where ``align``
    is an integer that both base pointers are multiples of (e.g. their
    bitwise or): the widest unit they and the row length allow, and up to
    ``GATHER_THREADS`` threads a block, fewer (a whole warp) for a short
    row."""
    unit = _unit(align, row_bytes)
    units = row_bytes // unit
    if row_bytes <= 0 or count < 0 or units > GATHER_MAX_UNITS:
        raise ValueError(f"indirect_gather: no plan for {count} rows of "
                         f"{row_bytes} bytes")
    threads = min(GATHER_THREADS, 32 * -(-units // 32))
    slabs = -(-units // threads)
    return GatherPlan(unit=unit, threads=threads, slabs=slabs, grid_x=count,
                      grid_y=min(slabs, GRID_Y_MAX))


def _align16(n: int) -> int:
    return -(-n // 16) * 16


def _pow2_at_least(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


@dataclass(frozen=True)
class SpmvPlan:
    vec: int          # entries of vals and of cols a load: 4 or 1
    lanes: int        # lanes a row: a power of two, at most 32
    threads: int
    blocks: int

    @property
    def route(self) -> str:
        return f"{self.vec}-entry loads, {self.lanes} lanes a row"

    def lane_entries(self, k: int, lane: int):
        """The entries of a row of K = ``k`` that ``lane`` sums, in the
        kernel's order (load, then entry of the load)."""
        return [e for i in range(lane, k // self.vec, self.lanes)
                for e in range(i * self.vec, (i + 1) * self.vec)]

    def block_rows(self, b: int, rows: int) -> range:
        """The rows that block ``b`` computes (the rest of it is masked)."""
        per = self.threads // self.lanes
        return range(min(b * per, rows), min((b + 1) * per, rows))


def spmv_plan(rows: int, k: int, aligned: bool) -> SpmvPlan:
    """The plan for ``rows`` rows of K = ``k`` entries; ``aligned``: vals
    and cols both start on 16 bytes.  K = 0 gives zeros.  Raises where the
    grid would exceed the card's 2**31 - 1 blocks or a size is negative."""
    if rows < 0 or k < 0:
        raise ValueError(f"spmv_ell: no plan for {rows} rows of K = {k}")
    vec = 4 if aligned and k % 4 == 0 and k > 0 else 1
    loads = k // vec
    lanes = min(32, _pow2_at_least(loads))
    blocks = -(-rows * lanes // SPMV_THREADS)
    if blocks > 2**31 - 1:
        raise ValueError(f"spmv_ell: {rows} rows need {blocks} blocks, more "
                         f"than the card's 2**31 - 1")
    return SpmvPlan(vec=vec, lanes=lanes, threads=SPMV_THREADS, blocks=max(blocks, 1))


@dataclass(frozen=True)
class PanelPlan:
    route: str        # "bulk" or "cp.async"
    tile_rows: int    # rows a block computes (the last tile may be short)
    pack: int         # row blocks a tile spans (split == 1 where pack > 1)
    split: int        # tiles per row block (pack == 1 where split > 1)
    blocks: int
    panels_bytes: int  # shared memory: panels, vals, cols, step partials
    vals_bytes: int
    part_bytes: int
    smem_bytes: int   # the four regions, each 16-byte aligned, + mbarrier

    def tile_rows_range(self, t: int, row_blocks: int, row_block: int):
        """Rows ``[r0, r1)`` of tile ``t``, as the kernel computes them."""
        group, sub = divmod(t, self.split)
        first = group * self.pack
        r0 = first * row_block + sub * self.tile_rows
        end = min(first + self.pack, row_blocks) * row_block
        return r0, min(r0 + self.tile_rows, end)


def _panel_layout(route, tile, pack, split, row_blocks, k, steps, panel):
    panels = _align16(pack * steps * panel * 4)
    vals = _align16(tile * k * 4)
    part = _align16(tile * steps * 4)
    return PanelPlan(
        route=route, tile_rows=tile, pack=pack, split=split,
        blocks=-(-row_blocks // pack) * split, panels_bytes=panels,
        vals_bytes=vals, part_bytes=part,
        smem_bytes=panels + 2 * vals + part + 16)


def panel_plan(row_blocks: int, row_block: int, k: int, steps: int,
               panel: int, aligned: bool) -> PanelPlan:
    """The plan for ``row_blocks`` row blocks of ``row_block`` rows of K = k
    entries in ``steps`` steps over panels of ``panel`` columns.
    ``aligned``: x, vals and cols all start on 16 bytes.  ``bulk`` where it
    can serve the call, else ``cp.async``."""
    if min(row_blocks, row_block, k, steps, panel) <= 0 or k % steps:
        raise ValueError(
            f"spmv_ell_panel_kernel: no plan for {row_blocks} row blocks of "
            f"{row_block} rows, K = {k} in {steps} steps, panel {panel}")
    bulk = aligned and panel % 4 == 0 and (row_block * k) % 4 == 0
    route = "bulk" if bulk else "cp.async"
    # Rows per tile come in granules whose vals are a multiple of 16 bytes.
    gran = 4 // math.gcd(k, 4) if route == "bulk" else 1
    target = max(1, -(-PANEL_TILE_BYTES // (k * 8)))
    if row_block >= target:
        pack = 1
        rows = -(-row_block // -(-row_block // target))  # even split
        tile = -(-rows // gran) * gran
    else:
        pack = min(row_blocks, target // row_block)
        tile = pack * row_block
    while True:
        split = -(-row_block // tile) if pack == 1 else 1
        plan = _panel_layout(route, tile, pack, split, row_blocks, k, steps,
                             panel)
        if plan.smem_bytes <= SMEM_PER_BLOCK:
            return plan
        if pack > 1:
            pack = -(-pack // 2)
            tile = pack * row_block
        elif tile > gran:
            tile = max(gran, -(-(tile // 2) // gran) * gran)
        else:
            raise ValueError(
                f"spmv_ell_panel_kernel: {steps} panels of {panel} and "
                f"{tile} rows of K = {k} need {plan.smem_bytes} bytes of "
                f"shared memory, more than a block's {SMEM_PER_BLOCK}")


#: The plan fields the attention kernels' C entries take, in this order,
#: as one int array (``struct Plan`` of ``paged_split.cuh``).
ATTENTION_FIELDS = ("span", "spans", "kv_tile", "tq", "tile_rows",
                    "q_tiles", "threads", "unit", "k_off", "v_off",
                    "raw_off", "pt_off", "alpha_off", "k_stage", "v_stage",
                    "raw_stage", "smem_bytes", "combine_blocks")


@dataclass(frozen=True)
class AttentionPlan:
    kind: str         # "decode" or "prefill" (verify is a prefill launch)
    rows: int         # R (B for decode)
    chunk: int        # C query positions a row (1 for decode)
    heads: int
    kv_heads: int
    head_dim: int
    page: int
    table_pages: int  # page-table entries a row (the walk never passes them)
    span: int         # context positions a block walks: whole pages, tiles
    spans: int        # spans a row: the table's positions over span
    kv_tile: int      # positions a pipeline stage holds (head_dim / 4)
    tq: int           # query positions a tile
    tile_rows: int    # query rows a block (tq * rep, rounded up)
    q_tiles: int
    threads: int
    unit: int         # cp.async bytes of the q and K/V rows: 16 or 4
    k_off: int        # shared memory regions, bytes from the base (q at 0)
    v_off: int
    raw_off: int      # bf16 rows, int8 codes and scales as loaded
                      # (0 bytes for fp32)
    pt_off: int       # probabilities, kv_tile x (tile_rows + 4)
    alpha_off: int    # a tile's rescale factor per query row
    k_stage: int      # bytes between the two stages of a region
    v_stage: int
    raw_stage: int
    smem_bytes: int
    combine_blocks: int

    @property
    def rep(self) -> int:
        return self.heads // self.kv_heads

    @property
    def grid(self):
        """``(spans, q_tiles * kv_heads, rows)``."""
        return (self.spans, self.q_tiles * self.kv_heads, self.rows)

    @property
    def queries(self) -> int:
        return self.rows * self.chunk * self.heads

    @property
    def scratch_floats(self) -> int:
        """Partials: an accumulator of head_dim floats, then max and sum,
        for every (query, span)."""
        return self.queries * self.spans * (self.head_dim + 2)

    @property
    def route(self) -> str:
        return (f"split-KV: spans of {self.span} positions "
                f"({self.span // self.page} pages), tiles of "
                f"{self.tile_rows} query rows in {self.threads} threads, "
                f"kv tiles of {self.kv_tile} in 2 cp.async stages of "
                f"{self.unit}-byte copies, then a combine in span order")

    def launch_fields(self):
        return tuple(getattr(self, f) for f in ATTENTION_FIELDS)

    def row_bounds(self, start: int, count: int):
        """``(start, live)`` as the kernels read a row: decode passes its
        length as ``start`` and ``count=None``."""
        if count is None:
            n = min(max(start, 0), self.table_pages * self.page)
            return n - 1, n
        return start, (start + count if count > 0 else 0)

    def visible_end(self, start: int, count: int, c: int) -> int:
        """Query ``c`` of a row sees positions ``[0, visible_end)``."""
        st, live = self.row_bounds(start, count)
        return max(0, min(st + c + 1, live, self.table_pages * self.page))

    def query_spans(self, start: int, count: int, c: int) -> int:
        """Spans the combine adds for query ``c`` of a row, in order."""
        return -(-self.visible_end(start, count, c) // self.span)

    def block_positions(self, s: int, tile: int, start: int, count: int):
        """Context positions ``[lo, hi)`` that block (span ``s``, ``tile``)
        of a row loads; empty where the span is masked for the whole
        tile, and then the block loads no page."""
        st, live = self.row_bounds(start, count)
        c0 = tile * self.tq
        nq = min(self.tq, self.chunk - c0)
        hi = min(st + c0 + nq, live, self.table_pages * self.page)
        lo = s * self.span
        return lo, max(lo, min(lo + self.span, hi))


def _lcm(a: int, b: int) -> int:
    return a * b // math.gcd(a, b)


@functools.lru_cache(maxsize=1024)
def attention_plan(kind: str, rows: int, chunk: int, heads: int,
                   kv_heads: int, head_dim: int, page: int,
                   table_pages: int, elem_bytes: int,
                   align: int) -> AttentionPlan:
    """The plan of one paged attention launch.  ``kind`` names the span
    constant ("decode" or "prefill"); ``elem_bytes`` is the pools'
    element: 4 (fp32), 2 (bf16) or 1 (int8 codes with fp32 scales);
    ``align`` is an integer that the q, K and V base pointers are all
    multiples of (their bitwise or).  The
    span, the kv tile and so every row's split depend only on ``kind``,
    ``head_dim`` and ``page``: never on the rows, the table's width or
    the other rows' lengths.  Shapes no plan serves raise ``ValueError``.
    Plans are cached: pass ``align`` reduced to 16, 4 or 1 (as
    :mod:`.ops` does) so that calls of one shape share theirs."""
    if kind not in ("decode", "prefill"):
        raise ValueError(f"attention_plan: unknown kind {kind!r}")
    d = head_dim
    rep = heads // max(kv_heads, 1)
    if (min(rows, chunk, heads, kv_heads, page, table_pages) <= 0
            or heads % kv_heads or d not in ATTN_HEAD_DIMS):
        raise ValueError(
            f"paged attention: no plan for {rows} rows of {chunk} queries, "
            f"{heads} heads over {kv_heads} kv heads of {d} (head_dim must "
            f"be one of {ATTN_HEAD_DIMS}), page {page}, {table_pages} "
            f"table pages")
    if elem_bytes not in ATTN_ELEM_BYTES:
        raise ValueError(f"paged attention: pool elements of {elem_bytes} "
                         f"bytes; have {sorted(ATTN_ELEM_BYTES)}")
    kv_tile = d // 4
    unit = _unit(align, d * elem_bytes)
    if unit == 1:
        raise ValueError(f"paged attention: rows of {d} "
                         f"{ATTN_ELEM_BYTES[elem_bytes]} elements at an "
                         f"address off 4-byte alignment have no cp.async "
                         f"unit")
    target = DECODE_SPAN if kind == "decode" else PREFILL_SPAN
    base = _lcm(page, kv_tile)
    span = base * max(1, target // base)
    spans = -(-table_pages * page // span)
    tq = min(chunk, max(1, (ATTN_TILE_FLOATS // d) // rep))
    step = 1024 // d           # rows that make a whole warp of threads
    tile_rows = -(-tq * rep // step) * step
    threads = tile_rows * d // 32
    if threads > ATTN_MAX_THREADS:
        raise ValueError(f"paged attention: {rep} query heads a kv head of "
                         f"{d} need {threads} threads, more than "
                         f"{ATTN_MAX_THREADS}")
    q_bytes = tile_rows * d * 4
    # fp32 rows land in two stages of the fp32 tiles.  Narrow rows (bf16,
    # int8 codes and their scales) land in two raw stages and are widened
    # into one stage of the fp32 tiles: a second would hold nothing the
    # raw stage does not already keep in flight.
    narrow = elem_bytes < 4
    stages = 1 if narrow else 2
    k_stage = kv_tile * (d + 4) * 4
    v_stage = kv_tile * d * 4
    scales = 8 * kv_tile if elem_bytes == 1 else 0
    raw_stage = (_align16(2 * kv_tile * d * elem_bytes + scales) if narrow
                 else 0)
    k_off = q_bytes
    v_off = k_off + stages * k_stage
    raw_off = v_off + stages * v_stage
    pt_off = raw_off + 2 * raw_stage
    alpha_off = pt_off + kv_tile * (tile_rows + 4) * 4
    smem = alpha_off + _align16(tile_rows * 4)
    if smem > SMEM_PER_BLOCK:
        raise ValueError(f"paged attention: {smem} bytes of shared memory, "
                         f"more than a block's {SMEM_PER_BLOCK}")
    queries = rows * chunk * heads
    return AttentionPlan(
        kind=kind, rows=rows, chunk=chunk, heads=heads, kv_heads=kv_heads,
        head_dim=d, page=page, table_pages=table_pages, span=span,
        spans=spans, kv_tile=kv_tile, tq=tq, tile_rows=tile_rows,
        q_tiles=-(-chunk // tq), threads=threads, unit=unit, k_off=k_off,
        v_off=v_off, raw_off=raw_off, pt_off=pt_off, alpha_off=alpha_off,
        k_stage=k_stage, v_stage=v_stage, raw_stage=raw_stage,
        smem_bytes=smem,
        combine_blocks=-(-queries * (d // 4) // COMBINE_THREADS))

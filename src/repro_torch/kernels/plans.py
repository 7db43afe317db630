"""Launch plans of the indirect gather and the panel SpMV, chosen on the host.

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
"""
from __future__ import annotations

import math
from dataclasses import dataclass

__all__ = ["GatherPlan", "PanelPlan", "SMEM_PER_BLOCK", "gather_plan",
           "panel_plan"]

#: Dynamic shared memory one block may use on Hopper (H100, H200).
SMEM_PER_BLOCK = 232448
GRID_Y_MAX = 65535
GATHER_THREADS = 256      # a block's threads: a 4 KB slab of 16-byte units
GATHER_MAX_UNITS = 1 << 30  # the kernel indexes a row's units in 32 bits
PANEL_ROUTES = ("bulk", "cp.async")
PANEL_TILE_BYTES = 16384  # vals + cols bytes a tile aims at


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

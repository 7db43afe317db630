"""The host-side launch plans of the indirect gather, the ELL SpMV and the
panel SpMV (``repro_torch.kernels.plans``), checked as plain Python.

Every gather plan must cover each byte of each row exactly once, in units
that the row length and the pointers allow; every ELL SpMV plan must give
each entry of a row to exactly one lane and each row to one block, with
16-byte loads exactly where K and the alignment allow; every panel plan
must cover
each row exactly once, keep a tile inside its row block where it splits
one, take the bulk route exactly where its copies can serve the call, and
fit a block's shared memory, or raise naming shared memory.  The kernels follow the same arithmetic on the card
(``tests/test_torch_kernels.py`` and ``tests/test_torch_workloads.py``
hold them against their plain versions there).
"""
import itertools

import pytest

from repro_torch.kernels import plans
from repro_torch.kernels.plans import (SMEM_PER_BLOCK, gather_plan,
                                       panel_plan, spmv_plan)

# ---------------------------------------------------------------------------
# Gather
# ---------------------------------------------------------------------------

ROW_BYTES = [1, 3, 15, 16, 256, 1000, 4096, 4099, 8192, 32768, 65540,
             4096 * 65535 + 16]
ALIGNS = [0, 1, 2, 4, 8, 16, 4096 + 4]  # the or of the two base pointers
COUNTS = [0, 1, 24, 1000]


def _covers_once(intervals, total):
    """The half-open intervals tile [0, total) without gap or overlap."""
    pos = 0
    for lo, hi in sorted(intervals):
        if lo != pos or hi <= lo:
            return False
        pos = hi
    return pos == total


@pytest.mark.parametrize("row_bytes,align,count",
                         list(itertools.product(ROW_BYTES, ALIGNS, COUNTS)))
def test_gather_plan_covers_each_byte_once(row_bytes, align, count):
    plan = gather_plan(row_bytes, align, count)
    assert plan.grid_x == count and 1 <= plan.grid_y <= plans.GRID_Y_MAX
    pieces = [plan.slab_range(row_bytes, j)
              for y in range(plan.grid_y) for j in plan.block_slabs(y)]
    assert len(pieces) == plan.slabs
    assert _covers_once(pieces, row_bytes)
    # Every piece is whole units at unit-aligned offsets of both rows.
    unit = plan.unit
    assert unit in (1, 4, 16)
    assert row_bytes % unit == 0 and (align % unit == 0 or align == 0)
    assert plan.slab_bytes == plan.threads * unit
    assert 32 <= plan.threads <= plans.GATHER_THREADS
    assert plan.threads % 32 == 0


@pytest.mark.parametrize("row_bytes,align,unit", [
    (32768, 0, 16), (256, 256, 16), (16, 0, 16), (4099, 0, 1),
    (32768, 4, 4), (8192, 16 + 8, 4), (12, 0, 4), (4108, 4096 + 4, 4),
    (4099, 4096 + 3, 1),
])
def test_gather_plan_takes_the_widest_unit_that_fits(row_bytes, align,
                                                     unit):
    plan = gather_plan(row_bytes, align, 24)
    assert plan.unit == unit and plan.route == f"{unit}-byte units"


@pytest.mark.parametrize("row_bytes,align", [(0, 0), ((1 << 30) + 1, 0),
                                             ((1 << 32) + 4, 4)])
def test_gather_plan_refuses_empty_and_oversized_rows(row_bytes, align):
    """No plan for an empty row, or for one of more units than the kernel
    indexes in 32 bits; 2**30 units of 16 bytes still have one."""
    with pytest.raises(ValueError, match="no plan"):
        gather_plan(row_bytes, align, 8)
    assert gather_plan(1 << 34, 0, 8).unit == 16


@pytest.mark.parametrize("row_bytes,threads,slabs", [
    (32768, 256, 8),        # fp32 pages: 4 KB slabs, 192 blocks for 24 rows
    (8192, 256, 2),         # int8 codes
    (256, 32, 1),           # int8 scales: a warp, 16 units busy
    (4099, 256, 17),        # odd width: 1-byte units
])
def test_gather_plan_at_the_paged_path_shapes(row_bytes, threads, slabs):
    """The prefill window read: 24 rows of 32 KB (fp32), 8 KB (int8 codes)
    and 256 B (scales), one unit a thread, every slab its own block."""
    plan = gather_plan(row_bytes, 0, 24)
    assert (plan.threads, plan.slabs, plan.grid_y) == (threads, slabs, slabs)


# ---------------------------------------------------------------------------
# ELL SpMV
# ---------------------------------------------------------------------------

SPMV_KS = [0, 1, 3, 4, 5, 8, 32, 33, 64, 1000, 1024]


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("k", SPMV_KS)
def test_spmv_plan_covers_each_entry_once(k, aligned):
    """Every entry of a row goes to exactly one lane, each lane's entries
    in increasing order; 16-byte loads exactly where K % 4 == 0 and both
    operands are aligned; a load a lane where possible."""
    plan = spmv_plan(1000, k, aligned)
    assert plan.vec == (4 if aligned and k % 4 == 0 and k else 1)
    assert plan.lanes in (1, 2, 4, 8, 16, 32)
    entries = [plan.lane_entries(k, lane) for lane in range(plan.lanes)]
    assert sorted(e for lane in entries for e in lane) == list(range(k))
    for lane in entries:
        assert lane == sorted(lane)
        # Whole loads, and every load of a lane at a vec-aligned entry.
        assert len(lane) % plan.vec == 0
        assert all(e % plan.vec == 0 for e in lane[::plan.vec])
    # A load a lane where the row allows it: no fewer lanes than loads
    # below 32, and no lane without a load.
    loads = k // plan.vec
    assert plan.lanes == 32 or plan.lanes >= loads
    assert plan.lanes // 2 < max(loads, 1)


@pytest.mark.parametrize("rows", [1, 7, 63, 64, 65, 1000, 4099])
@pytest.mark.parametrize("k,aligned", [(1, True), (5, False), (32, True),
                                       (33, True), (1024, True)])
def test_spmv_plan_covers_each_row_once(rows, k, aligned):
    plan = spmv_plan(rows, k, aligned)
    assert plan.threads == plans.SPMV_THREADS
    assert plan.threads % plan.lanes == 0
    spans = [plan.block_rows(b, rows) for b in range(plan.blocks)]
    assert _covers_once([(r.start, r.stop) for r in spans if len(r)], rows)
    assert len(spans[-1]) > 0  # no block without a row


def test_spmv_plan_at_the_workload_shape():
    """2**22 rows of K = 32: 8 lanes a row, one float4 of vals and cols a
    lane, so a warp's load reads four whole 128-byte rows."""
    plan = spmv_plan(1 << 22, 32, True)
    assert (plan.vec, plan.lanes) == (4, 8)
    assert plan.blocks == (1 << 22) * 8 // 256
    assert plan.lane_entries(32, 1) == [4, 5, 6, 7]
    # K = 256 and K = 33 take two loads a lane, 32 lanes apart.
    assert spmv_plan(8, 256, True).lane_entries(256, 0) == [
        0, 1, 2, 3, 128, 129, 130, 131]
    assert spmv_plan(8, 33, True).lanes == 32
    assert spmv_plan(8, 33, True).lane_entries(33, 0) == [0, 32]


@pytest.mark.parametrize("rows,k", [(-1, 4), (8, -1), (1 << 40, 32)])
def test_spmv_plan_refuses_negative_sizes_and_oversized_grids(rows, k):
    with pytest.raises(ValueError, match="spmv_ell"):
        spmv_plan(rows, k, True)


def test_spmv_plan_of_empty_rows_sums_nothing():
    """K = 0 (rows of no entries) has a plan, whose lanes load nothing: the
    kernel writes zeros, as the plain version's empty sums."""
    plan = spmv_plan(7, 0, True)
    assert (plan.vec, plan.lanes) == (1, 1)
    assert plan.lane_entries(0, 0) == []


# ---------------------------------------------------------------------------
# Panel SpMV
# ---------------------------------------------------------------------------

PANEL_CASES = [
    # row_blocks, row_block, k, steps, panel
    (16384, 64, 32, 4, 512),      # chip_smoke's 2**20 rows
    (2, 8, 8, 2, 512), (3, 4, 12, 3, 64), (1, 5, 4, 1, 32), (1, 5, 4, 1, 6),
    (512, 64, 32, 4, 512), (8, 300, 6, 2, 8192), (4, 100, 3, 3, 512),
    (16, 300, 9, 3, 1024), (2, 2000, 32, 4, 512), (64, 8, 8, 2, 256),
    (7, 3, 5, 5, 100), (1, 100000, 2, 1, 64), (3, 1, 1, 1, 4),
    (2, 4096, 64, 8, 4096), (5, 33, 7, 7, 8),
]


def _check_panel_plan(plan, row_blocks, row_block, k, steps, panel):
    assert plan.route in plans.PANEL_ROUTES
    assert plan.smem_bytes <= SMEM_PER_BLOCK
    assert plan.pack >= 1 and plan.split >= 1
    assert plan.pack == 1 or plan.split == 1
    r = row_blocks * row_block
    tiles = [plan.tile_rows_range(t, row_blocks, row_block)
             for t in range(plan.blocks)]
    assert _covers_once(tiles, r)
    for r0, r1 in tiles:
        assert r1 - r0 <= plan.tile_rows
        first, last = r0 // row_block, (r1 - 1) // row_block
        if plan.split > 1:
            assert first == last  # a split tile stays in its row block
        # The panels of every row block the tile spans fit its region.
        assert (last - first + 1) * steps * panel * 4 <= plan.panels_bytes
        if plan.route == "bulk":  # whole 16-byte bulk copies
            assert (r0 * k * 4) % 16 == 0 and ((r1 - r0) * k * 4) % 16 == 0
    assert plan.vals_bytes >= plan.tile_rows * k * 4
    assert plan.part_bytes >= plan.tile_rows * steps * 4
    for region in (plan.panels_bytes, plan.vals_bytes, plan.part_bytes):
        assert region % 16 == 0


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("row_blocks,row_block,k,steps,panel", PANEL_CASES)
def test_panel_plan_covers_each_row_once_within_shared_memory(
        row_blocks, row_block, k, steps, panel, aligned):
    plan = panel_plan(row_blocks, row_block, k, steps, panel, aligned)
    bulk_ok = aligned and panel % 4 == 0 and (row_block * k) % 4 == 0
    assert plan.route == ("bulk" if bulk_ok else "cp.async")
    _check_panel_plan(plan, row_blocks, row_block, k, steps, panel)


def test_panel_plan_at_chip_smoke_shape_is_one_row_block_a_block():
    """2**20 rows in row blocks of 64, K = 32 in 4 steps of 512-wide
    panels: 16 KB of vals and cols and 8 KB of panels a block."""
    plan = panel_plan(16384, 64, 32, 4, 512, True)
    assert (plan.route, plan.tile_rows, plan.pack, plan.split,
            plan.blocks) == ("bulk", 64, 1, 1, 16384)
    assert plan.smem_bytes == 8192 + 2 * 8192 + 1024 + 16


def test_panel_plan_packs_small_and_splits_large_row_blocks():
    small = panel_plan(64, 8, 8, 2, 256, True)
    assert small.pack > 1 and small.split == 1
    assert small.tile_rows == small.pack * 8
    large = panel_plan(2, 2000, 32, 4, 512, True)
    assert large.pack == 1 and large.split > 1
    # Shared memory, not the target, forces a split of a row block of
    # 300 rows beside two 32 KB panels.
    assert panel_plan(8, 300, 6, 2, 8192, True).split == 1


@pytest.mark.parametrize("steps,panel", [(8, 8192), (1, 60000)])
def test_panel_plan_raises_naming_shared_memory(steps, panel):
    with pytest.raises(ValueError, match="shared memory"):
        panel_plan(4, 64, 8 * steps, steps, panel, True)


@pytest.mark.parametrize("aligned,panel,row_block,k", [
    (False, 512, 64, 32), (True, 6, 64, 32), (True, 512, 5, 3)])
def test_panel_plan_takes_cp_async_where_bulk_copies_cannot_serve(
        aligned, panel, row_block, k):
    assert panel_plan(2, row_block, k, 1, panel, aligned).route == \
        "cp.async"


def test_panel_plan_refuses_bad_shapes():
    with pytest.raises(ValueError, match="no plan"):
        panel_plan(2, 8, 9, 2, 512, True)

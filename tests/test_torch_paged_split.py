"""The split-KV layout of the paged decode and prefill/verify kernels.

On the CPU, :func:`repro_torch.kernels.plans.attention_plan` as plain
Python: every visible position of every query is covered by exactly one
span; a block whose span is masked for its whole tile loads nothing; a
row's span and split do not depend on the batch, the table's width or the
other rows' lengths; and the scratch holds every partial of the largest
shapes ``chip_smoke.py`` launches.  The split itself (per-span partials,
then a combine in span order) is emulated in float64 from the plan's
block ranges and held against the plain versions.

On the card (marked ``cuda``, skipped elsewhere; ``python -m pytest -m
cuda tests/test_torch_paged_split.py``) both kernels against their plain
versions within rtol = atol = 1e-5, at fp32 and int8 with GQA, at lengths
0, 1, a span multiple, a span +- 1 and a page boundary, with padding rows,
chunks that straddle a page and NaN in every unmapped page; and bitwise:
two calls alike, and a row alone alike the same row in a batch of 8 with
other lengths and a wider page table.
"""
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, plans  # noqa: E402

ATOL = RTOL = 1e-5

#: (kind, rows, chunk, heads, kv_heads, head_dim, page, table_pages): the
#: largest launches of chip_smoke.py (yi-6b, batch 8, page 16, max_len 512,
#: chunk 32, spec_k 4) and the smaller test shapes.
SMOKE_SHAPES = {
    "decode": ("decode", 8, 1, 32, 4, 128, 16, 32),
    "prefill": ("prefill", 8, 32, 32, 4, 128, 16, 32),
    "verify": ("prefill", 8, 4, 32, 4, 128, 16, 32),
}
SMALL_SHAPES = {
    "d16 page 4": ("prefill", 3, 4, 4, 2, 16, 4, 6),
    "d32 mha": ("prefill", 2, 8, 4, 4, 32, 8, 8),
    "decode d16": ("decode", 3, 1, 8, 1, 16, 4, 6),
    "d64 rep 4": ("prefill", 4, 16, 8, 2, 64, 16, 9),
}
ALL_SHAPES = {**SMOKE_SHAPES, **SMALL_SHAPES}


def _plan(shape, elem_bytes=4, align=256):
    return plans.attention_plan(*shape, elem_bytes=elem_bytes, align=align)


def _rows(plan, rng):
    """(start, count) per row, decode lengths as (length, None), covering
    empty rows, a span multiple, span +- 1 and a page boundary."""
    cap = plan.table_pages * plan.page
    specials = [0, 1, plan.span, plan.span - 1, plan.span + 1, plan.page,
                cap]
    out = []
    for i in range(plan.rows):
        n = specials[i] if i < len(specials) else int(rng.integers(0, cap))
        if plan.kind == "decode":
            out.append((n, None))
        else:
            count = 0 if i == 1 else int(rng.integers(1, plan.chunk + 1))
            out.append((max(0, min(n, cap) - count), count))
    return out


@pytest.mark.parametrize("name", sorted(ALL_SHAPES))
def test_each_visible_position_is_in_exactly_one_span(name):
    plan = _plan(ALL_SHAPES[name])
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    for start, count in _rows(plan, rng):
        for tile in range(plan.q_tiles):
            ranges = [plan.block_positions(s, tile, start, count)
                      for s in range(plan.spans)]
            c0 = tile * plan.tq
            for c in range(c0, min(c0 + plan.tq, plan.chunk)):
                end = plan.visible_end(start, count, c)
                n_s = plan.query_spans(start, count, c)
                cover = np.zeros(max(end, 1), int)
                for s in range(n_s):
                    lo, hi = ranges[s]
                    assert lo == s * plan.span and hi > lo
                    cover[lo:min(hi, end)] += 1
                assert (cover[:end] == 1).all()
                # The spans past the query's own are masked for it alone.
                assert n_s * plan.span >= end > (n_s - 1) * plan.span or (
                    end == 0 and n_s == 0)


@pytest.mark.parametrize("name", sorted(ALL_SHAPES))
def test_masked_span_blocks_load_no_page(name):
    """A block past its tile's last visible position loads nothing, and no
    block reads a position past the row's written context or its table."""
    plan = _plan(ALL_SHAPES[name])
    cap = plan.table_pages * plan.page
    rng = np.random.default_rng(zlib.crc32(name.encode()) + 1)
    for start, count in _rows(plan, rng):
        _, live = plan.row_bounds(start, count)
        for tile in range(plan.q_tiles):
            c_last = min((tile + 1) * plan.tq, plan.chunk) - 1
            seen = plan.visible_end(start, count, c_last)
            for s in range(plan.spans):
                lo, hi = plan.block_positions(s, tile, start, count)
                if s * plan.span >= seen:
                    assert hi == lo
                assert hi <= min(max(live, 0), cap) or hi == lo


@pytest.mark.parametrize("name", sorted(ALL_SHAPES))
def test_split_of_a_row_does_not_depend_on_the_batch(name):
    """Span, kv tile and a row's spans are the same at any R/B, table
    width (covering the row) and other rows' lengths."""
    kind, rows, chunk, h, kvh, d, page, pages = ALL_SHAPES[name]
    base = _plan(ALL_SHAPES[name])
    for r2 in (1, rows, 8, 33):
        for p2 in (pages, pages + 1, 2 * pages + 3):
            other = plans.attention_plan(kind, r2, chunk, h, kvh, d, page,
                                         p2, elem_bytes=4, align=256)
            assert (other.span, other.kv_tile, other.tq) == (
                base.span, base.kv_tile, base.tq)
            for start, count in ((0, 1), (base.span + 1, 3), (7, 0)):
                if kind == "decode":
                    start, count = start + 1, None
                live = start if count is None else start + count
                if live > pages * page:
                    continue        # the narrowest table must hold the row
                for c in range(chunk):
                    assert other.query_spans(start, count, c) == \
                        base.query_spans(start, count, c)
    for elem_bytes in (4, 2, 1):
        q = _plan(ALL_SHAPES[name], elem_bytes=elem_bytes, align=4)
        assert (q.span, q.kv_tile, q.tq) == (base.span, base.kv_tile,
                                             base.tq)


@pytest.mark.parametrize("name", sorted(SMOKE_SHAPES))
def test_scratch_holds_every_partial_of_the_smoke_shapes(name):
    """Every (query, span) slot that a block writes is inside the plan's
    scratch, and no two blocks write one slot."""
    plan = _plan(SMOKE_SHAPES[name])
    rng = np.random.default_rng(7)
    rows = _rows(plan, rng)
    rep = plan.rep
    slots = set()
    for r, (start, count) in enumerate(rows):
        for tile in range(plan.q_tiles):
            c0 = tile * plan.tq
            for g in range(plan.kv_heads):
                for s in range(plan.spans):
                    lo, hi = plan.block_positions(s, tile, start, count)
                    if hi == lo:
                        continue
                    for c in range(c0, min(c0 + plan.tq, plan.chunk)):
                        for hr in range(rep):
                            qi = (r * plan.chunk + c) * plan.heads \
                                + g * rep + hr
                            slot = qi * plan.spans + s
                            assert slot not in slots
                            slots.add(slot)
    assert max(slots) < plan.queries * plan.spans
    assert plan.scratch_floats == \
        plan.queries * plan.spans * (plan.head_dim + 2)
    assert plan.scratch_floats * 4 <= 64 << 20
    assert plan.smem_bytes <= plans.SMEM_PER_BLOCK
    assert plan.threads <= plans.ATTN_MAX_THREADS
    assert plan.threads * 32 == plan.tile_rows * plan.head_dim


def test_smoke_shapes_fill_the_card():
    """Decode at chip_smoke.py's kernel lengths (its prompts plus half the
    new tokens) has at least 132 blocks with work on 132 SMs."""
    import chip_smoke

    plan = _plan(SMOKE_SHAPES["decode"])
    lens = [len(p) + chip_smoke.MAX_NEW // 2
            for p in chip_smoke.make_prompts(64000)]
    busy = sum(plan.kv_heads for n in lens for s in range(plan.spans)
               if plan.block_positions(s, 0, n, None)[1] >
               plan.block_positions(s, 0, n, None)[0])
    assert busy >= 132


def test_unplannable_shapes_raise():
    with pytest.raises(ValueError, match="head_dim"):
        plans.attention_plan("decode", 2, 1, 4, 2, 24, 4, 4, 4, 256)
    with pytest.raises(ValueError, match="threads"):
        plans.attention_plan("prefill", 2, 4, 512, 2, 128, 4, 4, 4, 256)
    with pytest.raises(ValueError, match="kind"):
        plans.attention_plan("verify", 2, 4, 8, 2, 128, 4, 4, 4, 256)


# ---------------------------------------------------------------------------
# The split emulated from the plan, in float64, against the plain version
# ---------------------------------------------------------------------------


def _emulate(plan, q, kg, vg, rows, scale):
    """Per-span partials of every query from the plan's block ranges,
    combined in span order.  q (R, C, H, D); kg/vg (R, S, KVH, D) are the
    rows' context in position order."""
    out = np.zeros(q.shape)
    rep = plan.rep
    for r, (start, count) in enumerate(rows):
        for c in range(plan.chunk):
            tile = c // plan.tq
            end = plan.visible_end(start, count, c)
            for h in range(plan.heads):
                g = h // rep
                parts = []
                for s in range(plan.query_spans(start, count, c)):
                    lo, hi = plan.block_positions(s, tile, start, count)
                    hi = min(hi, end)
                    sc = kg[r, lo:hi, g] @ q[r, c, h] * scale
                    m = sc.max()
                    p = np.exp(sc - m)
                    parts.append((m, p.sum(), p @ vg[r, lo:hi, g]))
                if not parts:
                    continue
                mx = max(m for m, _, _ in parts)
                num = sum(a * np.exp(m - mx) for m, _, a in parts)
                den = sum(l * np.exp(m - mx) for m, l, _ in parts)
                out[r, c, h] = num / den
    return out


@pytest.mark.parametrize("name", sorted(SMALL_SHAPES))
def test_emulated_split_matches_the_plain_version(name):
    kind, r, c, h, kvh, d, page, pages = SMALL_SHAPES[name]
    plan = _plan(SMALL_SHAPES[name])
    rng = np.random.default_rng(zlib.crc32(name.encode()) + 2)
    rows = _rows(plan, rng)
    pool = r * pages
    kp = rng.standard_normal((pool, page, kvh, d)).astype(np.float32)
    vp = rng.standard_normal((pool, page, kvh, d)).astype(np.float32)
    table = rng.permutation(pool).reshape(r, pages).astype(np.int32)
    q = rng.standard_normal((r, c, h, d)).astype(np.float32)
    t = torch.from_numpy
    if kind == "decode":
        lens = np.array([n for n, _ in rows], np.int32)
        want = ops.paged_decode_attention(t(q[:, 0]), t(kp), t(vp), t(table),
                                          t(lens))[:, None]
    else:
        st = np.array([s for s, _ in rows], np.int32)
        ct = np.array([n for _, n in rows], np.int32)
        want = ops.paged_prefill_attention(t(q), t(kp), t(vp), t(table),
                                           t(st), t(ct))
    kg = kp[table].reshape(r, pages * page, kvh, d).astype(np.float64)
    vg = vp[table].reshape(r, pages * page, kvh, d).astype(np.float64)
    got = _emulate(plan, q.astype(np.float64), kg, vg, rows, d ** -0.5)
    np.testing.assert_allclose(got, want.numpy(), rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the kernels are CUDA-only")
    return torch.device("cuda")


PAGE, D, TABLE = 16, 128, 12
#: (heads, kv heads): yi-6b's group of 8 and a group of 4.
GROUPS = {"rep8": (32, 4), "rep4": (8, 2)}


def _pools(rng, n_pages, kvh, quantized, dev):
    shape = (n_pages, PAGE, kvh, D)
    if quantized:
        kp = torch.tensor(rng.integers(-127, 128, shape), dtype=torch.int8)
        vp = torch.tensor(rng.integers(-127, 128, shape), dtype=torch.int8)
        ks = torch.tensor(rng.uniform(0.001, 0.02, shape[:3]),
                          dtype=torch.float32)
        vs = torch.tensor(rng.uniform(0.001, 0.02, shape[:3]),
                          dtype=torch.float32)
        return [x.to(dev) for x in (kp, vp, ks, vs)]
    kp = torch.tensor(rng.standard_normal(shape), dtype=torch.float32)
    vp = torch.tensor(rng.standard_normal(shape), dtype=torch.float32)
    return [kp.to(dev), vp.to(dev), None, None]


def _poison(kp, vp, ks, vs, table, live):
    """NaN in every page that no live position maps."""
    used = set()
    for row, n in zip(table.tolist(), live):
        used.update(row[: -(-int(n) // PAGE)])
    dead = torch.tensor([p for p in range(kp.shape[0]) if p not in used],
                        dtype=torch.long, device=kp.device)
    if ks is not None:
        return (kp, vp, ks.clone().index_fill_(0, dead, float("nan")),
                vs.clone().index_fill_(0, dead, float("nan")))
    return (kp.clone().index_fill_(0, dead, float("nan")),
            vp.clone().index_fill_(0, dead, float("nan")), ks, vs)


def _scales(ks, vs):
    return {} if ks is None else dict(k_scale=ks, v_scale=vs)


#: Decode lengths: 0, 1, a span multiple (64), span +- 1, a page boundary,
#: and a full table.
DECODE_LENS = [0, 1, 64, 63, 65, 16, 17, TABLE * PAGE]


@pytest.mark.cuda
@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("group", sorted(GROUPS))
def test_decode_kernel_on_card(cuda, quantized, group):
    h, kvh = GROUPS[group]
    rng = np.random.default_rng(zlib.crc32(f"dec{quantized}{group}".encode()))
    b = len(DECODE_LENS)
    kp, vp, ks, vs = _pools(rng, b * TABLE + 4, kvh, quantized, cuda)
    table = torch.tensor(rng.permutation(b * TABLE + 4)[: b * TABLE]
                         .reshape(b, TABLE), dtype=torch.int32, device=cuda)
    lens = torch.tensor(DECODE_LENS, dtype=torch.int32, device=cuda)
    q = torch.tensor(rng.standard_normal((b, h, D)), dtype=torch.float32,
                     device=cuda)
    kp, vp, ks, vs = _poison(kp, vp, ks, vs, table, DECODE_LENS)
    ops.reset_launch_counts()
    got = ops.paged_decode_attention(q, kp, vp, table, lens,
                                     **_scales(ks, vs))
    again = ops.paged_decode_attention(q, kp, vp, table, lens,
                                       **_scales(ks, vs))
    torch.cuda.synchronize()
    assert ops.paged_decode_attention.launches == 2
    assert torch.isfinite(got).all()
    assert torch.equal(got, again)
    assert not got[0].any()
    # The plain version reads the poisoned pages; hold it on clean ones.
    clean = [x.nan_to_num(0.0) if x is not None else None
             for x in (kp, vp, ks, vs)]
    want = ops.paged_decode_attention(q, clean[0], clean[1], table, lens,
                                      **_scales(clean[2], clean[3]),
                                      impl="ref")
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    # Each row alone, in a one-row batch with a table just wide enough.
    for i, n in enumerate(DECODE_LENS):
        width = max(1, -(-n // PAGE))
        alone = ops.paged_decode_attention(
            q[i:i + 1], kp, vp, table[i:i + 1, :width].contiguous(),
            lens[i:i + 1], **_scales(ks, vs))
        assert torch.equal(alone[0], got[i]), f"row {i} (length {n})"


#: Prefill rows (start, count) of a 32-position chunk: a padding row, a
#: first chunk, chunks straddling pages and spans, a chunk ending on a span
#: boundary, and a short tail.
PREFILL_ROWS = [(0, 32), (0, 0), (5, 32), (32, 32), (60, 9), (96, 32),
                (64, 1), (150, 32)]


def _prefill_case(rng, rows, chunk, h, kvh, quantized, dev, width=TABLE):
    r = len(rows)
    kp, vp, ks, vs = _pools(rng, r * width + 4, kvh, quantized, dev)
    table = torch.tensor(rng.permutation(r * width + 4)[: r * width]
                         .reshape(r, width), dtype=torch.int32, device=dev)
    st = torch.tensor([s for s, _ in rows], dtype=torch.int32, device=dev)
    ct = torch.tensor([c for _, c in rows], dtype=torch.int32, device=dev)
    q = torch.tensor(rng.standard_normal((r, chunk, h, D)),
                     dtype=torch.float32, device=dev)
    live = [s + c if c else 0 for s, c in rows]
    kp, vp, ks, vs = _poison(kp, vp, ks, vs, table, live)
    return q, kp, vp, ks, vs, table, st, ct


@pytest.mark.cuda
@pytest.mark.parametrize("verify", [False, True], ids=["prefill", "verify"])
@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("group", sorted(GROUPS))
def test_prefill_kernel_on_card(cuda, verify, quantized, group):
    h, kvh = GROUPS[group]
    chunk = 4 if verify else 32
    rows = [(s, min(c, chunk)) for s, c in PREFILL_ROWS]
    rng = np.random.default_rng(
        zlib.crc32(f"pre{verify}{quantized}{group}".encode()))
    q, kp, vp, ks, vs, table, st, ct = _prefill_case(
        rng, rows, chunk, h, kvh, quantized, cuda)
    fn = ops.paged_verify if verify else ops.paged_prefill_attention
    ops.reset_launch_counts()
    got = fn(q, kp, vp, table, st, ct, **_scales(ks, vs))
    again = fn(q, kp, vp, table, st, ct, **_scales(ks, vs))
    torch.cuda.synchronize()
    assert fn.launches == 2 and sum(ops.launch_counts().values()) == 2
    assert torch.isfinite(got).all()
    assert torch.equal(got, again)
    assert not got[ct == 0].any()
    clean = [x.nan_to_num(0.0) if x is not None else None
             for x in (kp, vp, ks, vs)]
    want = fn(q, clean[0], clean[1], table, st, ct,
              **_scales(clean[2], clean[3]), impl="ref")
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("verify", [False, True], ids=["prefill", "verify"])
@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
def test_prefill_row_alone_equals_row_in_batch(cuda, verify, quantized):
    """Each row computed alone (R = 1, a table just wide enough) equals,
    bit for bit, the same row inside a batch of 8 with other lengths and a
    wider page table."""
    h, kvh = GROUPS["rep8"]
    chunk = 4 if verify else 32
    rows = [(s, min(c, chunk)) for s, c in PREFILL_ROWS]
    rng = np.random.default_rng(zlib.crc32(f"alone{verify}".encode()))
    q, kp, vp, ks, vs, table, st, ct = _prefill_case(
        rng, rows, chunk, h, kvh, quantized, cuda, width=2 * TABLE)
    fn = ops.paged_verify if verify else ops.paged_prefill_attention
    batch = fn(q, kp, vp, table, st, ct, **_scales(ks, vs))
    for i, (s, c) in enumerate(rows):
        width = max(1, -(-(s + c) // PAGE))
        alone = fn(q[i:i + 1], kp, vp, table[i:i + 1, :width].contiguous(),
                   st[i:i + 1], ct[i:i + 1], **_scales(ks, vs))
        torch.cuda.synchronize()
        assert torch.equal(alone[0], batch[i]), f"row {i} ({s}, {c})"


def _offset_copy(t, offset):
    """A contiguous copy of ``t`` whose data starts ``offset`` bytes past a
    256-byte boundary."""
    flat = t.reshape(-1).view(torch.int8)
    buf = torch.empty(flat.numel() + 256, dtype=torch.int8, device=t.device)
    view = buf[offset:offset + flat.numel()]
    view.copy_(flat)
    return view.view(t.dtype).view(t.shape)


@pytest.mark.cuda
@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
def test_four_byte_copies_give_the_same_bits(cuda, quantized):
    """q 4 bytes off a 16-byte boundary takes the 4-byte cp.async plan; the
    arithmetic is the same, so the output is bitwise the aligned one's."""
    h, kvh = GROUPS["rep8"]
    rng = np.random.default_rng(zlib.crc32(f"unit{quantized}".encode()))
    q, kp, vp, ks, vs, table, st, ct = _prefill_case(
        rng, PREFILL_ROWS, 32, h, kvh, quantized, cuda)
    aligned = ops.paged_prefill_attention(q, kp, vp, table, st, ct,
                                          **_scales(ks, vs))
    assert ops.paged_prefill_attention.plan.unit == 16
    off = ops.paged_prefill_attention(_offset_copy(q, 4), kp, vp, table, st,
                                      ct, **_scales(ks, vs))
    torch.cuda.synchronize()
    assert ops.paged_prefill_attention.plan.unit == 4
    assert torch.equal(off, aligned)


_ORDER_SCRIPT = """
import sys, torch
sys.path.insert(0, sys.argv[1])
from repro_torch.kernels import ops
dev = torch.device("cuda")
kp = torch.randint(-127, 128, (16, 16, 4, 128), dtype=torch.int8, device=dev)
ks = torch.rand((16, 16, 4), device=dev) + 0.01
table = torch.arange(16, dtype=torch.int32, device=dev).view(2, 8)
i32 = lambda *v: torch.tensor(v, dtype=torch.int32, device=dev)
ops.paged_prefill_attention(torch.randn(2, 32, 32, 128, device=dev), kp, kp,
                            table, i32(0, 40), i32(32, 9), k_scale=ks,
                            v_scale=ks)
ops.paged_decode_attention(torch.randn(2, 32, 128, device=dev), kp, kp,
                           table, i32(100, 7), k_scale=ks, v_scale=ks)
torch.cuda.synchronize()
"""


@pytest.mark.cuda
def test_decode_launches_after_prefill_in_a_fresh_process(cuda):
    """The two libraries are loaded side by side; each sets its own
    kernel's shared memory, whichever launches first (int8 prefill needs
    more than int8 decode)."""
    import subprocess
    import sys
    from pathlib import Path

    src = Path(ops.__file__).resolve().parents[2]
    proc = subprocess.run([sys.executable, "-c", _ORDER_SCRIPT, str(src)],
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]

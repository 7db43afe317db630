"""The port's serving kernels against the JAX reference, and on the card.

Every case builds its inputs from a seed with numpy and feeds the same
arrays to both packages.  Data movement must match bitwise: the indirect
gather/scatter converters, the paged KV writes (fp32 and int8
quantize-on-write) and the int8 quantizer.  Paged attention must agree
within rtol = atol = 1e-5, the tolerance of the reference's own oracle
sweep (float32 sums taken in another order).

The converter kernels of the JAX package run here in Pallas interpret
mode, so the port's converters are held against both of its impls; the
paged KV writes, which the reference's own tests hold pallas == ref, are
held against its ``impl='ref'``.  The Pallas paged
attention kernels do not run on the installed jax 0.9
(``pltpu.TPUCompilerParams`` is gone), so the port's attention is held
against the reference's ``impl='ref'`` oracle only.

On this CPU host the port's dispatch layer runs each kernel's plain
PyTorch version.  The tests marked ``cuda`` hold the CUDA kernels against
those plain versions on the GPU and skip where there is none; run them on
the card with ``python -m pytest -m cuda tests/test_torch_kernels.py``.
"""
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402

PAGE = 4
POOL = 24
N_PAGES = 4

#: GQA group size h / kvh -> (h, kvh).
GQA = {1: (4, 4), 2: (4, 2), 4: (8, 2)}

#: Decode lengths over a 4-page table of 4-token pages (at most 16 tokens).
DECODE_LENGTHS = {
    "ragged": [1, 7, 14],
    "page_multiple": [4, 8, 16],
    "with_empty": [0, 5, 9],
    "full": [16, 16, 16],
}

#: Prefill (starts, counts) for 3 rows of a 4-token chunk.
PREFILL_ROWS = {
    "ragged": ([0, 5, 9], [4, 3, 2]),
    "page_multiple": ([0, 4, 8], [4, 4, 4]),
    "padding_rows": ([3, 0, 6], [2, 0, 4]),
    "straddle": ([2, 6, 11], [4, 4, 4]),
}

ATOL = RTOL = 1e-5


@pytest.fixture(scope="module")
def jx():
    """The JAX reference (``jnp``, ``ops``, ``ref``); imported here rather
    than at the top so the card's tests run where JAX is not installed."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ops as jops, ref as jref

    class JX:
        pass

    ns = JX()
    ns.a, ns.ops, ns.ref = jnp.asarray, jops, jref
    return ns


def _rng(*key) -> np.random.Generator:
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _t(x, device="cpu"):
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def _pools(rng, kvh, d, quantized):
    """Random K/V pools (fp32, or int8 codes with positive fp32 scales)."""
    shape = (POOL, PAGE, kvh, d)
    if quantized:
        kp = rng.integers(-127, 128, shape).astype(np.int8)
        vp = rng.integers(-127, 128, shape).astype(np.int8)
        ks = rng.uniform(0.001, 0.02, shape[:3]).astype(np.float32)
        vs = rng.uniform(0.001, 0.02, shape[:3]).astype(np.float32)
        return kp, vp, ks, vs
    kp = rng.standard_normal(shape).astype(np.float32)
    vp = rng.standard_normal(shape).astype(np.float32)
    return kp, vp, None, None


def _table(rng, rows):
    """Distinct physical pages for every (row, table entry)."""
    return rng.permutation(POOL)[: rows * N_PAGES].reshape(
        rows, N_PAGES).astype(np.int32)


def _scales(ks, vs, to):
    return {} if ks is None else dict(k_scale=to(ks), v_scale=to(vs))


# ---------------------------------------------------------------------------
# Stream converters: bitwise against both JAX impls
# ---------------------------------------------------------------------------

CONVERTER_DTYPES = {"float32": np.float32, "int8": np.int8, "int32": np.int32}


def _rows(rng, shape, dtype):
    if dtype == np.int8:
        return rng.integers(-128, 128, shape).astype(np.int8)
    return (rng.standard_normal(shape) * 100).astype(dtype)


@pytest.mark.parametrize("impl", ["pallas", "ref"])
@pytest.mark.parametrize("dtype", sorted(CONVERTER_DTYPES))
@pytest.mark.parametrize("shape,count", [((16, 128), 5), ((40, 384), 23),
                                         ((64, 256), 64)])
def test_indirect_gather_bitwise_vs_jax(jx, impl, dtype, shape, count):
    rng = _rng("gather", dtype, shape, count)
    src = _rows(rng, shape, CONVERTER_DTYPES[dtype])
    idx = rng.integers(0, shape[0], count).astype(np.int32)
    got = ops.indirect_gather(_t(src), _t(idx))
    want = jx.ops.indirect_gather(jx.a(src), jx.a(idx), impl=impl)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("impl", ["pallas", "ref"])
@pytest.mark.parametrize("dtype", sorted(CONVERTER_DTYPES))
@pytest.mark.parametrize("shape,count", [((16, 128), 5), ((40, 384), 23),
                                         ((64, 256), 64)])
def test_indirect_scatter_bitwise_vs_jax(jx, impl, dtype, shape, count):
    rng = _rng("scatter", dtype, shape, count)
    dst = _rows(rng, shape, CONVERTER_DTYPES[dtype])
    packed = _rows(rng, (count,) + shape[1:], CONVERTER_DTYPES[dtype])
    idx = rng.permutation(shape[0])[:count].astype(np.int32)
    got = ops.indirect_scatter(_t(dst).clone(), _t(packed), _t(idx))
    want = jx.ops.indirect_scatter(jx.a(dst), jx.a(packed),
                                 jx.a(idx), impl=impl)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_indirect_scatter_drops_out_of_range_rows(jx):
    """An index past the rows drops its row, as the reference's scatter
    drops it; a negative index drops too in the port (the callers route
    dropped rows to ``n_rows``)."""
    rng = _rng("drop")
    dst = rng.standard_normal((10, 32)).astype(np.float32)
    packed = rng.standard_normal((4, 32)).astype(np.float32)
    idx = np.array([3, 10, 7, 25], np.int32)
    got = ops.indirect_scatter(_t(dst).clone(), _t(packed), _t(idx))
    want = jx.ops.indirect_scatter(jx.a(dst), jx.a(packed),
                                 jx.a(idx), impl="ref")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    neg = ops.indirect_scatter(_t(dst).clone(), _t(packed[:1]),
                               _t(np.array([-1], np.int32)))
    np.testing.assert_array_equal(neg.numpy(), dst)


# ---------------------------------------------------------------------------
# Paged KV writes: bitwise against both JAX impls, fp32 and int8
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["cuda", "ref"])
@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
def test_paged_kv_append_bitwise_vs_jax(jx, impl, quantized):
    """Inactive rows and an append past the table row write nothing."""
    rng = _rng("append", quantized)
    kvh, d = 2, 8
    kp, vp, ks, vs = _pools(rng, kvh, d, quantized)
    table = _table(rng, 4)
    lengths = np.array([0, 5, N_PAGES * PAGE, 7], np.int32)  # row 2 is full
    active = np.array([True, True, True, False])
    k_new = rng.standard_normal((4, kvh, d)).astype(np.float32)
    v_new = rng.standard_normal((4, kvh, d)).astype(np.float32)
    got = ops.paged_kv_append(
        _t(kp).clone(), _t(vp).clone(), _t(k_new), _t(v_new), _t(table),
        _t(lengths), _t(active),
        **_scales(ks, vs, lambda a: _t(a).clone()), impl=impl,
    )
    want = jx.ops.paged_kv_append(
        jx.a(kp), jx.a(vp), jx.a(k_new),
        jx.a(v_new), jx.a(table), jx.a(lengths),
        jx.a(active), **_scales(ks, vs, jx.a), impl="ref",
    )
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("impl", ["cuda", "ref"])
@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
def test_paged_kv_write_chunk_bitwise_vs_jax(jx, impl, quantized):
    """A chunk straddling a page boundary, a ragged one and a padding row."""
    rng = _rng("chunk", quantized)
    kvh, d, c = 2, 8, 4
    kp, vp, ks, vs = _pools(rng, kvh, d, quantized)
    rows = _table(rng, 3)
    starts = np.array([0, 6, 9], np.int32)
    counts = np.array([4, 3, 0], np.int32)
    k_new = rng.standard_normal((3, c, kvh, d)).astype(np.float32)
    v_new = rng.standard_normal((3, c, kvh, d)).astype(np.float32)
    got = ops.paged_kv_write_chunk(
        _t(kp).clone(), _t(vp).clone(), _t(k_new), _t(v_new), _t(rows),
        _t(starts), _t(counts),
        **_scales(ks, vs, lambda a: _t(a).clone()), impl=impl,
    )
    want = jx.ops.paged_kv_write_chunk(
        jx.a(kp), jx.a(vp), jx.a(k_new),
        jx.a(v_new), jx.a(rows), jx.a(starts),
        jx.a(counts), **_scales(ks, vs, jx.a), impl="ref",
    )
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_paged_writes_never_repeat_a_live_scatter_index(monkeypatch):
    """The scatter kernel leaves duplicate in-range indices in no defined
    order; the paged writes must therefore never issue one."""
    seen = []
    real = ops.indirect_scatter

    def spy(dst, packed, indices, impl="cuda"):
        idx = indices.long()
        seen.append(idx[(idx >= 0) & (idx < dst.shape[0])].tolist())
        return real(dst, packed, indices, impl=impl)

    monkeypatch.setattr(ops, "indirect_scatter", spy)
    rng = _rng("dups")
    kvh, d = 2, 8
    for quantized in (False, True):
        kp, vp, ks, vs = _pools(rng, kvh, d, quantized)
        sc = _scales(ks, vs, _t)
        table = _table(rng, 4)
        ops.paged_kv_append(
            _t(kp), _t(vp), _t(rng.standard_normal((4, kvh, d), np.float32)),
            _t(rng.standard_normal((4, kvh, d), np.float32)), _t(table),
            _t(np.array([3, 3, 16, 0], np.int32)),
            _t(np.array([True, True, True, False])), **sc,
        )
        ops.paged_kv_write_chunk(
            _t(kp), _t(vp),
            _t(rng.standard_normal((4, 8, kvh, d), np.float32)),
            _t(rng.standard_normal((4, 8, kvh, d), np.float32)), _t(table),
            _t(np.array([0, 3, 9, 14], np.int32)),
            _t(np.array([8, 8, 0, 2], np.int32)), **sc,
        )
    assert len(seen) == (2 + 4) + (4 + 8)  # fp32 then int8 pools
    for idx in seen:
        assert len(idx) == len(set(idx)), idx


# ---------------------------------------------------------------------------
# Int8 quantizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(3, 2, 8), (2, 4, 4, 32), (5, 1, 128)])
def test_quantize_kv_bitwise_vs_jax(jx, shape):
    rng = _rng("quant", shape)
    x = (rng.standard_normal(shape) * rng.uniform(0.01, 10)).astype(np.float32)
    x[0, 0] = 0.0  # an all-zero (token, head) slice takes scale 1
    q, s = ref.quantize_kv(_t(x))
    jq, js = jx.ref.quantize_kv(jx.a(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    deq = ref.dequantize_pages(q, s)
    np.testing.assert_array_equal(
        deq.numpy(), np.asarray(jx.ref.dequantize_pages(jq, js)))


# ---------------------------------------------------------------------------
# Paged attention: within 1e-5 of the JAX oracle
# ---------------------------------------------------------------------------


def _decode_inputs(gqa, lengths, quantized, d=16):
    h, kvh = GQA[gqa]
    rng = _rng("decode", gqa, lengths, quantized)
    b = len(DECODE_LENGTHS[lengths])
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    kp, vp, ks, vs = _pools(rng, kvh, d, quantized)
    table = _table(rng, b)
    lens = np.array(DECODE_LENGTHS[lengths], np.int32)
    return q, kp, vp, ks, vs, table, lens


def _prefill_inputs(gqa, rows, quantized, d=16, c=4):
    h, kvh = GQA[gqa]
    rng = _rng("prefill", gqa, rows, quantized)
    starts, counts = (np.array(a, np.int32) for a in PREFILL_ROWS[rows])
    q = rng.standard_normal((len(starts), c, h, d)).astype(np.float32)
    kp, vp, ks, vs = _pools(rng, kvh, d, quantized)
    table = _table(rng, len(starts))
    return q, kp, vp, ks, vs, table, starts, counts


@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("gqa", sorted(GQA))
@pytest.mark.parametrize("lengths", sorted(DECODE_LENGTHS))
def test_paged_decode_attention_vs_jax(jx, quantized, gqa, lengths):
    q, kp, vp, ks, vs, table, lens = _decode_inputs(gqa, lengths, quantized)
    got = ops.paged_decode_attention(
        _t(q), _t(kp), _t(vp), _t(table), _t(lens), **_scales(ks, vs, _t))
    want = jx.ops.paged_decode_attention(
        jx.a(q), jx.a(kp), jx.a(vp), jx.a(table),
        jx.a(lens), **_scales(ks, vs, jx.a), impl="ref")
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)
    empty = lens == 0
    assert not got.numpy()[empty].any()  # length 0: exact zeros


@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("gqa", sorted(GQA))
@pytest.mark.parametrize("rows", sorted(PREFILL_ROWS))
def test_paged_prefill_attention_vs_jax(jx, quantized, gqa, rows):
    q, kp, vp, ks, vs, table, starts, counts = _prefill_inputs(
        gqa, rows, quantized)
    got = ops.paged_prefill_attention(
        _t(q), _t(kp), _t(vp), _t(table), _t(starts), _t(counts),
        **_scales(ks, vs, _t))
    want = jx.ops.paged_prefill_attention(
        jx.a(q), jx.a(kp), jx.a(vp), jx.a(table),
        jx.a(starts), jx.a(counts),
        **_scales(ks, vs, jx.a), impl="ref")
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)
    assert not got.numpy()[counts == 0].any()  # padding rows: exact zeros


def test_cpu_tensors_never_reach_a_kernel():
    """On the CPU every wrapper runs its plain version and counts nothing."""
    ops.reset_launch_counts()
    q, kp, vp, ks, vs, table, lens = _decode_inputs(2, "ragged", True)
    ops.paged_decode_attention(_t(q), _t(kp), _t(vp), _t(table), _t(lens),
                               **_scales(ks, vs, _t))
    ops.indirect_gather(_t(kp), _t(table[0]))
    assert ops.launch_counts() == {name: 0 for name in ops.launch_counts()}


# ---------------------------------------------------------------------------
# On the card: each CUDA kernel against its plain version
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the kernels are CUDA-only")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(CONVERTER_DTYPES))
@pytest.mark.parametrize("shape,count", [((16, 128), 5), ((40, 3), 23),
                                         ((256, 8192), 64)])
def test_converter_kernels_bitwise_on_card(cuda, dtype, shape, count):
    rng = _rng("card-conv", dtype, shape, count)
    src = _t(_rows(rng, shape, CONVERTER_DTYPES[dtype]), cuda)
    packed = _t(_rows(rng, (count,) + shape[1:], CONVERTER_DTYPES[dtype]),
                cuda)
    gidx = _t(rng.integers(0, shape[0], count).astype(np.int32), cuda)
    sidx = rng.permutation(shape[0] + 3)[:count].astype(np.int32)  # some drop
    sidx = _t(sidx, cuda)
    ops.reset_launch_counts()
    got = ops.indirect_gather(src, gidx)
    assert torch.equal(got, ref.indirect_gather(src, gidx))
    got = ops.indirect_scatter(src.clone(), packed, sidx)
    want = ref.indirect_scatter(src.clone(), packed, sidx)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert ops.indirect_gather.launches == ops.indirect_scatter.launches == 1


@pytest.mark.cuda
@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("gqa", sorted(GQA))
@pytest.mark.parametrize("lengths", sorted(DECODE_LENGTHS))
@pytest.mark.parametrize("d", [16, 128])
def test_paged_decode_kernel_on_card(cuda, quantized, gqa, lengths, d):
    q, kp, vp, ks, vs, table, lens = _decode_inputs(gqa, lengths, quantized,
                                                    d=d)
    args = [_t(a, cuda) for a in (q, kp, vp, table, lens)]
    sc = _scales(ks, vs, lambda a: _t(a, cuda))
    got = ops.paged_decode_attention(*args, **sc)
    want = ops.paged_decode_attention(*args, **sc, impl="ref")
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("gqa", sorted(GQA))
@pytest.mark.parametrize("rows", sorted(PREFILL_ROWS))
@pytest.mark.parametrize("d", [16, 128])
def test_paged_prefill_kernel_on_card(cuda, quantized, gqa, rows, d):
    q, kp, vp, ks, vs, table, starts, counts = _prefill_inputs(
        gqa, rows, quantized, d=d)
    args = [_t(a, cuda) for a in (q, kp, vp, table, starts, counts)]
    sc = _scales(ks, vs, lambda a: _t(a, cuda))
    got = ops.paged_prefill_attention(*args, **sc)
    want = ops.paged_prefill_attention(*args, **sc, impl="ref")
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    assert not got[_t(counts, cuda) == 0].any()


@pytest.mark.cuda
@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
def test_attention_kernels_never_read_unmapped_pages(cuda, quantized):
    """NaN in every page no live token maps (and in the int8 scales): the
    kernels' outputs stay finite because they never load those pages."""
    q, kp, vp, ks, vs, table, lens = _decode_inputs(4, "ragged", quantized)
    live = set()
    for row, n in zip(table, lens):
        live.update(int(p) for p in row[: -(-int(n) // PAGE)])
    dead = [p for p in range(POOL) if p not in live]
    if quantized:
        ks[dead], vs[dead] = np.nan, np.nan
    else:
        kp[dead], vp[dead] = np.nan, np.nan
    sc = _scales(ks, vs, lambda a: _t(a, cuda))
    out = ops.paged_decode_attention(
        *[_t(a, cuda) for a in (q, kp, vp, table, lens)], **sc)
    assert torch.isfinite(out).all()
    starts = np.array([0, 5, 9], np.int32)
    counts = np.array([1, 2, 0], np.int32)
    qp = _rng("poison").standard_normal((3, 4) + q.shape[1:]).astype(
        np.float32)
    out = ops.paged_prefill_attention(
        *[_t(a, cuda) for a in (qp, kp, vp, table, starts, counts)], **sc)
    assert torch.isfinite(out).all()

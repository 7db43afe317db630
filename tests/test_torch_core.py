"""The port's copy of ``repro.core`` against the reference.

``repro_torch.core`` keeps numpy copies of the reference's stream
descriptors, traffic accounting, bus model and banked endpoint simulator,
and writes the ``pack_*`` / ``unpack_*`` semantics as tensor functions.
Every number must equal the reference's exactly: the accounting and the
models are the same numpy code, so their floats are equal, and packing
moves data, so it must match bitwise.  The paper's cycle models
(``repro_torch.workloads.paper``) are held against
``benchmarks/paper_workloads.py`` field for field.

The bank simulator is a Python loop per cycle, so the sizes here stay
small (at most 32 sparse rows).
"""
import dataclasses
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import core  # noqa: E402
from repro_torch.core import banksim, busmodel  # noqa: E402
from repro_torch.workloads import paper  # noqa: E402


@pytest.fixture(scope="module")
def jx():
    """``(jnp, repro.core, benchmarks.paper_workloads)``, imported here so
    that the card's tests run where JAX is not installed."""
    jnp = pytest.importorskip("jax.numpy")
    import repro.core as rcore
    from benchmarks import paper_workloads

    return jnp, rcore, paper_workloads


def _rng(*key) -> np.random.Generator:
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def test_core_exports_what_the_reference_exports(jx):
    _, rcore, _ = jx
    names = {n for n in dir(rcore) if not n.startswith("_")}
    assert names <= set(dir(core)), sorted(names - set(dir(core)))


# ---------------------------------------------------------------------------
# Traffic accounting
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("count,elem_bytes,stride,granule", [
    (256 * 256, 4, 256, 32), (100, 2, 1, 32), (37, 8, 5, 64), (1, 1, 3, 32),
    (0, 4, 7, 32)])
def test_strided_traffic_equals_reference(jx, count, elem_bytes, stride,
                                          granule):
    _, rcore, _ = jx
    got = core.strided_traffic(count, elem_bytes, stride, granule)
    want = rcore.strided_traffic(count, elem_bytes, stride, granule)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.base_efficiency, got.pack_efficiency) == (
        want.base_efficiency, want.pack_efficiency)


@pytest.mark.parametrize("count,elem_bytes,index_bytes,granule", [
    (128 * 24, 4, 4, 32), (1000, 8, 4, 32), (33, 2, 2, 64), (0, 4, 4, 32)])
def test_indirect_traffic_equals_reference(jx, count, elem_bytes,
                                           index_bytes, granule):
    _, rcore, _ = jx
    got = core.indirect_traffic(count, elem_bytes, index_bytes, granule)
    want = rcore.indirect_traffic(count, elem_bytes, index_bytes, granule)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.base_efficiency, got.pack_efficiency) == (
        want.base_efficiency, want.pack_efficiency)


# ---------------------------------------------------------------------------
# Packing semantics: bitwise against the reference
# ---------------------------------------------------------------------------


def _src(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("shape,base,stride,count", [
    ((32, 8), 3, 4, 7), ((20, 3, 5), 0, 2, 10), ((16, 4), 2, 1, 9),
    ((16, 4), 12, 1, 9),  # a contiguous start past the end is clamped
])
def test_pack_unpack_strided_bitwise(jx, shape, base, stride, count):
    jnp, rcore, _ = jx
    rng = _rng("strided", shape, base, stride)
    src = _src(rng, shape)
    packed = _src(rng, (count,) + shape[1:])
    got = core.pack_strided(torch.from_numpy(src), base, stride, count)
    want = rcore.pack_strided(jnp.asarray(src), base, stride, count)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    dst = torch.from_numpy(src)
    got = core.unpack_strided(dst, torch.from_numpy(packed), base, stride)
    want = rcore.unpack_strided(jnp.asarray(src), jnp.asarray(packed), base,
                                stride)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(dst.numpy(), src)  # a new tensor


@pytest.mark.parametrize("shape,count,base", [((40, 8), 12, 0),
                                              ((40, 3, 2), 25, 5)])
def test_pack_unpack_indirect_bitwise(jx, shape, count, base):
    jnp, rcore, _ = jx
    rng = _rng("indirect", shape, count, base)
    src = _src(rng, shape)
    packed = _src(rng, (count,) + shape[1:])
    idx = rng.permutation(shape[0] - base)[:count].astype(np.int32)
    got = core.pack_indirect(torch.from_numpy(src), torch.from_numpy(idx),
                             base)
    want = rcore.pack_indirect(jnp.asarray(src), jnp.asarray(idx), base)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for mode in ("set", "add"):
        dst = torch.from_numpy(src)
        got = core.unpack_indirect(dst, torch.from_numpy(packed),
                                   torch.from_numpy(idx), base, mode=mode)
        want = rcore.unpack_indirect(jnp.asarray(src), jnp.asarray(packed),
                                     jnp.asarray(idx), base, mode=mode)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(dst.numpy(), src)


def test_unpack_indirect_add_accumulates_duplicates(jx):
    """Repeated indices accumulate in ``mode='add'``.  The adds into one
    row may be taken in another order than the reference's scatter-add, so
    the sums agree to float32 rounding (1e-6), not bitwise."""
    jnp, rcore, _ = jx
    rng = _rng("add-dup")
    src = _src(rng, (10, 4))
    packed = _src(rng, (30, 4))
    idx = rng.integers(0, 10, 30).astype(np.int32)
    got = core.unpack_indirect(torch.from_numpy(src), torch.from_numpy(packed),
                               torch.from_numpy(idx), mode="add")
    want = rcore.unpack_indirect(jnp.asarray(src), jnp.asarray(packed),
                                 jnp.asarray(idx), mode="add")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# Bank simulator and bus model
# ---------------------------------------------------------------------------


def _streams(mod):
    """A few descriptors of each kind, built from the given core module."""
    idx = _rng("streams").integers(0, 4096, 40)
    return [
        mod.ContiguousStream(base=3, elem_bits=32, count=50),
        mod.StridedStream(base=0, elem_bits=32, count=64, stride=17),
        mod.StridedStream(base=5, elem_bits=16, count=48, stride=4),
        mod.StridedStream(base=1, elem_bits=64, count=24, stride=3),
        mod.StridedStream(base=0, elem_bits=8, count=40, stride=1),
        mod.IndirectStream(base=7, elem_bits=32, count=40, indices=idx,
                           index_bits=32),
        mod.IndirectStream(base=0, elem_bits=64, count=40, indices=idx,
                           index_bits=16),
    ]


@pytest.mark.parametrize("k", range(7))
def test_word_addresses_and_simulate_stream_equal_reference(jx, k):
    _, rcore, _ = jx
    from repro.core.streams import word_addresses as r_word_addresses

    mine, theirs = _streams(core)[k], _streams(rcore)[k]
    np.testing.assert_array_equal(core.word_addresses(mine),
                                  r_word_addresses(theirs))
    for ports, banks, depth in ((8, 17, 4), (8, 16, 32), (4, 7, 2)):
        cfg = dict(n_ports=ports, n_banks=banks, queue_depth=depth)
        got = core.simulate_stream(mine, core.BankConfig(**cfg))
        want = rcore.simulate_stream(theirs, rcore.BankConfig(**cfg))
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for system in core.System.ALL:
        got = core.stream_cycles(mine, system, core.BusConfig(), 3.0)
        want = rcore.stream_cycles(theirs, system, rcore.BusConfig(), 3.0)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("banks", [8, 11, 16, 17])
def test_utilization_sweeps_and_area_equal_reference(jx, banks):
    _, rcore, _ = jx
    cfg, rcfg = core.BankConfig(8, banks, 32, 4), rcore.BankConfig(8, banks,
                                                                   32, 4)
    for stride in (1, 2, 16, 17):
        assert core.strided_utilization(stride, cfg, burst_len=64) == \
            rcore.strided_utilization(stride, rcfg, burst_len=64)
    assert core.indirect_utilization(cfg, burst_len=64, seed=3) == \
        rcore.indirect_utilization(rcfg, burst_len=64, seed=3)
    assert core.crossbar_area_kge(8, banks) == rcore.crossbar_area_kge(8,
                                                                       banks)
    assert core.indirect_utilization_ceiling(32, 8) == \
        rcore.indirect_utilization_ceiling(32, 8)


def test_busmodel_helpers_equal_reference(jx):
    from repro.core import busmodel as rbus

    cfg, rcfg = busmodel.BusConfig(), rbus.BusConfig()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
    for n in (0, 1, 7, 64, 1000):
        assert busmodel.compute_cycles(n, cfg) == rbus.compute_cycles(n, rcfg)
        assert busmodel.reduction_cycles(n, cfg) == rbus.reduction_cycles(
            n, rcfg)
    assert dataclasses.asdict(banksim.BankConfig()) == dataclasses.asdict(
        jx[1].BankConfig())


# ---------------------------------------------------------------------------
# The paper's cycle models: Fig. 3 rows field for field
# ---------------------------------------------------------------------------

N_DENSE = 24
SPARSE_ROWS, AVG_NNZ, N_COLS = 24, 12, 400


def _models(mod, indptr, indices):
    return {
        "ismt": mod.ismt_model(N_DENSE),
        "gemv-col": mod.gemv_model(N_DENSE, "col"),
        "gemv-row": mod.gemv_model(N_DENSE, "row"),
        "trmv-col": mod.trmv_model(N_DENSE, "col"),
        "trmv-row": mod.trmv_model(N_DENSE, "row"),
        "spmv": mod.spmv_model(indptr, indices),
        "prank": mod.prank_model(indptr, indices),
        "sssp": mod.sssp_model(indptr, indices),
    }


def test_synth_csr_equals_reference(jx):
    ref_pw = jx[2]
    for got, want in zip(paper.synth_csr(SPARSE_ROWS, AVG_NNZ, N_COLS, 3),
                         ref_pw.synth_csr(SPARSE_ROWS, AVG_NNZ, N_COLS, 3)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["ismt", "gemv-col", "gemv-row", "trmv-col",
                                  "trmv-row", "spmv", "prank", "sssp"])
def test_fig3_rows_equal_reference_field_for_field(jx, name):
    ref_pw = jx[2]
    indptr, indices, _ = paper.synth_csr(SPARSE_ROWS, AVG_NNZ, N_COLS, 0)
    got = paper.evaluate(_models(paper, indptr, indices)[name])
    want = ref_pw.evaluate(_models(ref_pw, indptr, indices)[name])
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.name == name


def test_fig3a_rows_equal_reference(jx):
    ref_pw = jx[2]
    got = paper.fig3a_rows(n=16, sparse_rows=8, avg_nnz=10, seed=2)
    want = ref_pw.fig3a_rows(n=16, sparse_rows=8, avg_nnz=10, seed=2)
    assert [dataclasses.asdict(r) for r in got] == [
        dataclasses.asdict(r) for r in want]

"""The paper's workloads and their kernels against the JAX reference, and on
the card.

Every case builds its inputs from a seed with numpy and feeds the same
arrays to both packages.

* Transpose moves data, so the port's ``ops.tiled_transpose`` must equal
  the JAX ``ops.tiled_transpose`` bitwise, under both of its impls (its
  Pallas kernel runs here in interpret mode), in fp32 and bf16.
* ``spmv_ell`` and the panel-streamed SpMV must agree within rtol = atol =
  1e-5, the reference's own tolerance (tests/kernels/
  test_workload_kernels.py): float32 sums of a row taken in another order.
* ``csr_to_ell`` must give identical arrays.
* The six workloads of ``repro_torch.workloads.impls`` must agree with
  ``benchmarks/workload_impls.py``: outputs within 1e-5 (``sssp`` bitwise,
  since min-plus on the same float32 adds is exact) and traffic dicts
  equal.

On this CPU host the port's dispatch layer runs each kernel's plain
PyTorch version.  The tests marked ``cuda`` hold the CUDA kernels against
those plain versions on the GPU and skip where there is none; run them on
the card with ``python -m pytest -m cuda tests/test_torch_workloads.py``.
"""
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.workloads import impls as W  # noqa: E402
from repro_torch.workloads.__main__ import main as workloads_main  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def jx():
    """``(jnp, repro.kernels.ops, repro.kernels.ref, workload_impls)``,
    imported here so that the card's tests run where JAX is not
    installed."""
    jnp = pytest.importorskip("jax.numpy")
    from benchmarks import workload_impls
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref

    return jnp, jops, jref, workload_impls


def _rng(*key) -> np.random.Generator:
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _torch(a) -> torch.Tensor:
    """A JAX or numpy array's bytes as a torch tensor of the same dtype."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bytes(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(x)).view(np.uint8)


# ---------------------------------------------------------------------------
# Tiled transpose: bitwise against both JAX impls
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["pallas", "ref"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(128, 128), (40, 72), (256, 64), (8, 8)])
def test_tiled_transpose_bitwise_vs_jax(jx, impl, dtype, shape):
    jnp, jops, _, _ = jx
    x = jnp.asarray(_rng("t", shape).normal(size=shape),
                    dtype=getattr(jnp, dtype))
    want = jops.tiled_transpose(x, block=32, impl=impl)
    got = ops.tiled_transpose(_torch(x), block=32)
    assert tuple(got.shape) == tuple(want.shape) == shape[::-1]
    assert got.is_contiguous()
    np.testing.assert_array_equal(_bytes(got), _bytes(want))


# ---------------------------------------------------------------------------
# ELL SpMV
# ---------------------------------------------------------------------------


def _ell(rng, r, k, c, lo=0, hi=None):
    vals = rng.normal(size=(r, k)).astype(np.float32)
    cols = rng.integers(lo, c if hi is None else hi, (r, k)).astype(np.int32)
    x = rng.normal(size=(c,)).astype(np.float32)
    return vals, cols, x


@pytest.mark.parametrize("impl", ["pallas", "ref"])
@pytest.mark.parametrize("r,k,c", [(8, 4, 32), (20, 6, 50), (64, 16, 256),
                                   (7, 1, 8)])
def test_spmv_ell_vs_jax(jx, impl, r, k, c):
    jnp, jops, _, _ = jx
    vals, cols, x = _ell(_rng("spmv", r, k, c), r, k, c)
    want = jops.spmv_ell(jnp.asarray(vals), jnp.asarray(cols),
                         jnp.asarray(x), impl=impl)
    got = ops.spmv_ell(_torch(vals), _torch(cols), _torch(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("impl", ["pallas", "ref"])
def test_spmv_ell_clips_out_of_range_columns_vs_jax(jx, impl):
    """Columns below 0 read x[0] and columns past the end read x[C-1]: the
    reference's ``take(mode='clip')`` in both of its impls."""
    jnp, jops, _, _ = jx
    r, k, c = 24, 8, 40
    vals, cols, x = _ell(_rng("clip"), r, k, c, lo=-30, hi=90)
    assert (cols < 0).any() and (cols >= c).any()
    want = jops.spmv_ell(jnp.asarray(vals), jnp.asarray(cols),
                         jnp.asarray(x), impl=impl)
    got = ops.spmv_ell(_torch(vals), _torch(cols), _torch(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    dense = (vals * x[np.clip(cols, 0, c - 1)]).sum(1)
    np.testing.assert_allclose(got.numpy(), dense, **TOL)


def _csr(rng, n_rows, n_cols, density, empty_rows=()):
    dense = rng.normal(size=(n_rows, n_cols)) * (
        rng.random((n_rows, n_cols)) < density)
    dense[list(empty_rows)] = 0.0
    indptr, indices, data = [0], [], []
    for row in dense:
        nz = np.nonzero(row)[0]
        indices.extend(nz.tolist())
        data.extend(row[nz].tolist())
        indptr.append(len(indices))
    return (np.asarray(indptr), np.asarray(indices, np.int32),
            np.asarray(data, np.float32), dense.astype(np.float32))


@pytest.mark.parametrize("n_rows,n_cols,density,pad_to,empty", [
    (64, 64, 0.1, None, ()), (30, 100, 0.3, None, (0, 7, 29)),
    (16, 16, 0.5, 20, (3,))])
def test_csr_to_ell_identical_to_jax_and_spmv_matches_dense(
        jx, n_rows, n_cols, density, pad_to, empty):
    _, _, jref, _ = jx
    indptr, indices, data, dense = _csr(_rng("csr", n_rows, n_cols), n_rows,
                                        n_cols, density, empty)
    got = ref.csr_to_ell(indptr, indices, data, n_rows, pad_to=pad_to)
    want = jref.csr_to_ell(indptr, indices, data, n_rows, pad_to=pad_to)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    x = _rng("csr-x", n_cols).normal(size=(n_cols,)).astype(np.float32)
    y = ops.spmv_ell(_torch(got[0]), _torch(got[1]), _torch(x))
    np.testing.assert_allclose(y.numpy(), dense @ x, rtol=1e-4, atol=1e-4)


def test_csr_to_ell_raises_when_a_row_is_wider_than_pad_to():
    indptr, indices, data, _ = _csr(_rng("wide"), 8, 8, 0.9)
    with pytest.raises(ValueError, match="ELL width"):
        ref.csr_to_ell(indptr, indices, data, 8, pad_to=2)


# ---------------------------------------------------------------------------
# Panel-streamed SpMV against the JAX Pallas kernel in interpret mode
# ---------------------------------------------------------------------------


def _panel_case(rng, row_blocks, row_block, k, steps, c, panel, stray):
    """A panel-sorted ELL matrix: step s of row block b draws its columns
    from panel panel_ids[b, s]; ``stray`` entries of each row are moved to
    another panel, where the kernel must mask them."""
    n_panels = c // panel
    kb = k // steps
    pids = rng.integers(0, n_panels, (row_blocks, steps)).astype(np.int32)
    r = row_blocks * row_block
    vals = rng.normal(size=(r, k)).astype(np.float32)
    local = rng.integers(0, panel, (r, k))
    base = np.repeat(np.repeat(pids, row_block, 0), kb, 1) * panel
    cols = base + local
    if stray:
        pos = rng.integers(0, k, (r, stray))
        shift = rng.integers(1, n_panels, (r, stray)) * panel
        rows = np.arange(r)[:, None]
        cols[rows, pos] = (cols[rows, pos] + shift) % c
    x = rng.normal(size=(c,)).astype(np.float32)
    return vals, cols.astype(np.int32), x, pids


def _panel_dense(vals, cols, x, pids, panel):
    """The masked sum in numpy, in float64."""
    r, k = vals.shape
    row_blocks, steps = pids.shape
    base = np.repeat(np.repeat(pids, r // row_blocks, 0), k // steps, 1)
    inside = (cols // panel) == base
    return (np.where(inside, vals.astype(np.float64) * x[cols], 0.0)).sum(1)


@pytest.mark.parametrize("row_blocks,row_block,k,steps,c,panel,stray", [
    (2, 8, 8, 2, 2048, 512, 0),    # panel-sorted
    (2, 8, 8, 2, 2048, 512, 3),    # with entries outside their panel
    (3, 4, 12, 3, 256, 64, 2),
    (1, 5, 4, 1, 96, 32, 1),
    (2, 12, 6, 2, 256, 64, 1),     # K / steps = 3
    (3, 10, 4, 4, 128, 32, 1),     # K / steps = 1
])
def test_spmv_ell_panel_vs_jax_interpret(jx, row_blocks, row_block, k, steps,
                                         c, panel, stray):
    jnp = jx[0]
    from repro.kernels.spmv import spmv_ell_panel_kernel as jpanel

    vals, cols, x, pids = _panel_case(
        _rng("panel", row_blocks, k, c, stray), row_blocks, row_block, k,
        steps, c, panel, stray)
    want = jpanel(jnp.asarray(vals), jnp.asarray(cols), jnp.asarray(x),
                  jnp.asarray(pids), panel=panel, interpret=True)
    got = ops.spmv_ell_panel_kernel(_torch(vals), _torch(cols), _torch(x),
                                    _torch(pids), panel=panel)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got.numpy(),
                               _panel_dense(vals, cols, x, pids, panel),
                               **TOL)
    if stray:  # the masked entries change the result: the mask is tested
        full = (vals * x[cols]).sum(1)
        assert np.abs(got.numpy() - full).max() > 1e-3


@pytest.mark.parametrize("shape,pids,panel,match", [
    ((10, 8), (3, 2), 16, "row blocks"),
    ((12, 9), (3, 2), 16, "steps"),
    ((12, 8), (3, 2), 24, "panel"),
])
def test_spmv_ell_panel_raises_where_the_reference_cannot_tile(
        shape, pids, panel, match):
    vals = torch.zeros(shape)
    cols = torch.zeros(shape, dtype=torch.int32)
    with pytest.raises(ValueError, match=match):
        ops.spmv_ell_panel_kernel(vals, cols, torch.zeros(64),
                                  torch.zeros(pids, dtype=torch.int32),
                                  panel=panel)


def test_cpu_tensors_never_reach_a_workload_kernel():
    """On the CPU every wrapper runs its plain version and counts nothing,
    whatever ``impl`` says; a bad ``impl`` raises."""
    ops.reset_launch_counts()
    vals, cols, x = _ell(_rng("cpu"), 8, 4, 16)
    ops.spmv_ell(_torch(vals), _torch(cols), _torch(x))
    ops.tiled_transpose(_torch(vals))
    ops.spmv_ell_panel_kernel(_torch(vals), _torch(cols), _torch(x),
                              torch.zeros((2, 2), dtype=torch.int32), panel=8)
    assert ops.launch_counts() == {name: 0 for name in ops.launch_counts()}
    with pytest.raises(ValueError, match="impl"):
        ops.spmv_ell(_torch(vals), _torch(cols), _torch(x), impl="pallas")


# ---------------------------------------------------------------------------
# The six workloads against benchmarks/workload_impls.py
# ---------------------------------------------------------------------------


def _graph(n, seed=1):
    """sparse_ops' graph: synth_csr at 24 nonzeros a row, its ELL form, and
    the column-normalised PageRank matrix (self loops added) in ELL form."""
    from repro_torch.workloads.__main__ import _csr, _dense
    from repro_torch.workloads.paper import synth_csr

    indptr, indices, data = synth_csr(n, 24, n_cols=n, seed=seed)
    vals, cols = ref.csr_to_ell(indptr, indices, data, n)
    dense = _dense(indptr, indices, data, n)
    adj = (np.abs(dense) > 0).astype(np.float32) + np.eye(n, dtype=np.float32)
    pv, pc = ref.csr_to_ell(*_csr(adj / adj.sum(0, keepdims=True)), n)
    return vals, cols, pv, pc


@pytest.mark.parametrize("n", [64, 128])
def test_strided_workloads_vs_jax(jx, n):
    jnp, _, _, JW = jx
    rng = _rng("strided-w", n)
    a = rng.normal(size=(n, n)).astype(np.float32)
    x = rng.normal(size=(n,)).astype(np.float32)
    for impl in ("pallas", "ref"):
        want, wtr = JW.ismt(jnp.asarray(a), impl=impl)
        got, tr = W.ismt(_torch(a))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert tr == wtr
    for name in ("gemv_col", "trmv"):
        want, wtr = getattr(JW, name)(jnp.asarray(a), jnp.asarray(x))
        got, tr = getattr(W, name)(_torch(a), _torch(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        assert tr == wtr


@pytest.mark.parametrize("n", [64, 128])
def test_spmv_workload_vs_jax(jx, n):
    jnp, _, _, JW = jx
    vals, cols, _, _ = _graph(n)
    x = _rng("spmv-w", n).normal(size=(n,)).astype(np.float32)
    for impl in ("pallas", "ref"):
        want, wtr = JW.spmv(jnp.asarray(vals), jnp.asarray(cols),
                            jnp.asarray(x), impl=impl)
        got, tr = W.spmv(_torch(vals), _torch(cols), _torch(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        assert tr == wtr


@pytest.mark.parametrize("impl", ["pallas", "ref"])
def test_pagerank_vs_jax(jx, impl):
    """40 iterations at n = 128, as sparse_ops runs it, under each JAX
    impl; the port runs its plain path here under both of its own."""
    jnp, _, _, JW = jx
    n = 128
    _, _, pv, pc = _graph(n)
    want, wtr = JW.pagerank(jnp.asarray(pv), jnp.asarray(pc), n, iters=40,
                            impl=impl)
    for port_impl in ("cuda", "ref"):
        got, tr = W.pagerank(_torch(pv), _torch(pc), n, iters=40,
                             impl=port_impl)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        assert tr == wtr
    assert abs(float(got.sum()) - 1.0) < 1e-4


@pytest.mark.parametrize("n,iters", [(64, 12), (128, 12), (128, 3)])
def test_sssp_bitwise_vs_jax(jx, n, iters):
    jnp, _, _, JW = jx
    vals, cols, _, _ = _graph(n)
    mask = vals != 0
    wv = (np.abs(vals) + mask * 0.1).astype(np.float32)
    want, wtr = JW.sssp(jnp.asarray(wv), jnp.asarray(cols),
                        jnp.asarray(mask), src=0, n=n, iters=iters)
    got, tr = W.sssp(_torch(wv), _torch(cols), _torch(mask), src=0, n=n,
                     iters=iters)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tr == wtr


def test_workloads_entry_point_on_cpu(capsys):
    assert workloads_main(["--device", "cpu", "--n", "32"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split()[0] for ln in lines] == [
        "ismt", "gemv_col", "trmv", "spmv", "pagerank", "sssp"]
    assert all(" ok " in ln and "modeled speedup" in ln for ln in lines)


# ---------------------------------------------------------------------------
# On the card: each CUDA kernel against its plain version
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the kernels are CUDA-only")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8, torch.float64])
@pytest.mark.parametrize("shape", [(1, 1), (7, 33), (33, 7), (128, 96),
                                   (1000, 517), (2_100_000, 3)])
def test_transpose_kernel_bitwise_on_card(cuda, dtype, shape):
    gen = torch.Generator(device=cuda).manual_seed(zlib.crc32(
        repr((shape, dtype)).encode()))
    x = (torch.randn(shape, generator=gen, device=cuda) * 50).to(dtype)
    ops.reset_launch_counts()
    got = ops.tiled_transpose(x)
    torch.cuda.synchronize()
    assert got.is_contiguous() and torch.equal(got, ref.tiled_transpose(x))
    assert ops.tiled_transpose.launches == 1
    # A non-contiguous view is transposed as its values.
    view = x[:, ::2] if shape[1] > 1 else x
    assert torch.equal(ops.tiled_transpose(view), view.t())


@pytest.mark.cuda
@pytest.mark.parametrize("r,k,c", [(8, 4, 32), (20, 6, 50), (7, 1, 8),
                                   (1000, 32, 4096), (333, 40, 70),
                                   (4099, 3, 1 << 20)])
@pytest.mark.parametrize("clip", [False, True])
def test_spmv_kernel_on_card(cuda, r, k, c, clip):
    vals, cols, x = _ell(_rng("card-spmv", r, k, c, clip), r, k, c,
                         lo=-5 if clip else 0, hi=c + 5 if clip else None)
    vals, cols, x = (_torch(a).to(cuda) for a in (vals, cols, x))
    ops.reset_launch_counts()
    got = ops.spmv_ell(vals, cols, x)
    want = ops.spmv_ell(vals, cols, x, impl="ref")
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **TOL)
    assert ops.spmv_ell.launches == 1
    # int64 columns, and K - 1 columns of a view (the 4-byte path where
    # K - 1 is not a multiple of 4).
    got = ops.spmv_ell(vals[:, 1:], cols[:, 1:].long(), x)
    torch.testing.assert_close(got, ops.spmv_ell(vals[:, 1:], cols[:, 1:], x,
                                                 impl="ref"), **TOL)


@pytest.mark.cuda
def test_spmv_kernel_raises_on_other_dtypes(cuda):
    vals = torch.zeros((8, 4), dtype=torch.bfloat16, device=cuda)
    cols = torch.zeros((8, 4), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        ops.spmv_ell(vals, cols, torch.zeros(16, device=cuda,
                                             dtype=torch.bfloat16))


@pytest.mark.cuda
@pytest.mark.parametrize("row_blocks,row_block,k,steps,c,panel,stray", [
    (2, 8, 8, 2, 2048, 512, 0), (2, 8, 8, 2, 2048, 512, 3),
    (3, 4, 12, 3, 256, 64, 2), (1, 5, 4, 1, 96, 6, 1),
    (512, 64, 32, 4, 1 << 16, 512, 2), (8, 300, 6, 2, 16384, 8192, 1),
    (4, 100, 3, 3, 4096, 512, 1), (16, 300, 9, 3, 8192, 1024, 2),
    (2, 2000, 32, 4, 1 << 16, 512, 1), (64, 8, 8, 2, 4096, 256, 1),
    (7, 3, 5, 5, 1000, 100, 1)])
def test_spmv_panel_kernel_on_card(cuda, row_blocks, row_block, k, steps, c,
                                   panel, stray):
    vals, cols, x, pids = _panel_case(
        _rng("card-panel", row_blocks, k, c, stray), row_blocks, row_block,
        k, steps, c, panel, stray)
    args = [_torch(a).to(cuda) for a in (vals, cols, x, pids)]
    ops.reset_launch_counts()
    got = ops.spmv_ell_panel_kernel(*args, panel=panel)
    want = ops.spmv_ell_panel_kernel(*args, panel=panel, impl="ref")
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **TOL)
    assert ops.spmv_ell_panel_kernel.launches == 1
    # Panel ids outside x's panels are clamped by both versions.
    args[3] = args[3] * 3 - 1
    torch.testing.assert_close(
        ops.spmv_ell_panel_kernel(*args, panel=panel),
        ops.spmv_ell_panel_kernel(*args, panel=panel, impl="ref"), **TOL)


def _offset(t: torch.Tensor, elems: int) -> torch.Tensor:
    """A contiguous copy of ``t`` starting ``elems`` elements past a
    16-byte boundary."""
    buf = torch.empty(t.numel() + 4, dtype=t.dtype, device=t.device)
    view = buf[elems:elems + t.numel()].view(t.shape)
    view.copy_(t)
    return view


PANEL_ROUTE_CASES = {
    # name: (operand offset in elements, route)
    "aligned": ({}, "bulk"),
    "x off 4 B": ({"x": 1}, "cp.async"),
    "vals off 8 B": ({"vals": 2}, "cp.async"),
    "cols off 12 B": ({"cols": 3}, "cp.async"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(PANEL_ROUTE_CASES))
def test_spmv_panel_routes_on_card(cuda, case):
    """Each route of the panel kernel against the plain version, strays
    masked; one launch per call."""
    offsets, route = PANEL_ROUTE_CASES[case]
    vals, cols, x, pids = _panel_case(_rng("card-panel-route", case), 64,
                                      64, 32, 4, 1 << 16, 512, 2)
    args = dict(vals=_torch(vals).to(cuda), cols=_torch(cols).to(cuda),
                x=_torch(x).to(cuda))
    args = {k: _offset(v, offsets.get(k, 0)) for k, v in args.items()}
    pids = _torch(pids).to(cuda)
    ops.reset_launch_counts()
    got = ops.spmv_ell_panel_kernel(args["vals"], args["cols"], args["x"],
                                    pids, panel=512)
    torch.cuda.synchronize()
    assert ops.spmv_ell_panel_kernel.launches == 1
    assert ops.spmv_ell_panel_kernel.plan.route == route
    want = ref.spmv_ell_panel(args["vals"], args["cols"], args["x"], pids,
                              panel=512)
    torch.testing.assert_close(got, want, **TOL)


SPMV_CARD_KS = [1, 3, 4, 5, 8, 32, 33, 100, 256, 264]


def _spmv_card_case(cuda, k, offset):
    r, c = 1000, 4099
    vals, cols, x = (_torch(a).to(cuda) for a in _ell(
        _rng("card-spmv-plan", k, offset), r, k, c, lo=-9, hi=c + 9))
    return vals, _offset(cols, offset), x


@pytest.mark.cuda
@pytest.mark.parametrize("k", SPMV_CARD_KS)
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "cols off 4 B"])
def test_spmv_plans_on_card(cuda, k, offset):
    """Each SpMV plan within TOL of the plain version, with columns below
    and past x (clipped), ragged K and cols off 16-byte alignment (the
    1-entry loads), and K = 100, 256 and 264 (several loads a lane); one
    launch a call, by the plan the wrapper keeps."""
    vals, cols, x = _spmv_card_case(cuda, k, offset)
    ops.reset_launch_counts()
    got = ops.spmv_ell(vals, cols, x)
    torch.cuda.synchronize()
    assert ops.spmv_ell.launches == 1
    assert ops.spmv_ell.plan.vec == (4 if k % 4 == 0 and not offset else 1)
    torch.testing.assert_close(got, ref.spmv_ell(vals, cols, x), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("k", SPMV_CARD_KS + [1000])
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "cols off 4 B"])
def test_spmv_on_card_within_the_fp32_bound_of_a_float64_sum(cuda, k,
                                                              offset):
    """The kernel and the plain version, each against the row sums taken
    in float64, within the forward error bound of fp32 summation in any
    order, (K + 1) * 2**-24 * sum|v * x| a row.  This holds rows of any
    length, K = 1000 too, where TOL's absolute 1e-5 (set for rows of tens
    of entries, like the workload's K = 32) is below the rounding of a
    thousand fp32 terms in either order."""
    vals, cols, x = _spmv_card_case(cuda, k, offset)
    terms = vals.double() * x.double()[cols.long().clamp(0, x.numel() - 1)]
    want = terms.sum(1)
    bound = (k + 1) * 2.0**-24 * terms.abs().sum(1)
    for name, got in (("kernel", ops.spmv_ell(vals, cols, x)),
                      ("plain", ref.spmv_ell(vals, cols, x))):
        err = (got.double() - want).abs()
        assert bool((err <= bound).all()), (
            f"{name}: worst row {int((err - bound).argmax())} off by "
            f"{err.max().item():.3e}")


@pytest.mark.cuda
def test_workloads_entry_point_on_card(cuda, capsys):
    ops.reset_launch_counts()
    assert workloads_main(["--n", "128"]) == 0
    counts = ops.launch_counts()
    assert counts["tiled_transpose"] == 1 and counts["spmv_ell"] == 41

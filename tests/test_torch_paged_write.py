"""The paged K/V write (``ops.paged_kv_write``) against the JAX reference,
and on the card.

On the CPU the port's ``paged_kv_append`` and ``paged_kv_write_chunk``
(``impl='cuda'``) run the write kernel's plain version
(``ref.paged_kv_write``: each token straight into its page).  They must
leave the pools bitwise equal to ``repro.kernels.ops``'s functions of the
same name under ``jax.jit`` (as the reference's engine runs them), both its
``impl='ref'`` full-pool oracle and its ``impl='pallas'`` converter path
(the page window, in Pallas interpret mode): fp32 pools and
int8 pools with their scales, with inactive rows, ``counts == 0`` rows,
appends past the table, unmapped page ids (outside ``[0, P)``), chunks that
straddle a page or end on a page multiple, and all-zero rows (scale 1).
Inputs are made from a seed with numpy; the cases are fixed, not drawn.
The kernel's int8 arithmetic, written out in numpy, is held bitwise against
the reference's scales and codes.

The tests marked ``cuda`` hold the kernel bitwise against its plain version
in one launch a call, and run an int8 prefill, decode and verify in a
fresh process; run them on the card with
``python -m pytest -m cuda tests/test_torch_paged_write.py``.
"""
import functools
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402

PAGE = 4
POOL = 24
N_PAGES = 4
KVH, D = 2, 8


@pytest.fixture(scope="module")
def jx():
    """``(jnp.asarray, jit, repro.kernels)``, imported here so that the
    card's tests run where JAX is not installed; ``jit(fn, **static)`` is
    ``fn`` under ``jax.jit`` with ``static`` bound."""
    jax = pytest.importorskip("jax")
    import repro.kernels as jk

    jit = lambda fn, **static: jax.jit(functools.partial(fn, **static))
    return jax.numpy.asarray, jit, jk


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rng(*key) -> np.random.Generator:
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _pools(rng, quantized, kvh=KVH, d=D, pool=POOL, page=PAGE):
    shape = (pool, page, kvh, d)
    if quantized:
        return (rng.integers(-127, 128, shape).astype(np.int8),
                rng.integers(-127, 128, shape).astype(np.int8),
                rng.uniform(0.001, 0.02, shape[:3]).astype(np.float32),
                rng.uniform(0.001, 0.02, shape[:3]).astype(np.float32))
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32), None, None)


def _table(rng, rows, unmapped=()):
    """Distinct pages a (row, entry); ``unmapped`` (row, entry, id) cells
    hold ids outside [0, POOL)."""
    table = rng.permutation(POOL)[: rows * N_PAGES].reshape(
        rows, N_PAGES).astype(np.int32)
    for r, e, pid in unmapped:
        table[r, e] = pid
    return table


def _new(rng, shape, zero=()):
    x = (rng.standard_normal(shape) * rng.uniform(0.1, 10)).astype(np.float32)
    for idx in zero:
        x[idx] = 0.0  # an all-zero (token, kv head) row: int8 scale 1
    return x


#: name: (lengths, active, unmapped table cells, all-zero (token, head)).
APPEND_CASES = {
    "inactive_rows": ([3, 5, 9, 0], [True, False, True, False], (), ()),
    "past_the_table": ([16, 15, 17, 2], [True] * 4, (), ()),
    "unmapped_page_ids": ([1, 5, 9, 14], [True] * 4,
                          ((0, 0, POOL), (1, 1, POOL + 5), (3, 3, 1000)),
                          ()),
    "page_multiples": ([0, 4, 8, 12], [True] * 4, (), ()),
    "all_zero_row": ([2, 6, 10, 13], [True] * 4, (), ((1, 0), (2, 1))),
}

#: name: (chunk, starts, counts, unmapped table cells, all-zero rows).
CHUNK_CASES = {
    "counts_zero_rows": (4, [0, 5, 9], [4, 0, 2], (), ()),
    "straddles_a_page": (4, [2, 6, 11], [4, 4, 4], (), ()),
    "exact_page_multiple": (4, [0, 4, 8], [4, 4, 4], (), ()),
    "unmapped_page_ids": (6, [0, 3, 8], [6, 6, 5],
                          ((0, 1, POOL), (1, 0, POOL + 3), (2, 3, 999)),
                          ()),
    "all_zero_row": (5, [1, 7, 0], [5, 3, 4], (), ((0, 2, 1), (2, 0, 0))),
}


def _check(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("jax_impl", ["ref", "pallas"])
@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("case", sorted(APPEND_CASES))
def test_paged_kv_append_bitwise_vs_jax(jx, case, quantized, jax_impl):
    a, jit, jk = jx
    lengths, active, unmapped, zero = APPEND_CASES[case]
    rng = _rng("append", case, quantized)
    kp, vp, ks, vs = _pools(rng, quantized)
    table = _table(rng, 4, unmapped)
    k_new, v_new = (_new(rng, (4, KVH, D), zero) for _ in range(2))
    lengths = np.array(lengths, np.int32)
    active = np.array(active)
    sc = (lambda f: {}) if ks is None else (
        lambda f: dict(k_scale=f(ks), v_scale=f(vs)))
    got = ops.paged_kv_append(
        torch.tensor(kp), torch.tensor(vp), torch.tensor(k_new),
        torch.tensor(v_new), torch.tensor(table), torch.tensor(lengths),
        torch.tensor(active), **sc(torch.tensor))
    want = jit(jk.ops.paged_kv_append, impl=jax_impl)(
        a(kp), a(vp), a(k_new), a(v_new), a(table), a(lengths), a(active),
        **sc(a))
    _check(got, want)


@pytest.mark.parametrize("jax_impl", ["ref", "pallas"])
@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("case", sorted(CHUNK_CASES))
def test_paged_kv_write_chunk_bitwise_vs_jax(jx, case, quantized, jax_impl):
    a, jit, jk = jx
    chunk, starts, counts, unmapped, zero = CHUNK_CASES[case]
    rng = _rng("chunk", case, quantized)
    kp, vp, ks, vs = _pools(rng, quantized)
    rows = _table(rng, 3, unmapped)
    k_new, v_new = (_new(rng, (3, chunk, KVH, D), zero) for _ in range(2))
    starts = np.array(starts, np.int32)
    counts = np.array(counts, np.int32)
    sc = (lambda f: {}) if ks is None else (
        lambda f: dict(k_scale=f(ks), v_scale=f(vs)))
    got = ops.paged_kv_write_chunk(
        torch.tensor(kp), torch.tensor(vp), torch.tensor(k_new),
        torch.tensor(v_new), torch.tensor(rows), torch.tensor(starts),
        torch.tensor(counts), **sc(torch.tensor))
    want = jit(jk.ops.paged_kv_write_chunk, impl=jax_impl)(
        a(kp), a(vp), a(k_new), a(v_new), a(rows), a(starts), a(counts),
        **sc(a))
    _check(got, want)


def _kernel_int8(x: np.ndarray):
    """The write kernel's int8 arithmetic over the last axis, in float32
    numpy: scale = amax * (1.0f / 127.0f) (1 for a zero row), code =
    clamp(rint(x / scale), -127, 127) with an IEEE division."""
    amax = np.abs(x).max(-1, keepdims=True)
    inv = np.float32(1.0) / np.float32(127.0)
    scale = np.where(amax > 0, amax * inv, np.float32(1.0)).astype(np.float32)
    codes = np.clip(np.rint(x / scale), -127, 127).astype(np.int8)
    return codes, scale[..., 0]


@pytest.mark.parametrize("spread", ["unit", "wide"])
def test_int8_arithmetic_of_the_kernel_matches_jax(jx, spread):
    """The kernel's scale and codes, written out in numpy, bitwise equal to
    ``repro.kernels.ref.quantize_kv`` under ``jax.jit`` (and to the port's
    ``ref.quantize_kv``) on 65,536 (token, head) rows of D = 8: amax from
    the unit range, or spread over 2**-40 .. 2**40, plus all-zero rows.
    (Subnormal rows are left out: XLA on the CPU flushes them to zero, the
    port and the kernel keep them.)"""
    a, jit, jk = jx
    rng = _rng("int8-arith", spread)
    x = rng.standard_normal((8192, 8, 8)).astype(np.float32)
    if spread == "wide":
        x *= np.exp2(rng.integers(-40, 41, (8192, 8, 1))).astype(np.float32)
    x[::101, 5] = 0.0
    codes, scale = _kernel_int8(x)
    jq, js = jit(jk.ref.quantize_kv)(a(x))
    np.testing.assert_array_equal(scale, np.asarray(js))
    np.testing.assert_array_equal(codes, np.asarray(jq))
    q, s = ref.quantize_kv(torch.tensor(x))
    np.testing.assert_array_equal(s.numpy(), scale)
    np.testing.assert_array_equal(q.numpy(), codes)
    assert ref.INV_127 == np.float32(1.0) / np.float32(127.0)


def test_destinations_drop_what_the_kernel_drops():
    """Token (r, c) lands at pid * page + pos % page, and is dropped (-1)
    past its count, outside the table row (both ends) and on a page id
    outside [0, P)."""
    rows = torch.tensor([[3, 7, -1, 24]], dtype=torch.int32)

    def dest(start, count, chunk):
        return ref.paged_kv_destinations(
            rows, torch.tensor([start]), torch.tensor([count]), chunk, PAGE,
            POOL).tolist()[0]

    assert dest(-1, 3, 4) == [-1, 12, 13, -1]      # below the row; count
    assert dest(6, 8, 8) == [30, 31] + [-1] * 6    # page ids -1, then P
    assert dest(14, 4, 4) == [-1] * 4              # page id P, then past


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

#: name: (quantized, kv heads, head dim, byte offset of k_new's data).
CARD_CASES = {
    "fp32 yi-6b rows": (False, 4, 128, 0),
    "int8 yi-6b rows": (True, 4, 128, 0),
    "fp32 odd head dim": (False, 3, 6, 0),
    "int8 odd head dim": (True, 3, 6, 0),
    "fp32 rows off 4 B": (False, 2, 16, 4),
    "int8 rows off 4 B": (True, 2, 16, 4),
}


def _offset_copy(t, offset):
    """A contiguous copy of ``t`` whose data starts ``offset`` bytes past a
    256-byte boundary."""
    flat = t.reshape(-1).view(torch.int8)
    buf = torch.empty(flat.numel() + 256, dtype=torch.int8, device=t.device)
    view = buf[offset:offset + flat.numel()]
    view.copy_(flat)
    return view.view(t.dtype).view(t.shape)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_paged_write_kernel_bitwise_on_card(cuda, case):
    """A chunk write and an append on the card, each one launch, bitwise
    against the kernel's plain version and the full-pool oracle: a
    straddling chunk, a counts-0 row, an unmapped page id, an inactive row,
    an append past the table and an all-zero row."""
    quantized, kvh, d, offset = CARD_CASES[case]
    rng = _rng("card-write", case)
    kp, vp, ks, vs = (None if a is None else torch.tensor(a, device=cuda)
                      for a in _pools(rng, quantized, kvh, d, POOL, PAGE))
    rows = torch.tensor(_table(rng, 4, ((2, 1, POOL + 1),)), device=cuda)
    chunk = 6
    k_new, v_new = (_offset_copy(torch.tensor(
        _new(rng, (4, chunk, kvh, d), ((0, 3, 0),)), device=cuda), offset)
        for _ in range(2))
    starts = torch.tensor([2, 9, 3, 0], dtype=torch.int32, device=cuda)
    counts = torch.tensor([6, 5, 6, 0], dtype=torch.int32, device=cuda)
    sc = lambda k, v: {} if k is None else dict(k_scale=k, v_scale=v)
    clone = lambda *ts: [None if t is None else t.clone() for t in ts]

    ops.reset_launch_counts()
    got = ops.paged_kv_write_chunk(*clone(kp, vp), k_new, v_new, rows,
                                   starts, counts, **sc(*clone(ks, vs)))
    torch.cuda.synchronize()
    assert ops.paged_kv_write.launches == 1
    assert sum(ops.launch_counts().values()) == 1
    plain = ref.paged_kv_write(*clone(kp, vp), k_new, v_new, rows, starts,
                               counts, *clone(ks, vs))
    oracle = ops.paged_kv_write_chunk(*clone(kp, vp), k_new, v_new, rows,
                                      starts, counts, **sc(*clone(ks, vs)),
                                      impl="ref")
    for g, p, o in zip(got, plain, oracle):
        assert torch.equal(g, p) and torch.equal(g, o)

    lengths = torch.tensor([5, 16, 3, 7], dtype=torch.int32, device=cuda)
    active = torch.tensor([1, 1, 0, 1], dtype=torch.int32, device=cuda)
    k1, v1 = k_new[:, 0].contiguous(), v_new[:, 0].contiguous()
    ops.reset_launch_counts()
    got = ops.paged_kv_append(*clone(kp, vp), k1, v1, rows, lengths, active,
                              **sc(*clone(ks, vs)))
    torch.cuda.synchronize()
    assert ops.paged_kv_write.launches == 1
    assert sum(ops.launch_counts().values()) == 1
    want = ops.paged_kv_append(*clone(kp, vp), k1, v1, rows, lengths,
                               active.bool(), **sc(*clone(ks, vs)),
                               impl="ref")
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


_ORDER_SCRIPT = """
import sys, torch
sys.path.insert(0, sys.argv[1])
from repro_torch.kernels import ops
dev = torch.device("cuda")
TOL = dict(rtol=1e-5, atol=1e-5)
g = torch.Generator(device=dev).manual_seed(0)
shape = (16, 16, 4, 128)
pools = [torch.randint(-127, 128, shape, generator=g, dtype=torch.int8,
                       device=dev) for _ in range(2)]
pools += [torch.rand(shape[:3], generator=g, device=dev) * 0.02 + 0.001
          for _ in range(2)]
table = torch.arange(16, dtype=torch.int32, device=dev).view(2, 8)
i32 = lambda *v: torch.tensor(v, dtype=torch.int32, device=dev)
new = lambda *s: torch.randn(*s, generator=g, device=dev)


def write(fn, args, kw):
    ours = [t.clone() for t in pools]
    want = [t.clone() for t in pools]
    fn(ours[0], ours[1], *args, k_scale=ours[2], v_scale=ours[3], **kw)
    fn(want[0], want[1], *args, k_scale=want[2], v_scale=want[3],
       impl="ref", **kw)
    for a, b in zip(ours, want):
        assert torch.equal(a, b), fn.__name__
    pools[:] = ours


def attend(fn, q, *args):
    got = fn(q, pools[0], pools[1], *args, k_scale=pools[2],
             v_scale=pools[3])
    want = fn(q, pools[0], pools[1], *args, k_scale=pools[2],
              v_scale=pools[3], impl="ref")
    assert torch.allclose(got, want, **TOL), fn.__name__


# int8 prefill: a chunk write, then the prefill kernel.
write(ops.paged_kv_write_chunk,
      (new(2, 32, 4, 128), new(2, 32, 4, 128), table, i32(0, 40),
       i32(32, 9)), {})
attend(ops.paged_prefill_attention, new(2, 32, 32, 128), table, i32(0, 40),
       i32(32, 9))
# decode: an append, then the decode kernel.
write(ops.paged_kv_append,
      (new(2, 4, 128), new(2, 4, 128), table, i32(32, 49), i32(1, 1)), {})
attend(ops.paged_decode_attention, new(2, 32, 128), table, i32(33, 50))
# verify: a chunk write of K = 4 at the lengths, then the verify kernel.
write(ops.paged_kv_write_chunk,
      (new(2, 4, 4, 128), new(2, 4, 4, 128), table, i32(33, 50),
       i32(4, 2)), {})
attend(ops.paged_verify, new(2, 4, 32, 128), table, i32(33, 50), i32(4, 2))
torch.cuda.synchronize()
assert ops.paged_kv_write.launches == 3, ops.launch_counts()
"""


@pytest.mark.cuda
def test_int8_prefill_decode_verify_in_a_fresh_process(cuda):
    """The write library and the two attention libraries loaded in a fresh
    process in the serving order (int8 prefill, decode, verify): every
    write bitwise equal to the full-pool oracle, every attention call
    within TOL of its plain version."""
    import subprocess
    import sys
    from pathlib import Path

    src = Path(ops.__file__).resolve().parents[2]
    proc = subprocess.run([sys.executable, "-c", _ORDER_SCRIPT, str(src)],
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]

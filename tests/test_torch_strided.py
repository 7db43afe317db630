"""The port's strided stream converters against the JAX reference, and on
the card.

``ops.strided_gather`` / ``ops.strided_scatter`` and the recurrent state
reads and writes composed over them must match the JAX package bitwise:
against both of its impls (its Pallas converters run here in interpret
mode), for fp32, bf16 and int8 rows and for row widths that are not a
multiple of 16 bytes.  Rows are compared as raw bytes.

Outside the pool the two JAX impls differ (its Pallas gather reads zero
padding where its oracle clips), so out-of-range streams are held against
the oracle only: the gather clips, the scatter drops.

On this CPU host the port runs each kernel's plain version.  The tests
marked ``cuda`` hold the CUDA kernels against those plain versions on the
GPU and skip where there is none; run them on the card with
``python -m pytest -m cuda tests/test_torch_strided.py``.
"""
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.serve import RecurrentLM  # noqa: E402

DTYPES = ("float32", "bfloat16", "int8")


@pytest.fixture(scope="module")
def jx():
    """``(jnp, repro.kernels.ops)``, imported here so that the card's
    tests run where JAX is not installed."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ops as jops

    return jnp, jops


def _rng(*key) -> np.random.Generator:
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _jax_rows(jnp, rng, shape, dtype):
    x = rng.standard_normal(shape) * 50
    if dtype == "int8":
        return jnp.asarray(np.clip(x, -128, 127).astype(np.int8))
    return jnp.asarray(x.astype(np.float32)).astype(getattr(jnp, dtype))


def _torch(a) -> torch.Tensor:
    """A JAX array's bytes as a torch tensor of the same dtype."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bytes(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(x)).view(np.uint8)


def _assert_bitwise(got, want):
    assert tuple(got.shape) == tuple(np.asarray(want).shape)
    np.testing.assert_array_equal(_bytes(got), _bytes(want))


# ---------------------------------------------------------------------------
# Strided converters: bitwise against both JAX impls
# ---------------------------------------------------------------------------

#: (rows, width), stride: 16-byte, 4-byte and 1-byte copy units all occur.
GATHER_CASES = [((16, 128), 1), ((64, 256), 3), ((40, 37), 2), ((16, 3), 5)]
SCATTER_CASES = [((16, 128), 2), ((64, 256), 4), ((40, 37), 3)]


@pytest.mark.parametrize("impl", ["pallas", "ref"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,stride", GATHER_CASES)
def test_strided_gather_bitwise_vs_jax(jx, impl, dtype, shape, stride):
    jnp, jops = jx
    src = _jax_rows(jnp, _rng("sg", dtype, shape, stride), shape, dtype)
    count = max(1, (shape[0] - 1) // stride)
    want = jops.strided_gather(src, 1, stride, count, impl=impl)
    got = ops.strided_gather(_torch(src), 1, stride, count)
    _assert_bitwise(got, want)


@pytest.mark.parametrize("impl", ["pallas", "ref"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,stride", SCATTER_CASES)
def test_strided_scatter_bitwise_vs_jax(jx, impl, dtype, shape, stride):
    jnp, jops = jx
    rng = _rng("ss", dtype, shape, stride)
    count = (shape[0] - 1) // stride
    packed = _jax_rows(jnp, rng, (count, shape[1]), dtype)
    dst = _jax_rows(jnp, rng, shape, dtype)
    want = jops.strided_scatter(dst, packed, 1, stride, impl=impl)
    port_dst = _torch(dst)
    got = ops.strided_scatter(port_dst, _torch(packed), 1, stride)
    assert got is port_dst  # written in place
    _assert_bitwise(got, want)


def test_out_of_range_rows_clip_on_read_and_drop_on_write(jx):
    jnp, jops = jx
    rng = _rng("oor")
    src = _jax_rows(jnp, rng, (10, 8), "float32")
    packed = _jax_rows(jnp, rng, (5, 8), "float32")
    _assert_bitwise(ops.strided_gather(_torch(src), 4, 3, 5),
                    jops.strided_gather(src, 4, 3, 5, impl="ref"))
    _assert_bitwise(ops.strided_scatter(_torch(src), _torch(packed), 4, 3),
                    jops.strided_scatter(src, packed, 4, 3, impl="ref"))


@pytest.mark.parametrize("stride,count", [(2, 1), (3, 7), (8, 16)])
def test_strided_equals_indirect_with_arange(stride, count):
    """A strided stream is an indirect stream over ``base + k*stride``."""
    rng = _rng("arange", stride, count)
    src = torch.from_numpy(rng.standard_normal((stride * count + 2, 128))
                           .astype(np.float32))
    a = ops.strided_gather(src, 1, stride, count)
    b = ops.indirect_gather(src, 1 + torch.arange(count) * stride)
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# Recurrent state reads and writes
# ---------------------------------------------------------------------------

STATE_SHAPES = [(2, 4, 2, 64, 64), (3, 4, 128), (2, 3, 3, 256), (3, 2, 5)]


@pytest.mark.parametrize("impl", ["pallas", "ref"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", STATE_SHAPES)
def test_recurrent_state_ops_bitwise_vs_jax(jx, impl, dtype, shape):
    jnp, jops = jx
    rng = _rng("state", dtype, shape)
    pool = _jax_rows(jnp, rng, shape, dtype)
    value = _jax_rows(jnp, rng, (shape[0],) + shape[2:], dtype)
    l, b = shape[:2]
    slots = range(b) if impl == "ref" else (0, b - 1)
    for slot in slots:
        got = ops.recurrent_state_read(_torch(pool), slot)
        _assert_bitwise(got, jops.recurrent_state_read(pool, slot,
                                                       impl=impl))
        assert tuple(got.shape) == (l,) + shape[2:]
        port_pool = _torch(pool)
        got = ops.recurrent_state_write(port_pool, slot, _torch(value))
        assert got is port_pool
        want = jops.recurrent_state_write(pool, slot, value, impl=impl)
        _assert_bitwise(got, want)
        # Non-target rows are untouched; the target holds the value.
        keep = np.arange(b) != slot
        _assert_bitwise(got[:, torch.from_numpy(keep)],
                        np.asarray(pool)[:, keep])
        _assert_bitwise(got[:, slot], value)


def test_state_read_returns_a_copy_and_checks_the_slot():
    pool = torch.arange(24.0).view(2, 3, 4)
    out = ops.recurrent_state_read(pool, 1)
    pool.zero_()
    assert out.sum() > 0
    with pytest.raises((ValueError, IndexError)):
        ops.recurrent_state_read(pool, 3)


def test_replay_zeroes_only_target_slot():
    model = RecurrentLM(smoke_config("rwkv6-3b"), device="cpu")
    fam = model.bind(model.init_pool(3))
    for t in fam.pool.tensors.values():
        t += 1
    before = {k: t.clone() for k, t in fam.pool.tensors.items()}
    fam.replay(1)
    for k, t in fam.pool.tensors.items():
        assert not t[:, 1].any(), f"{k}: slot 1 not zeroed"
        assert torch.equal(t[:, [0, 2]], before[k][:, [0, 2]])


def test_cpu_tensors_never_reach_a_strided_kernel():
    ops.reset_launch_counts()
    pool = torch.ones(2, 3, 4)
    ops.recurrent_state_write(pool, 0, ops.recurrent_state_read(pool, 1))
    ops.strided_scatter(pool.view(6, 4), ops.strided_gather(
        pool.view(6, 4), 0, 2, 3), 1, 2)
    assert ops.launch_counts() == {name: 0 for name in ops.launch_counts()}


# ---------------------------------------------------------------------------
# On the card: the CUDA kernels against their plain versions
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the kernels are CUDA-only")
    return torch.device("cuda")


CARD_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
               "int8": torch.int8}


def _card_rows(gen, shape, dtype, dev):
    return torch.randint(-100, 100, shape, generator=gen,
                         device=dev).to(CARD_DTYPES[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(16, 128), (40, 37), (64, 3), (8, 40960)])
@pytest.mark.parametrize("base,stride", [(1, 3), (0, 1), (5, 0), (3, 7)])
def test_strided_kernels_bitwise_on_card(cuda, dtype, shape, base, stride):
    gen = torch.Generator(device=cuda).manual_seed(zlib.crc32(
        repr((dtype, shape, base, stride)).encode()))
    src = _card_rows(gen, shape, dtype, cuda)
    count = shape[0] // 2 + 3          # some rows past the end
    packed = _card_rows(gen, (count,) + shape[1:], dtype, cuda)
    ops.reset_launch_counts()
    got = ops.strided_gather(src, base, stride, count)
    assert torch.equal(got, ref.strided_gather(src, base, stride, count))
    if stride:  # a repeated row (stride 0) has no defined write order
        a = ops.strided_scatter(src.clone(), packed, base, stride)
        b = ref.strided_scatter(src.clone(), packed, base, stride)
        torch.cuda.synchronize()
        assert torch.equal(a, b)
    assert ops.strided_gather.launches == 1
    assert ops.strided_scatter.launches == (1 if stride else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", STATE_SHAPES)
def test_recurrent_state_ops_on_card(cuda, dtype, shape):
    gen = torch.Generator(device=cuda).manual_seed(7)
    pool = _card_rows(gen, shape, dtype, cuda)
    value = _card_rows(gen, (shape[0],) + shape[2:], dtype, cuda)
    for slot in range(shape[1]):
        assert torch.equal(ops.recurrent_state_read(pool, slot),
                           pool[:, slot])
        got = ops.recurrent_state_write(pool.clone(), slot, value)
        want = ref.recurrent_state_write(pool.clone(), slot, value)
        torch.cuda.synchronize()
        assert torch.equal(got, want)

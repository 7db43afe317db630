"""Flash attention in the port against the JAX reference.

Inputs come from numpy seeds and go through both packages.  On the CPU the
port's ``ops.flash_attention`` runs its plain versions
(``ref.flash_attention_fwd`` / ``_bwd``) through the same
``torch.autograd.Function`` that launches the CUDA kernels on the card, and
the JAX side runs its Pallas kernels in interpret mode.

* Forward ``(o, lse)`` within 2e-5 at float32 and 2e-2 at bf16 (the
  reference's own tolerances, ``tests/kernels/test_workload_kernels.py``),
  against ``flash_attention_fwd_kernel`` and ``ref.mha``, over that test's
  grid of shapes and masks.
* Backward within 1e-4 (the reference's trainable-flash contract) against
  ``flash_attention_bwd_kernel`` and ``jax.grad`` of ``ref.mha``.
* Which counter a call raises, checked with the launches stubbed out.
* The tests marked ``cuda`` hold kernels 8-10 against the plain versions
  on the card: ``python -m pytest -m cuda tests/test_torch_flash.py``.
"""
import importlib
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402

SHAPES = [(1, 2, 2, 16, 8), (2, 4, 2, 32, 16), (1, 8, 1, 64, 32)]
MASKS = [(True, None), (False, None), (True, 8)]
FWD_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
BWD_TOL = dict(rtol=1e-4, atol=1e-4)
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref

    # The package re-exports a function under the module's name.
    fa = importlib.import_module("repro.kernels.flash_attention")
    return types.SimpleNamespace(jax=jax, jnp=jnp, fa=fa, ops=jops, ref=jref)


def _inputs(seed, b, h, kvh, sq, d, skv=None, extra=0):
    """q, k, v (and ``extra`` more (B, H, Sq, D) arrays) as float32 numpy."""
    rng = np.random.default_rng(seed)
    skv = sq if skv is None else skv
    q = rng.normal(size=(b, h, sq, d)).astype(np.float32)
    k = rng.normal(size=(b, kvh, skv, d)).astype(np.float32)
    v = rng.normal(size=(b, kvh, skv, d)).astype(np.float32)
    return (q, k, v) + tuple(rng.normal(size=(b, h, sq, d)).astype(np.float32)
                             for _ in range(extra))


def _t(x, dtype="float32", grad=False):
    return torch.tensor(x).to(TORCH_DT[dtype]).requires_grad_(grad)


def _f32(x):
    return (x.detach().float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x, np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("b,h,kvh,s,d", SHAPES)
def test_forward_matches_jax(jx, b, h, kvh, s, d, causal, window, dtype):
    q, k, v = _inputs(3, b, h, kvh, s, d)
    jdt = getattr(jx.jnp, dtype)
    jq, jk, jv = (jx.jnp.asarray(a, dtype=jdt) for a in (q, k, v))
    want_o, want_lse = jx.fa.flash_attention_fwd_kernel(
        jq, jk, jv, causal=causal, window=window, block_q=8, block_k=8,
        interpret=True)
    want_mha = jx.ref.mha(jq, jk, jv, causal=causal, window=window)
    tq, tk, tv = (_t(a, dtype) for a in (q, k, v))
    o, lse = ref.flash_attention_fwd(tq, tk, tv, causal=causal, window=window)
    got = ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    tol = FWD_TOL[dtype]
    assert o.dtype == tq.dtype and lse.dtype == torch.float32
    np.testing.assert_allclose(_f32(o), _f32(want_o), rtol=tol, atol=tol)
    np.testing.assert_allclose(_f32(lse), _f32(want_lse), rtol=tol, atol=tol)
    np.testing.assert_allclose(_f32(o), _f32(want_mha), rtol=tol, atol=tol)
    assert torch.equal(got, o)


@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("b,h,kvh,s,d", SHAPES + [(2, 4, 4, 32, 16)])
def test_backward_matches_jax(jx, b, h, kvh, s, d, causal, window):
    q, k, v, w = _inputs(7, b, h, kvh, s, d, extra=1)
    jnp = jx.jnp
    jq, jk, jv, jw = (jnp.asarray(a) for a in (q, k, v, w))
    jo, jlse = jx.fa.flash_attention_fwd_kernel(
        jq, jk, jv, causal=causal, window=window, block_q=8, block_k=8,
        interpret=True)
    kern = jx.fa.flash_attention_bwd_kernel(
        jq, jk, jv, jo, jlse, jw, causal=causal, window=window, block_q=8,
        block_k=8, interpret=True)
    auto = jx.jax.grad(
        lambda *a: jnp.sum(jx.ref.mha(*a, causal=causal, window=window) * jw),
        argnums=(0, 1, 2))(jq, jk, jv)

    tq, tk, tv = (_t(a, grad=True) for a in (q, k, v))
    o = ops.flash_attention(tq, tk, tv, causal=causal, window=window,
                            block_q=8, block_k=8)
    grads = torch.autograd.grad((o * _t(w)).sum(), (tq, tk, tv))
    plain = ref.flash_attention_bwd(
        _t(q), _t(k), _t(v), _t(np.asarray(jo)), _t(np.asarray(jlse)), _t(w),
        causal=causal, window=window)
    for name, g, p, kg, ag in zip("qkv", grads, plain, kern, auto):
        np.testing.assert_allclose(_f32(p), _f32(kg), err_msg=f"d{name}",
                                   **BWD_TOL)
        np.testing.assert_allclose(_f32(g), _f32(ag), err_msg=f"d{name}",
                                   **BWD_TOL)


def test_ragged_non_causal_is_exact(jx):
    """S = 12 with the reference's 8-row blocks, no causal mask.

    The reference's wrapper pads K/V to 16 rows and its kernels mask with
    the padded length, so its Pallas path lets four zero keys into every
    softmax: it differs from ``ref.mha`` by 0.42 max abs here (ROADMAP
    §C).  The port pads nothing and masks with the true Skv, so it agrees
    with ``ref.mha``, forward and backward.
    """
    q, k, v, w = _inputs(11, 1, 2, 2, 12, 8, extra=1)
    jnp = jx.jnp
    jq, jk, jv, jw = (jnp.asarray(a) for a in (q, k, v, w))
    want = jx.ref.mha(jq, jk, jv, causal=False)
    auto = jx.jax.grad(
        lambda *a: jnp.sum(jx.ref.mha(*a, causal=False) * jw),
        argnums=(0, 1, 2))(jq, jk, jv)
    tq, tk, tv = (_t(a, grad=True) for a in (q, k, v))
    o = ops.flash_attention(tq, tk, tv, causal=False, block_q=8, block_k=8)
    np.testing.assert_allclose(_f32(o), _f32(want), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(
        _f32(o), _f32(ref.mha(tq, tk, tv, causal=False)), rtol=2e-5,
        atol=2e-5)
    grads = torch.autograd.grad((o * _t(w)).sum(), (tq, tk, tv))
    for g, ag in zip(grads, auto):
        np.testing.assert_allclose(_f32(g), _f32(ag), **BWD_TOL)


def test_fully_masked_rows_give_zero_and_sentinel_lse():
    """A window that reaches no key (Skv shorter than the queries'
    distance) leaves rows fully masked: o = 0, lse = -1e30, and
    they contribute no gradient."""
    q, k, v, w = _inputs(5, 1, 2, 1, 12, 8, skv=4, extra=1)
    tq, tk, tv = (_t(a, grad=True) for a in (q, k, v))
    o, lse = ref.flash_attention_fwd(tq, tk, tv, causal=True, window=3)
    dead = torch.arange(12) >= 6  # query i sees keys > i - 3, all < 4
    assert torch.equal(o[:, :, dead], torch.zeros_like(o[:, :, dead]))
    assert torch.all(lse[:, :, dead] == -1e30)
    out = ops.flash_attention(tq, tk, tv, causal=True, window=3)
    dq, dk, dv = torch.autograd.grad((out * _t(w)).sum(), (tq, tk, tv))
    assert torch.equal(dq[:, :, dead], torch.zeros_like(dq[:, :, dead]))
    assert all(bool(torch.isfinite(g).all()) for g in (dq, dk, dv))


class _Stubbed:
    """Record the C entries a call would launch, without launching."""

    def __init__(self, monkeypatch):
        self.calls = []
        monkeypatch.setattr(ops, "_use_kernel", lambda impl, x: impl == "cuda")
        monkeypatch.setattr(ops, "_stream", lambda x: None)
        monkeypatch.setattr(ops, "_launch", self.launch)

    def launch(self, symbol, *args):
        self.calls.append((symbol, args))


def _bshd_views(seed, b=2, s=16, h=4, kvh=2, d=64, grad=True):
    """(B, H, S, D) views of (B, S, H, D) tensors, as the model passes."""
    rng = np.random.default_rng(seed)
    q = torch.tensor(rng.normal(size=(b, s, h, d)), dtype=torch.float32)
    k = torch.tensor(rng.normal(size=(b, s, kvh, d)), dtype=torch.float32)
    v = torch.tensor(rng.normal(size=(b, s, kvh, d)), dtype=torch.float32)
    return tuple(t.requires_grad_(grad).transpose(1, 2) for t in (q, k, v))


def test_grad_call_launches_fwd_lse_then_both_backward_passes(monkeypatch):
    stub = _Stubbed(monkeypatch)
    ops.reset_launch_counts()
    q, k, v = _bshd_views(0)
    o = ops.flash_attention(q, k, v)
    assert [c[0] for c in stub.calls] == ["repro_flash_attention_lse"]
    # Views go to the kernel as they are, and o comes back in q's layout.
    args = stub.calls[0][1]
    assert args[0].value == q.data_ptr()
    strides = list(args[5])
    assert strides[:3] == list(q.stride()[:3]) and o.stride() == q.stride()
    o.sum().backward()
    assert [c[0] for c in stub.calls] == [
        "repro_flash_attention_lse", "repro_flash_attention_bwd_dkv",
        "repro_flash_attention_bwd_dq"]
    # The dk/dv entry computes delta itself: it takes o (the forward's
    # output, as saved) after do, with o's strides after do's, and fills
    # the delta buffer that the dq entry then reads.
    dkv, dq = stub.calls[1][1], stub.calls[2][1]
    assert dkv[4].value == o.data_ptr()
    strides = list(dkv[10])
    assert len(strides) == 21
    assert strides[12:15] == list(o.stride()[:3])
    assert dkv[6].value == dq[5].value  # delta
    counts = ops.launch_counts()
    assert (counts["flash_attention"], counts["flash_attention_fwd"],
            counts["flash_attention_bwd"]) == (0, 1, 1)
    ops.reset_launch_counts()


@pytest.mark.parametrize("mode", ["no_grad", "inputs_without_grad"])
def test_gradless_call_launches_the_forward_kernel(monkeypatch, mode):
    stub = _Stubbed(monkeypatch)
    ops.reset_launch_counts()
    q, k, v = _bshd_views(1, grad=mode == "no_grad")
    if mode == "no_grad":
        with torch.no_grad():
            ops.flash_attention(q, k, v, causal=False, window=4)
    else:
        ops.flash_attention(q, k, v, causal=False, window=4)
    assert [c[0] for c in stub.calls] == ["repro_flash_attention"]
    tail = stub.calls[0][1][5:]
    # B, H, KVH, Sq, Skv, D, causal, has_window, window, scale, bf16
    assert tail[:11] == (2, 4, 2, 16, 16, 64, 0, 1, 4, 0.125, 0)
    counts = ops.launch_counts()
    assert (counts["flash_attention"], counts["flash_attention_fwd"],
            counts["flash_attention_bwd"]) == (1, 0, 0)
    ops.reset_launch_counts()


def test_cpu_tensors_launch_nothing():
    ops.reset_launch_counts()
    q, k, v = _bshd_views(2)
    ops.flash_attention(q, k, v).sum().backward()
    with torch.no_grad():
        ops.flash_attention(q, k, v)
    assert set(ops.launch_counts().values()) == {0}


def test_head_dim_80_reaches_the_kernel_entries(monkeypatch):
    """hubert-xlarge's D = 80 goes to the C entries as D = 80 with the true
    softmax scale, and the bf16 dk/dv pass gets partials for 128-column
    tiles (two of them a key row, in whole 128-key blocks)."""
    stub = _Stubbed(monkeypatch)
    q, k, v = (t.detach().to(torch.bfloat16).requires_grad_()
               for t in _bshd_views(5, s=130, d=80, grad=False))
    ops.flash_attention(q, k, v).float().sum().backward()
    names = [c[0] for c in stub.calls]
    assert names == ["repro_flash_attention_lse",
                     "repro_flash_attention_bwd_dkv",
                     "repro_flash_attention_bwd_dq"]
    for _, args in stub.calls:
        tail = args[-12:]  # B, H, KVH, Sq, Skv, D, causal, window x 2,
        assert tail[:6] == (2, 4, 2, 130, 130, 80)  # scale, bf16, stream
        assert tail[9] == pytest.approx(1 / np.sqrt(80)) and tail[10] == 1
    partial = stub.calls[1][1][9]
    assert partial.value is not None
    assert ops._tile_width(80) == 128 and ops._tile_width(64) == 64


@pytest.mark.parametrize("case", ["head_dim", "dtypes", "groups"])
def test_kernel_path_raises_on_what_it_does_not_take(monkeypatch, case):
    _Stubbed(monkeypatch)
    q, k, v = _bshd_views(3, d=32 if case == "head_dim" else 64, grad=False)
    if case == "dtypes":
        k = k.double()
    if case == "groups":
        k, v = k[:, :1].expand(2, 3, 16, 64), v[:, :1].expand(2, 3, 16, 64)
    with pytest.raises(ValueError, match="flash_attention"):
        ops.flash_attention(q, k, v)


def test_impl_ref_and_bad_impl():
    q, k, v = _bshd_views(4, grad=False)
    want = ref.flash_attention_fwd(q, k, v)[0]
    assert torch.equal(ops.flash_attention(q, k, v, impl="ref"), want)
    with pytest.raises(ValueError, match="impl"):
        ops.flash_attention(q, k, v, impl="pallas")
    with pytest.raises(ValueError, match="positive"):
        ops.flash_attention(q, k, v, block_q=0)


# ---------------------------------------------------------------------------
# On the card: kernels 8-10 against the plain versions
# ---------------------------------------------------------------------------

CARD_CASES = [
    # b, h, kvh, sq, skv, d, causal, window
    (2, 8, 2, 256, 256, 128, True, None),
    (1, 4, 4, 200, 200, 64, True, None),
    (2, 4, 1, 100, 100, 128, False, None),
    (1, 8, 2, 300, 300, 64, True, 48),
    (1, 2, 1, 70, 130, 128, False, 40),
    (1, 4, 2, 130, 60, 64, True, None),
    # chip_smoke's bf16 cases of the tensor-core route: a ragged non-causal
    # S = 1000, a causal window of 256, Sq != Skv with rows 95.. fully
    # masked (o = 0, lse = -1e30), and D = 64.
    (1, 4, 1, 1000, 1000, 128, False, None),
    (1, 4, 1, 1024, 1024, 128, True, 256),
    (1, 4, 2, 200, 64, 128, True, 32),
    (2, 8, 2, 512, 512, 64, True, None),
    # D = 80 (hubert-xlarge), which the bf16 route runs in D = 128 tiles:
    # non-causal ragged, causal, and a window.
    (2, 4, 4, 300, 300, 80, False, None),
    (1, 4, 2, 256, 256, 80, True, None),
    (1, 4, 1, 300, 300, 80, True, 48),
]


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    return torch.device("cuda")


def _card(x, dev, dtype, layout):
    """A (B, heads, S, D) tensor on the card, in (B, H, S, D) or as the
    transposed view of a (B, S, H, D) tensor."""
    t = torch.tensor(x, device=dev).to(TORCH_DT[dtype])
    if layout == "bshd":
        t = t.transpose(1, 2).contiguous().transpose(1, 2)
    return t


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CARD_CASES)
def test_flash_kernels_match_plain_on_card(cuda, case, dtype, layout):
    b, h, kvh, sq, skv, d, causal, window = case
    q, k, v, do = _inputs(9, b, h, kvh, sq, d, skv=skv, extra=1)
    tq, tk, tv, tdo = (_card(a, cuda, dtype, layout) for a in (q, k, v, do))
    kw = dict(causal=causal, window=window)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    btol = 2e-2 if dtype == "bfloat16" else 1e-4
    ops.reset_launch_counts()
    with torch.no_grad():
        o8 = ops.flash_attention(tq, tk, tv, **kw)
    o, lse = ops.flash_attention_fwd(tq, tk, tv, **kw)
    grads = ops.flash_attention_bwd(tq, tk, tv, o, lse, tdo, **kw)
    po, plse = ops.flash_attention_fwd(tq, tk, tv, impl="ref", **kw)
    pgrads = ops.flash_attention_bwd(tq, tk, tv, po, plse, tdo, impl="ref",
                                     **kw)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == 1
    assert torch.equal(o8, o), "kernels 8 and 9 must give the same o"
    torch.testing.assert_close(o.float(), po.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(lse, plse, rtol=tol, atol=tol)
    mha = ref.mha(tq.float(), tk.float(), tv.float(), **kw)
    torch.testing.assert_close(o.float(), mha, rtol=tol, atol=tol)
    for g, pg, t in zip(grads, pgrads, (tq, tk, tv)):
        assert g.dtype == t.dtype and g.stride() == t.stride()
        torch.testing.assert_close(g.float(), pg.float(), rtol=btol,
                                   atol=btol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])  # both routes
def test_flash_kernels_are_deterministic_on_card(cuda, dtype):
    q, k, v, do = _inputs(10, 2, 8, 2, 512, 128, extra=1)
    tq, tk, tv, tdo = (_card(a, cuda, dtype, "bshd") for a in (q, k, v, do))
    runs = []
    for _ in range(2):
        o, lse = ops.flash_attention_fwd(tq, tk, tv)
        runs.append((o, lse) + ops.flash_attention_bwd(tq, tk, tv, o, lse,
                                                       tdo))
    for a, b_ in zip(*runs):
        assert torch.equal(a, b_)


@pytest.mark.cuda
def test_flash_autograd_on_card_matches_plain_autograd(cuda):
    q, k, v, w = _inputs(12, 2, 4, 2, 192, 64, extra=1)
    grads = {}
    for impl in ("cuda", "ref"):
        tq, tk, tv = (torch.tensor(a, device=cuda).requires_grad_()
                      for a in (q, k, v))
        o = ops.flash_attention(tq, tk, tv, window=50, impl=impl)
        grads[impl] = (o,) + torch.autograd.grad(
            (o * torch.tensor(w, device=cuda)).sum(), (tq, tk, tv))
    for a, b_ in zip(grads["cuda"], grads["ref"]):
        torch.testing.assert_close(a, b_, **BWD_TOL)

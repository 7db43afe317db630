"""The numeric design of the bf16 flash kernels, on the CPU.

The tensor-core kernels of ``flash_attention.cu`` take q·kᵀ and do·vᵀ on
bf16 inputs as they are (a bf16 x bf16 product is exact in fp32) and split
the operands they compute, p and ds, into ``hi = bf16(x)`` and ``lo =
bf16(x - hi)``: p·v, pᵀ·do, dsᵀ·q and ds·k each run as two bf16 products
into one fp32 sum.  ``emulate_fwd`` / ``emulate_bwd`` below repeat that
rounding in plain PyTorch (test-local: the package has no such function)
and are held

* against the port's plain versions (``ref.flash_attention_fwd`` /
  ``_bwd``, fp32 arithmetic) under ``chip_smoke.py``'s rule for bf16
  outputs: the fp32 tolerance (2e-5 forward, 1e-4 backward) plus 2 bf16
  steps of the plain value, each side rounding its result to bf16 once;
* against the JAX reference's Pallas kernels (interpret mode, fp32 on
  bf16-representable inputs) under the same rule.

The stubbed tests check what the bf16 route hands the C entries and what
it refuses: views that TMA cannot load.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402

FWD_TOL = dict(rtol=2e-5, atol=2e-5)   # chip_smoke.FP32_FWD_TOL
BWD_TOL = dict(rtol=1e-4, atol=1e-4)   # chip_smoke.FP32_BWD_TOL
BF16_ULPS = 2                          # chip_smoke.BF16_ULPS


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _split(x):
    """``x`` as hi + lo, each a bf16 value (held in float32)."""
    hi = _bf16(x)
    return hi, _bf16(x - hi)


def _prep(q, k, v, causal, window):
    """float32 q, k, v with the KV heads repeated, the scale, the mask."""
    b, h, sq, d = q.shape
    rep = h // k.shape[1]
    kf, vf = (t.float().repeat_interleave(rep, dim=1) for t in (k, v))
    mask = ref._attn_mask(sq, k.shape[2], causal, window, q.device)
    return q.float(), kf, vf, d ** -0.5, mask


def _prod(x, y, split):
    """x·y with x split into hi + lo bf16 (or rounded to bf16 once), y a
    bf16 operand, fp32 accumulation."""
    if not split:
        return _bf16(x) @ y
    hi, lo = _split(x)
    return hi @ y + lo @ y


def emulate_fwd(q, k, v, causal, window, split=True):
    """The forward kernels' rounding: (o rounded to bf16 once, lse fp32).
    ``split=False`` rounds p to bf16 once instead: the design the split
    replaces."""
    qf, kf, vf, sc, mask = _prep(q, k, v, causal, window)
    s = ((qf @ kf.transpose(-1, -2)) * sc).masked_fill(~mask, ref.NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m).masked_fill(~mask, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    return _bf16(_prod(p, vf, split) / l), (m + torch.log(l))[..., 0]


def emulate_bwd(q, k, v, o, lse, do, causal, window, split=True):
    """The backward kernels' rounding from the residuals (o, lse): (dq, dk,
    dv), each rounded to bf16 once; delta = rowsum(do·o) in fp32."""
    b, h, sq, d = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    qf, kf, vf, sc, mask = _prep(q, k, v, causal, window)
    dof = do.float()
    delta = (dof * o.float()).sum(dim=-1, keepdim=True)
    s = (qf @ kf.transpose(-1, -2)) * sc
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    ds = p * (dof @ vf.transpose(-1, -2) - delta) * sc

    def group_sum(x):
        return x.reshape(b, kvh, h // kvh, skv, d).sum(2)

    dq = _prod(ds, kf, split)
    dk = group_sum(_prod(ds.transpose(-1, -2), qf, split))
    dv = group_sum(_prod(p.transpose(-1, -2), dof, split))
    return _bf16(dq), _bf16(dk), _bf16(dv)


def _bf16_ulp(x):
    _, exp = torch.frexp(x.float().abs().clamp_min(1e-30))
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), exp - 8)


def share(got, want, tol, bf16=True):
    """Largest share of ``chip_smoke``'s tolerance that ``got`` uses."""
    got, want = got.float(), want.float()
    allowed = tol["atol"] + tol["rtol"] * want.abs()
    if bf16:
        allowed = allowed + BF16_ULPS * _bf16_ulp(want)
    return ((got - want).abs() / allowed).max().item()


def _inputs(seed, b, h, kvh, s, d):
    rng = np.random.default_rng(seed)
    draw = lambda *shape: torch.tensor(  # noqa: E731
        rng.normal(size=shape), dtype=torch.float32).to(torch.bfloat16)
    return draw(b, h, s, d), draw(b, kvh, s, d), draw(b, kvh, s, d), \
        draw(b, h, s, d)


def _shares(q, k, v, do, causal, window, split=True):
    """Each output's share of the tolerance, the emulation against the
    plain versions (lse fp32, the rest bf16); both backwards run from the
    emulated forward's residuals, as the kernels' backward runs from the
    kernels' forward."""
    o, lse = emulate_fwd(q, k, v, causal, window, split)
    po, plse = ref.flash_attention_fwd(q, k, v, causal, window)
    o = o.to(torch.bfloat16)
    got = emulate_bwd(q, k, v, o, lse, do, causal, window, split)
    want = ref.flash_attention_bwd(q, k, v, o, lse, do, causal, window)
    out = dict(o=share(o, po, FWD_TOL), lse=share(lse, plse, FWD_TOL, False))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        out[name] = share(g, w, BWD_TOL)
    return out


@pytest.mark.parametrize("causal,window", [(True, None), (True, 64)])
def test_split_design_meets_the_bf16_tolerance(causal, window):
    """B = 1, 8/1 heads, S = 512, D = 128: every output of the split
    design within chip_smoke's bf16 rule against the plain versions."""
    q, k, v, do = _inputs(0, 1, 8, 1, 512, 128)
    shares = _shares(q, k, v, do, causal, window)
    assert max(shares.values()) <= 1.0, shares


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax.numpy as jnp

    fa = importlib.import_module("repro.kernels.flash_attention")
    return jnp, fa


@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 8)])
def test_split_design_matches_jax(jx, causal, window):
    """The emulation against the reference's Pallas kernels (interpret
    mode) at B = 1, 4/2 heads, S = 32, D = 16 on bf16-representable
    inputs in float32: within the same rule (fp32 tolerance + 2 bf16 steps
    for the bf16 outputs)."""
    jnp, fa = jx
    q, k, v, do = _inputs(1, 1, 4, 2, 32, 16)
    jq, jk, jv, jdo = (jnp.asarray(t.float().numpy()) for t in (q, k, v, do))
    jo, jlse = fa.flash_attention_fwd_kernel(
        jq, jk, jv, causal=causal, window=window, block_q=8, block_k=8,
        interpret=True)
    jdq, jdk, jdv = fa.flash_attention_bwd_kernel(
        jq, jk, jv, jo, jlse, jdo, causal=causal, window=window, block_q=8,
        block_k=8, interpret=True)
    want = [torch.tensor(np.asarray(x)) for x in (jo, jlse, jdq, jdk, jdv)]
    o, lse = emulate_fwd(q, k, v, causal, window)
    assert share(o, want[0], FWD_TOL) <= 1.0
    assert share(lse, want[1], FWD_TOL, bf16=False) <= 1.0
    # The backward from the reference's residuals, as its kernel runs.
    got = emulate_bwd(q, k, v, want[0], want[1], do, causal, window)
    for name, g, w in zip(("dq", "dk", "dv"), got, want[2:]):
        assert share(g, w, BWD_TOL) <= 1.0, name


# ---------------------------------------------------------------------------
# The bf16 route's launches, stubbed
# ---------------------------------------------------------------------------


class _Stubbed:
    """Record the C entries a call would launch, without launching."""

    def __init__(self, monkeypatch):
        self.calls = []
        monkeypatch.setattr(ops, "_use_kernel", lambda impl, x: impl == "cuda")
        monkeypatch.setattr(ops, "_stream", lambda x: None)
        monkeypatch.setattr(ops, "_launch",
                            lambda symbol, *args: self.calls.append(
                                (symbol, args)))


def _bshd(seed, b=2, s=16, h=4, kvh=2, d=64, pad=0, offset=0):
    """bf16 (B, H, S, D) views of (B, S, H, D + pad) storage, starting
    ``offset`` elements into each row."""
    rng = np.random.default_rng(seed)

    def draw(heads):
        t = torch.tensor(rng.normal(size=(b, s, heads, d + pad)),
                         dtype=torch.bfloat16)
        return t[..., offset:offset + d].transpose(1, 2)

    return draw(h), draw(kvh), draw(kvh)


def test_bf16_route_flags_and_passes_views(monkeypatch):
    stub = _Stubbed(monkeypatch)
    q, k, v = _bshd(0)
    do = torch.ones_like(q)
    o, lse = ops.flash_attention_fwd(q, k, v)
    ops.flash_attention_bwd(q, k, v, o, lse, do)
    names = [c[0] for c in stub.calls]
    assert names == ["repro_flash_attention_lse",
                     "repro_flash_attention_bwd_dkv",
                     "repro_flash_attention_bwd_dq"]
    for _, args in stub.calls:
        assert args[-2] == 1          # the bf16 flag: the tensor-core route
    assert stub.calls[0][1][0].value == q.data_ptr()
    # The dk/dv pass gets its fp32 partial sums: 128-key blocks x 2 x D.
    assert stub.calls[1][1][9].value is not None
    fp32 = _Stubbed(monkeypatch)
    qf, kf, vf = (t.float() for t in (q, k, v))
    of, lf = ops.flash_attention_fwd(qf, kf, vf)
    ops.flash_attention_bwd(qf, kf, vf, of, lf, torch.ones_like(qf))
    assert fp32.calls[1][1][9].value is None


@pytest.mark.parametrize("case", ["odd_stride", "unaligned", "do_odd_stride"])
def test_bf16_route_raises_on_views_tma_cannot_load(monkeypatch, case):
    stub = _Stubbed(monkeypatch)
    if case == "odd_stride":      # rows of 65 elements: 130-byte strides
        q, k, v = _bshd(1, pad=1)
    elif case == "unaligned":     # data 2 bytes past a 16-byte boundary
        q, k, v = _bshd(1, pad=8, offset=1)
    else:
        q, k, v = _bshd(1)
    if case != "do_odd_stride":
        with pytest.raises(ValueError, match="flash_attention.*TMA"):
            ops.flash_attention(q, k, v)
        assert stub.calls == []
        return
    o, lse = ops.flash_attention_fwd(q, k, v)
    do = _bshd(2, pad=1)[0]
    with pytest.raises(ValueError, match="flash_attention_bwd.*TMA"):
        ops.flash_attention_bwd(q, k, v, o, lse, do)
    assert [c[0] for c in stub.calls] == ["repro_flash_attention_lse"]


def test_fp32_route_takes_any_row_contiguous_view(monkeypatch):
    """The SIMT route reads through plain strides: no TMA rule."""
    stub = _Stubbed(monkeypatch)
    q, k, v = (t.float() for t in _bshd(3))
    q = torch.zeros(2, 16, 4, 65)[..., :64].transpose(1, 2)
    ops.flash_attention(q, k, v)
    assert [c[0] for c in stub.calls] == ["repro_flash_attention"]
    assert stub.calls[0][1][-2] == 0

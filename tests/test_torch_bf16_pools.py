"""bf16 KV pools in the port against the JAX reference, and on the card.

The reference serves from bf16 pages by default: ``kv_dtype=None`` means
the config's compute dtype, bf16 for every full-size config.  K/V rows are
computed in fp32, rounded to bf16 once when they are written (round to
nearest even: XLA's ``convert``, ``Tensor.to``, the write kernel's
``__float2bfloat16_rn``) and widened back to fp32, exactly, when attention
loads them; q, the weights and all arithmetic stay fp32.

On the CPU, with inputs made from seeds with numpy and weights carried
across by ``params_from_numpy``:

* every bf16 spelling, and ``None`` on a bf16 config, resolves and builds
  bf16 pools with no scale pools; ``pool_bytes`` equals the reference's
  for bf16, fp32 and int8; a model and a cache of other widths refuse
  each other;
* the paged writes into bf16 pools bitwise against the reference's
  ``impl='ref'`` (under ``jax.jit``, as its engine runs them).  The
  reference's ``impl='pallas'`` write refuses fp32 rows into a bf16 pool
  on the installed jax (its interpret mode's ``swap`` takes no dtype
  mismatch), so it is fed the rows already rounded, and the port's write
  of the fp32 rows must equal that bitwise;
* the plain decode, prefill and verify attention on bf16 pools within
  rtol = atol = 1e-5 of the reference's ``impl='ref'``, and bitwise equal
  to the same plain version on the pools widened to fp32;
* ``PagedLM``'s prefill and decode logits within 1e-5 of the reference's;
  the ``Scheduler``'s greedy streams with evictions, prefix sharing and
  ``spec_k = 4`` equal to the JAX scheduler's, with equal ``ServeStats``
  byte accounting;
* the bf16 attention plan as plain Python.

On the card (marked ``cuda``, skipped elsewhere; ``python -m pytest -m
cuda tests/test_torch_bf16_pools.py``): each kernel on bf16 pools against
its plain version, and bitwise against the same kernel on the pools
widened to fp32; the write bitwise against its plain version.
"""
import dataclasses
import functools
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.kernels import ops, plans, ref  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    PagedKVCache,
    PagedLM,
    Request,
    Scheduler,
    params_from_numpy,
)
from repro_torch.serve.kv import resolve_kv_dtype  # noqa: E402

CFG = smoke_config("yi-6b")
BF16_CFG = dataclasses.replace(CFG, dtype="bfloat16")
CPU = "cpu"
TOL = dict(rtol=1e-5, atol=1e-5)

#: (kv_dtype, config) pairs that must give bf16 pools.
SPELLINGS = {
    "bf16": ("bf16", CFG),
    "bfloat16": ("bfloat16", CFG),
    "torch.bfloat16": (torch.bfloat16, CFG),
    "None on a bf16 config": (None, BF16_CFG),
}


@pytest.fixture(scope="module")
def jx():
    """The JAX reference, imported here so that the card's tests run where
    JAX is not installed."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro import serve
    from repro.configs import smoke_config as jax_smoke
    from repro.kernels import ops as jops

    class JX:
        pass

    ns = JX()
    ns.jax, ns.jnp, ns.ops, ns.serve = jax, jnp, jops, serve
    ns.cfg = jax_smoke("yi-6b")
    ns.jit = lambda fn, **static: jax.jit(functools.partial(fn, **static))
    return ns


def _rng(*key) -> np.random.Generator:
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _t(x, device=CPU):
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def _bf16(x: np.ndarray) -> torch.Tensor:
    """fp32 numpy → a bf16 tensor, rounded to nearest even."""
    return _t(x.astype(np.float32)).to(torch.bfloat16)


def _np(t: torch.Tensor) -> np.ndarray:
    """A tensor as numpy, bf16 widened to fp32 (exact)."""
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _jnp(jx, t: torch.Tensor):
    """A port tensor as a JAX array of the same dtype."""
    a = jx.jnp.asarray(_np(t))
    return a.astype(jx.jnp.bfloat16) if t.dtype == torch.bfloat16 else a


# ---------------------------------------------------------------------------
# Dtype resolution, pools, the width agreement check
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(SPELLINGS))
def test_every_bf16_spelling_builds_bf16_pools(jx, name):
    kv_dtype, cfg = SPELLINGS[name]
    assert resolve_kv_dtype(cfg, kv_dtype) == torch.bfloat16
    cache = PagedKVCache.create(cfg, 3, 32, page=4, kv_dtype=kv_dtype,
                                device=CPU)
    jkv = jx.jnp.bfloat16 if kv_dtype is torch.bfloat16 else kv_dtype
    jcache = jx.serve.PagedKVCache.create(
        dataclasses.replace(jx.cfg, dtype=cfg.dtype), 3, 32, page=4,
        kv_dtype=jkv)
    for pool, jpool in ((cache.k_pages, jcache.k_pages),
                        (cache.v_pages, jcache.v_pages)):
        assert pool.dtype == torch.bfloat16
        assert str(jpool.dtype) == "bfloat16"
        assert tuple(pool.shape) == tuple(jpool.shape)
        assert not pool.any()
    assert cache.k_scale is None and cache.v_scale is None
    assert jcache.k_scale is None and not cache.quantized
    model = PagedLM(cfg, kv_dtype=kv_dtype, device=CPU)
    assert model.kv_dtype == torch.bfloat16 and model.kv_elem_bits == 16
    assert not model.quantized and model.kv_scale_token_bytes == 0


def test_no_unported_kv_dtype_is_left():
    """The port names no bf16 refusal any more; unknown names raise."""
    for kv_dtype in ("fp32", "float32", "bf16", "bfloat16", "int8"):
        resolve_kv_dtype(CFG, kv_dtype)
    with pytest.raises(ValueError, match="unknown kv_dtype"):
        resolve_kv_dtype(CFG, "fp8")
    with pytest.raises(ValueError, match="unsupported KV pool dtype"):
        resolve_kv_dtype(CFG, torch.float64)


@pytest.mark.parametrize("kv_dtype", ["bf16", "fp32", "int8"])
@pytest.mark.parametrize("pool_pages", [None, 5])
def test_pool_bytes_equal_jax(jx, kv_dtype, pool_pages):
    kw = dict(batch=2, max_len=32, page=4, pool_pages=pool_pages,
              kv_dtype=kv_dtype)
    got = PagedKVCache.create(CFG, device=CPU, **kw).pool_bytes
    assert got == jx.serve.PagedKVCache.create(jx.cfg, **kw).pool_bytes
    fp32 = PagedKVCache.create(CFG, device=CPU,
                               **{**kw, "kv_dtype": "fp32"}).pool_bytes
    if kv_dtype == "bf16":
        assert 2 * got == fp32


@pytest.mark.parametrize("model_dtype,cache_dtype",
                         [("bf16", "fp32"), ("fp32", "bf16"),
                          ("bf16", "int8"), ("int8", "bf16")])
def test_model_and_cache_widths_must_agree(model_dtype, cache_dtype):
    """A bf16 model over fp32 pools would halve every packed byte count,
    and the reverse double it: the family refuses, as the reference's."""
    model = PagedLM(CFG, kv_dtype=model_dtype, device=CPU)
    cache = PagedKVCache.create(CFG, 2, 16, page=4, kv_dtype=cache_dtype,
                                device=CPU)
    with pytest.raises(ValueError, match="kv_dtype"):
        Scheduler(model, cache, chunk=4)
    Scheduler(model, PagedKVCache.create(CFG, 2, 16, page=4,
                                         kv_dtype=model.kv_dtype,
                                         device=CPU), chunk=4)


def test_copy_on_write_share_and_trim_keep_bf16_pages():
    """``share`` maps pages, ``ensure_writable`` copies a shared bf16 page
    bit for bit into a private one, ``trim`` unmaps without touching the
    pool."""
    rng = _rng("cow")
    cache = PagedKVCache.create(CFG, 2, 32, page=4, kv_dtype="bf16",
                                device=CPU)
    cache.k_pages.copy_(_bf16(rng.standard_normal(cache.k_pages.shape)))
    cache.v_pages.copy_(_bf16(rng.standard_normal(cache.v_pages.shape)))
    before = (cache.k_pages.clone(), cache.v_pages.clone())
    cache = cache.allocate(0, 3)
    ids = [int(p) for p in cache.page_table_host[0, :3]]
    cache = cache.share(1, ids[:2])
    cache, n = cache.ensure_writable(1, 0, 7)
    assert n == 2
    new = [int(p) for p in cache.page_table_host[1, :2]]
    assert not set(new) & set(ids)
    for pool, old in zip((cache.k_pages, cache.v_pages), before):
        assert pool.dtype == torch.bfloat16
        assert torch.equal(pool[:, new], old[:, ids[:2]])
        assert torch.equal(pool[:, ids], old[:, ids])
    trimmed = cache.trim(0, 1)
    assert torch.equal(trimmed.k_pages, cache.k_pages)
    trimmed.check_integrity()


# ---------------------------------------------------------------------------
# Paged writes into bf16 pools: bitwise
# ---------------------------------------------------------------------------

POOL, PAGE, N_PAGES = 24, 4, 4


def _bf16_pools(rng, kvh, d):
    shape = (POOL, PAGE, kvh, d)
    return (_bf16(rng.standard_normal(shape)),
            _bf16(rng.standard_normal(shape)))


def _new_rows(rng, shape):
    """fp32 rows with exact bf16 ties (1 + 2**-8, odd and even neighbours)
    and values that round up, down and past a binade."""
    x = rng.standard_normal(shape).astype(np.float32)
    flat = x.reshape(-1)
    ties = np.array([1 + 2 ** -8, 1 + 3 * 2 ** -8, -(1 + 2 ** -8),
                     2 - 2 ** -9, 1 + 2 ** -8 + 2 ** -20], np.float32)
    flat[: len(ties)] = ties
    return x


def _table(rng, rows):
    return rng.permutation(POOL)[: rows * N_PAGES].reshape(
        rows, N_PAGES).astype(np.int32)


@pytest.mark.parametrize("impl", ["cuda", "ref"])
def test_paged_kv_append_into_bf16_bitwise_vs_jax(jx, impl):
    """Inactive rows and an append past the table row write nothing."""
    rng = _rng("append")
    kvh, d = 2, 8
    kp, vp = _bf16_pools(rng, kvh, d)
    table = _table(rng, 4)
    lengths = np.array([0, 5, N_PAGES * PAGE, 7], np.int32)
    active = np.array([True, True, True, False])
    k_new = _new_rows(rng, (4, kvh, d))
    v_new = _new_rows(rng, (4, kvh, d))
    got = ops.paged_kv_append(
        kp.clone(), vp.clone(), _t(k_new), _t(v_new), _t(table),
        _t(lengths), _t(active), impl=impl)
    want = jx.jit(jx.ops.paged_kv_append, impl="ref")(
        _jnp(jx, kp), _jnp(jx, vp), jx.jnp.asarray(k_new),
        jx.jnp.asarray(v_new), jx.jnp.asarray(table),
        jx.jnp.asarray(lengths), jx.jnp.asarray(active))
    assert got[0].dtype == got[1].dtype == torch.bfloat16
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), np.asarray(w, np.float32))
    # The written rows are the fp32 rows rounded once.
    row = int(table[1, 5 // PAGE]) * PAGE + 5 % PAGE
    assert torch.equal(got[0].view(-1, kvh, d)[row],
                       _t(k_new[1]).to(torch.bfloat16))


@pytest.mark.parametrize("impl", ["cuda", "ref"])
def test_paged_kv_write_chunk_into_bf16_bitwise_vs_jax(jx, impl):
    """A chunk straddling a page boundary, a ragged one and a padding
    row; the write kernel's plain version (``ops.paged_kv_write``) too."""
    rng = _rng("chunk")
    kvh, d, c = 2, 8, 4
    kp, vp = _bf16_pools(rng, kvh, d)
    rows = _table(rng, 3)
    starts = np.array([0, 6, 9], np.int32)
    counts = np.array([4, 3, 0], np.int32)
    k_new = _new_rows(rng, (3, c, kvh, d))
    v_new = _new_rows(rng, (3, c, kvh, d))
    args = [_t(a) for a in (k_new, v_new, rows, starts, counts)]
    got = ops.paged_kv_write_chunk(kp.clone(), vp.clone(), *args, impl=impl)
    direct = ops.paged_kv_write(kp.clone(), vp.clone(), *args, impl=impl)
    want = jx.jit(jx.ops.paged_kv_write_chunk, impl="ref")(
        _jnp(jx, kp), _jnp(jx, vp),
        *[jx.jnp.asarray(a) for a in (k_new, v_new, rows, starts, counts)])
    for g, dr, w in zip(got, direct, want):
        assert g.dtype == torch.bfloat16
        np.testing.assert_array_equal(_np(g), np.asarray(w, np.float32))
        assert torch.equal(g, dr)


@pytest.mark.parametrize("what", ["append", "chunk"])
def test_bf16_write_equals_jax_pallas_on_rounded_rows(jx, what):
    """The reference's converter path (Pallas, interpret mode) takes no
    fp32 rows into a bf16 pool on this jax, so it gets the rows rounded
    by XLA's convert; the port's write of the fp32 rows equals it."""
    rng = _rng("pallas", what)
    kvh, d = 2, 8
    kp, vp = _bf16_pools(rng, kvh, d)
    table = _table(rng, 3)
    if what == "append":
        shape, st, ct = (3, kvh, d), [2, 8, 4], [1, 1, 0]
        fn = jx.ops.paged_kv_append
    else:
        shape, st, ct = (3, 5, kvh, d), [2, 8, 4], [5, 3, 0]
        fn = jx.ops.paged_kv_write_chunk
    k_new, v_new = _new_rows(rng, shape), _new_rows(rng, shape)
    st, ct = np.array(st, np.int32), np.array(ct, np.int32)
    jargs = [jx.jnp.asarray(a).astype(jx.jnp.bfloat16) for a in (k_new, v_new)]
    tail = [jx.jnp.asarray(table), jx.jnp.asarray(st)]
    tail.append(jx.jnp.asarray(ct.astype(bool)) if what == "append"
                else jx.jnp.asarray(ct))
    want = fn(_jnp(jx, kp), _jnp(jx, vp), *jargs, *tail, impl="pallas")
    if what == "append":
        got = ops.paged_kv_append(kp.clone(), vp.clone(), _t(k_new),
                                  _t(v_new), _t(table), _t(st),
                                  _t(ct.astype(bool)))
    else:
        got = ops.paged_kv_write_chunk(kp.clone(), vp.clone(), _t(k_new),
                                       _t(v_new), _t(table), _t(st), _t(ct))
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(_np(g), np.asarray(w, np.float32))


# ---------------------------------------------------------------------------
# Plain attention on bf16 pools
# ---------------------------------------------------------------------------

GQA = {1: (4, 4), 2: (4, 2), 4: (8, 2)}
DECODE_LENGTHS = {"ragged": [1, 7, 14], "with_empty": [0, 5, 16]}
PREFILL_ROWS = {"ragged": ([0, 5, 9], [4, 3, 2]),
                "padding_rows": ([3, 0, 6], [2, 0, 4])}


def _attn_inputs(key, gqa, b, q_shape, d=16):
    h, kvh = GQA[gqa]
    rng = _rng(*key)
    q = rng.standard_normal((b,) + q_shape(h) + (d,)).astype(np.float32)
    kp, vp = _bf16_pools(rng, kvh, d)
    return q, kp, vp, _table(rng, b)


@pytest.mark.parametrize("gqa", sorted(GQA))
@pytest.mark.parametrize("lengths", sorted(DECODE_LENGTHS))
def test_plain_decode_on_bf16_vs_jax(jx, gqa, lengths):
    lens = np.array(DECODE_LENGTHS[lengths], np.int32)
    q, kp, vp, table = _attn_inputs(("decode", gqa, lengths), gqa,
                                    len(lens), lambda h: (h,))
    got = ops.paged_decode_attention(_t(q), kp, vp, _t(table), _t(lens))
    want = jx.ops.paged_decode_attention(
        jx.jnp.asarray(q), _jnp(jx, kp), _jnp(jx, vp),
        jx.jnp.asarray(table), jx.jnp.asarray(lens), impl="ref")
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert not got.numpy()[lens == 0].any()
    widened = ops.paged_decode_attention(_t(q), kp.float(), vp.float(),
                                         _t(table), _t(lens))
    assert torch.equal(got, widened)


@pytest.mark.parametrize("verify", [False, True], ids=["prefill", "verify"])
@pytest.mark.parametrize("gqa", sorted(GQA))
@pytest.mark.parametrize("rows", sorted(PREFILL_ROWS))
def test_plain_prefill_and_verify_on_bf16_vs_jax(jx, verify, gqa, rows):
    starts, counts = (np.array(a, np.int32) for a in PREFILL_ROWS[rows])
    q, kp, vp, table = _attn_inputs(("prefill", verify, gqa, rows), gqa,
                                    len(starts), lambda h: (4, h))
    fn = ops.paged_verify if verify else ops.paged_prefill_attention
    jfn = jx.ops.paged_verify if verify else jx.ops.paged_prefill_attention
    got = fn(_t(q), kp, vp, _t(table), _t(starts), _t(counts))
    want = jfn(jx.jnp.asarray(q), _jnp(jx, kp), _jnp(jx, vp),
               jx.jnp.asarray(table), jx.jnp.asarray(starts),
               jx.jnp.asarray(counts), impl="ref")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert not got.numpy()[counts == 0].any()
    widened = fn(_t(q), kp.float(), vp.float(), _t(table), _t(starts),
                 _t(counts))
    assert torch.equal(got, widened)


def test_pool_checks_take_bf16_and_refuse_mixtures():
    """The kernels' layout check: bf16 pairs without scales pass; a bf16
    pool with scales, mixed dtypes, or int8 without scales raise with a
    message, never falling back."""
    shape = (4, 4, 2, 16)
    bf = torch.zeros(shape, dtype=torch.bfloat16)
    f32 = torch.zeros(shape)
    i8 = torch.zeros(shape, dtype=torch.int8)
    sc = torch.ones(shape[:3])
    dev = torch.device(CPU)
    assert ops._check_pools(bf, bf, None, None, dev) == 2
    assert ops._check_pools(f32, f32, None, None, dev) == 4
    assert ops._check_pools(i8, i8, sc, sc, dev) == 1
    for k, v, ks, vs in ((bf, bf, sc, sc), (bf, f32, None, None),
                         (f32, bf, None, None), (i8, i8, None, None),
                         (bf, i8, None, None)):
        with pytest.raises(ValueError, match="pool"):
            ops._check_pools(k, v, ks, vs, dev)


# ---------------------------------------------------------------------------
# The model and the scheduler at bf16 against JAX
# ---------------------------------------------------------------------------

FP32_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def weights(jx):
    jm = jx.serve.PagedLM(jx.cfg, jx.jax.random.PRNGKey(0), impl="ref")
    return {k: np.asarray(v) for k, v in jm.params.items()}


@pytest.fixture(scope="module")
def jax_bf16(jx, weights):
    jm = jx.serve.PagedLM(jx.cfg, jx.jax.random.PRNGKey(0), impl="ref",
                          kv_dtype="bf16")
    jm.params = {k: jx.jnp.asarray(v) for k, v in weights.items()}
    return jm


def _port(weights, kv_dtype="bf16", **kw):
    return PagedLM(CFG, params=params_from_numpy(weights, device=CPU),
                   device=CPU, kv_dtype=kv_dtype, **kw)


def _prompts(seed, lens, prefix=0):
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, CFG.vocab, prefix).astype(np.int32)
    return [np.concatenate([shared, rng.integers(0, CFG.vocab, n)]).astype(
        np.int32) for n in lens]


def _host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _prefill_then_decode(model, cache, prompts, chunk=4):
    n, plen = len(prompts), len(prompts[0])
    for i in range(n):
        cache = cache.allocate(i, cache.pages_for(plen + 1))
    for start in range(0, plen, chunk):
        toks = np.stack([p[start:start + chunk] for p in prompts])
        logits, cache = model.prefill_batch(
            toks, np.full(n, chunk, np.int32), np.arange(n, dtype=np.int32),
            np.full(n, start, np.int32), cache)
    pre = _host(logits)
    nxt = np.argmax(pre, axis=-1).astype(np.int32)
    logits, cache = model.decode_step(nxt, cache, np.ones(n, bool))
    return pre, _host(logits), cache


def test_prefill_and_decode_logits_at_bf16_vs_jax(jx, jax_bf16, weights):
    prompts = _prompts(3, (8, 8, 8, 8))
    geometry = dict(batch=4, max_len=32, page=4, kv_dtype="bf16")
    jpre, jdec, jcache = _prefill_then_decode(
        jax_bf16, jx.serve.PagedKVCache.create(jx.cfg, **geometry), prompts)
    pre, dec, cache = _prefill_then_decode(
        _port(weights), PagedKVCache.create(CFG, device=CPU, **geometry),
        prompts)
    np.testing.assert_allclose(pre, jpre, **FP32_TOL)
    np.testing.assert_allclose(dec, jdec, **FP32_TOL)
    assert cache.k_pages.dtype == torch.bfloat16
    # The pools the two engines wrote: bf16 rows of the same fp32 K/V.
    jk = np.asarray(jcache.k_pages, np.float32)
    k = _np(cache.k_pages)
    assert (k == jk).mean() > 0.999


def _run(sched_cls, req_cls, model, cache, prompts, max_new, chunk=4,
         **kw):
    sched = sched_cls(model, cache, chunk=chunk, **kw)
    for i, p in enumerate(prompts):
        sched.submit(req_cls(rid=i, prompt=p, max_new=max_new))
    return sched.run(), sched


def _stats(st):
    return (st.tokens, st.n_evictions, st.prefill_tokens_saved,
            st.useful_bytes, st.base_bytes, st.pack_bytes,
            [dataclasses.astuple(r.traffic) for r in st.records])


SCHED_CASES = {
    # name: (seed, prompt lengths, shared prefix, pool pages, sharing)
    "tight_pool_eviction": (7, (9, 10, 11, 7), 0, 7, False),
    "prefix_sharing": (2, (3, 6, 1, 5), 9, None, True),
}


@pytest.mark.parametrize("case", sorted(SCHED_CASES))
def test_scheduler_streams_and_stats_at_bf16_equal_jax(jx, jax_bf16,
                                                       weights, case):
    seed, lens, prefix, pool, sharing = SCHED_CASES[case]
    prompts = _prompts(seed, lens, prefix)
    geometry = dict(batch=4, max_len=32, page=4, pool_pages=pool,
                    kv_dtype="bf16")
    want, jsched = _run(
        jx.serve.Scheduler, jx.serve.Request, jax_bf16,
        jx.serve.PagedKVCache.create(jx.cfg, **geometry), prompts, 6,
        prefix_sharing=sharing)
    got, sched = _run(
        Scheduler, Request, _port(weights),
        PagedKVCache.create(CFG, device=CPU, **geometry), prompts, 6,
        prefix_sharing=sharing)
    assert got == want
    assert _stats(sched.stats) == _stats(jsched.stats)
    if pool is not None:
        assert sched.stats.n_evictions >= 1
    if sharing:
        assert sched.stats.prefill_tokens_saved > 0
    assert sched.cache.k_pages.dtype == torch.bfloat16


def test_speculative_scheduler_at_bf16_equals_jax(jx):
    """spec_k = 4 with an n-gram drafter in a tight pool: the same tokens,
    verify steps, evictions, drafts and bytes as the JAX scheduler, on
    weights sharpened so that the greedy streams vary."""
    jm = jx.serve.PagedLM(jx.cfg, jx.jax.random.PRNGKey(3), impl="ref",
                          spec_k=4, kv_dtype="bf16")
    jm.params = {k: v * (3.0 if k == "embed" else 8.0)
                 for k, v in jm.params.items()}
    port = _port({k: np.asarray(v) for k, v in jm.params.items()},
                 spec_k=4)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, CFG.vocab, n).astype(np.int32)
               for n in (5, 12, 9)]
    geometry = dict(batch=4, max_len=64, page=8, pool_pages=6,
                    kv_dtype="bf16")
    want, jsched = _run(jx.serve.Scheduler, jx.serve.Request, jm,
                        jx.serve.PagedKVCache.create(jx.cfg, **geometry),
                        prompts, 14, chunk=8)
    got, sched = _run(Scheduler, Request, port,
                      PagedKVCache.create(CFG, device=CPU, **geometry),
                      prompts, 14, chunk=8)
    assert got == want
    st, jst = sched.stats, jsched.stats
    assert st.spec_steps == jst.spec_steps > 0
    assert st.n_evictions == jst.n_evictions >= 1
    assert (st.n_drafted, st.n_accepted) == (jst.n_drafted, jst.n_accepted)
    assert _stats(st) == _stats(jst)
    assert all(len(set(v)) > 1 for v in got.values())


def test_bf16_pools_move_half_the_packed_bytes_of_fp32(weights):
    """The packed-byte accounting follows the element width: the same
    run's PACK bytes of KV at bf16 are half those at fp32 (scale bytes
    exist only for int8), and the useful bytes the same fraction."""
    prompts = _prompts(5, (6, 9, 4))
    stats = {}
    for kv in ("fp32", "bf16"):
        _, sched = _run(Scheduler, Request, _port(weights, kv),
                        PagedKVCache.create(CFG, 4, 32, page=4, kv_dtype=kv,
                                            device=CPU), prompts, 5)
        stats[kv] = sched.stats
    assert stats["bf16"].tokens == stats["fp32"].tokens
    assert 0 < stats["bf16"].pack_bytes < stats["fp32"].pack_bytes
    assert 0 < stats["bf16"].useful_bytes < stats["fp32"].useful_bytes


# ---------------------------------------------------------------------------
# The bf16 attention plan, as plain Python
# ---------------------------------------------------------------------------

#: chip_smoke.py's yi-6b launches (decode, prefill chunk of 32, verify of
#: K = 4) and smaller head dims.
PLAN_SHAPES = {
    "decode": ("decode", 8, 1, 32, 4, 128, 16, 32),
    "prefill": ("prefill", 8, 32, 32, 4, 128, 16, 32),
    "verify": ("prefill", 8, 4, 32, 4, 128, 16, 32),
    "d64": ("prefill", 4, 16, 8, 2, 64, 16, 9),
    "d32": ("prefill", 2, 8, 4, 4, 32, 8, 8),
    "d16 decode": ("decode", 3, 1, 8, 1, 16, 4, 6),
}


@pytest.mark.parametrize("name", sorted(PLAN_SHAPES))
def test_bf16_plan(name):
    shape = PLAN_SHAPES[name]
    d = shape[5]
    plan = plans.attention_plan(*shape, elem_bytes=2, align=256)
    fp32 = plans.attention_plan(*shape, elem_bytes=4, align=256)
    assert plan.unit == 16
    assert plan.smem_bytes <= plans.SMEM_PER_BLOCK
    # The split does not depend on the element: the same bits as fp32.
    for f in ("span", "spans", "kv_tile", "tq", "tile_rows", "q_tiles",
              "threads", "combine_blocks"):
        assert getattr(plan, f) == getattr(fp32, f), f
    # bf16 rows of K then V in each of two raw stages, no scales; one
    # stage of the widened fp32 tiles.
    assert plan.raw_stage == 2 * plan.kv_tile * d * 2
    assert plan.v_off - plan.k_off == plan.k_stage
    assert plan.raw_off - plan.v_off == plan.v_stage
    assert plan.pt_off - plan.raw_off == 2 * plan.raw_stage
    assert plan.raw_off % 16 == 0 and plan.raw_stage % 16 == 0
    assert plans.attention_plan(*shape, elem_bytes=2, align=4).unit == 4


def test_bf16_plan_refusals():
    """Rows off 4-byte alignment have no cp.async unit; head dim 80 (no
    paged family has it: hubert-xlarge is encoder-only) has no plan at any
    element width; an unknown element width raises."""
    shape = PLAN_SHAPES["decode"]
    with pytest.raises(ValueError, match="bf16 elements"):
        plans.attention_plan(*shape, elem_bytes=2, align=1)
    for elem in (4, 2, 1):
        with pytest.raises(ValueError, match="head_dim"):
            plans.attention_plan("decode", 8, 1, 32, 4, 80, 16, 32, elem, 256)
    with pytest.raises(ValueError, match="pool elements"):
        plans.attention_plan(*shape, elem_bytes=8, align=256)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the kernels are CUDA-only")
    return torch.device("cuda")


def _card_case(rng, dev, b, q_shape, h=32, kvh=4, d=128, page=16, width=12):
    pool = b * width + 4
    shape = (pool, page, kvh, d)
    kp = _bf16(rng.standard_normal(shape)).to(dev)
    vp = _bf16(rng.standard_normal(shape)).to(dev)
    table = _t(rng.permutation(pool)[: b * width].reshape(b, width)
               .astype(np.int32), dev)
    q = _t(rng.standard_normal((b,) + q_shape + (h, d)).astype(np.float32),
           dev)
    return q, kp, vp, table


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 64, 128])
def test_decode_kernel_on_bf16_on_card(cuda, d):
    rng = _rng("card decode", d)
    lens = _t(np.array([0, 1, 64, 63, 65, 16, 17, 192], np.int32), cuda)
    q, kp, vp, table = _card_case(rng, cuda, 8, (), d=d)
    ops.reset_launch_counts()
    got = ops.paged_decode_attention(q, kp, vp, table, lens)
    want = ops.paged_decode_attention(q, kp, vp, table, lens, impl="ref")
    widened = ops.paged_decode_attention(q, kp.float(), vp.float(), table,
                                         lens)
    torch.cuda.synchronize()
    assert ops.paged_decode_attention.launches == 2
    torch.testing.assert_close(got, want, **TOL)
    assert torch.equal(got, widened)
    assert not got[0].any()


@pytest.mark.cuda
@pytest.mark.parametrize("verify", [False, True], ids=["prefill", "verify"])
def test_prefill_kernel_on_bf16_on_card(cuda, verify):
    rng = _rng("card prefill", verify)
    chunk = 4 if verify else 32
    rows = [(0, 32), (0, 0), (5, 32), (32, 32), (60, 9), (96, 32), (64, 1),
            (150, 32)]
    st = _t(np.array([s for s, _ in rows], np.int32), cuda)
    ct = _t(np.array([min(c, chunk) for _, c in rows], np.int32), cuda)
    q, kp, vp, table = _card_case(rng, cuda, 8, (chunk,))
    fn = ops.paged_verify if verify else ops.paged_prefill_attention
    ops.reset_launch_counts()
    got = fn(q, kp, vp, table, st, ct)
    want = fn(q, kp, vp, table, st, ct, impl="ref")
    widened = fn(q, kp.float(), vp.float(), table, st, ct)
    torch.cuda.synchronize()
    assert fn.launches == 2
    torch.testing.assert_close(got, want, **TOL)
    assert torch.equal(got, widened)
    assert not got[ct == 0].any()


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [1, 32])
def test_paged_kv_write_into_bf16_on_card(cuda, chunk):
    rng = _rng("card write", chunk)
    kvh, d, page, width, r = 4, 128, 16, 12, 8
    pool = r * width + 4
    kp, vp = (_bf16(rng.standard_normal((pool, page, kvh, d))).to(cuda)
              for _ in range(2))
    table = _t(rng.permutation(pool)[: r * width].reshape(r, width)
               .astype(np.int32), cuda)
    st = _t(np.array([0, 17, 40, 63, 100, 150, 5, 9], np.int32), cuda)
    ct = _t(np.array([chunk] * 7 + [0], np.int32), cuda)
    new = [_t(_new_rows(rng, (r, chunk, kvh, d)), cuda) for _ in range(2)]
    got = [kp.clone(), vp.clone()]
    want = [kp.clone(), vp.clone()]
    ops.reset_launch_counts()
    ops.paged_kv_write(*got, *new, table, st, ct)
    ops.paged_kv_write(*want, *new, table, st, ct, impl="ref")
    torch.cuda.synchronize()
    assert ops.paged_kv_write.launches == 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)

"""Speculative decoding in the port against the JAX reference, and on the
card.

* ``ops.paged_verify`` — the prefill kernel launched with
  ``starts = lengths`` — against the reference's ``paged_verify`` oracle
  within rtol = atol = 1e-5 (its own sweep's tolerance), over K × GQA ×
  ragged, page-straddling rows × fp32/int8 pools.  The Pallas verify
  kernel goes through the prefill kernel, which does not run on the
  installed jax (``pltpu.TPUCompilerParams`` is gone), so the reference's
  ``impl='ref'`` is the oracle.
* ``ops.speculative_accept`` and the drafters' states against JAX,
  bitwise.
* The engine and the scheduler: emitted tokens equal plain greedy decode
  for every ``spec_k``, whatever the drafter, through evictions; and the
  port's scheduler emits the JAX scheduler's tokens on the same weights.
"""
import dataclasses
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.core import spec_verify_traffic, verify_table_streams  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    NGramDrafter,
    PagedKVCache,
    PagedLM,
    Request,
    Scheduler,
    TinyLMDrafter,
    params_from_numpy,
    static_batch_generate,
)

CFG = smoke_config("yi-6b")
CPU = "cpu"
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def jx():
    """The JAX reference, imported here so that the card's tests run where
    JAX is not installed."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro import serve
    from repro.configs import smoke_config as jax_smoke
    from repro.kernels import ops as jops, ref as jref

    class JX:
        pass

    ns = JX()
    ns.jax, ns.jnp, ns.ops, ns.ref, ns.serve = jax, jnp, jops, jref, serve
    ns.cfg = jax_smoke("yi-6b")
    return ns


def _rng(*key) -> np.random.Generator:
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _t(x, device=CPU):
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


# ---------------------------------------------------------------------------
# Verify attention
# ---------------------------------------------------------------------------


def _verify_case(rng, b, k, h, kvh, d, pool, page, ctx, lengths, counts,
                 int8=False):
    """Numpy inputs; int8 pools are the reference's quantizer's codes."""
    kp = rng.standard_normal((pool, page, kvh, d)).astype(np.float32)
    vp = rng.standard_normal((pool, page, kvh, d)).astype(np.float32)
    q = rng.standard_normal((b, k, h, d)).astype(np.float32)
    rows = rng.permutation(pool)[: b * ctx].reshape(b, ctx).astype(np.int32)
    scales = {}
    if int8:
        kp, ks = (a.numpy() for a in ref.quantize_kv(torch.from_numpy(kp)))
        vp, vs = (a.numpy() for a in ref.quantize_kv(torch.from_numpy(vp)))
        scales = dict(k_scale=ks, v_scale=vs)
    return (q, kp, vp, rows, np.asarray(lengths, np.int32),
            np.asarray(counts, np.int32), scales)


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("gqa", [1, 2, 4])
@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
def test_paged_verify_vs_jax(jx, k, gqa, int8):
    """Per-row live lengths differ by pages; one row starts mid-page and
    straddles a page boundary, one lands on a boundary, and a padding row
    (``counts == 0``) stays all zero."""
    h, kvh, d = 4, 4 // gqa, 16
    q, kp, vp, rows, lens, cnts, sc = _verify_case(
        _rng("verify", k, gqa, int8), b=4, k=k, h=h, kvh=kvh, d=d, pool=32,
        page=4, ctx=6, lengths=[0, 3, 8, 13], counts=[k, k, k, 0],
        int8=int8)
    want = jx.ops.paged_verify(
        *[jx.jnp.asarray(a) for a in (q, kp, vp, rows, lens, cnts)],
        impl="ref", **{n: jx.jnp.asarray(a) for n, a in sc.items()})
    got = ops.paged_verify(*[_t(a) for a in (q, kp, vp, rows, lens, cnts)],
                           **{n: _t(a) for n, a in sc.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert np.isfinite(got.numpy()).all()
    assert not got[3].any()


def test_verify_is_prefill_at_the_tail():
    """Inside the port, verify over live length L is the prefill kernel's
    plain version with ``starts = L``, bit for bit."""
    q, kp, vp, rows, lens, cnts, _ = _verify_case(
        _rng("tail"), b=3, k=4, h=4, kvh=2, d=16, pool=24, page=4, ctx=5,
        lengths=[2, 7, 12], counts=[4, 4, 3])
    args = [_t(a) for a in (q, kp, vp, rows, lens, cnts)]
    assert torch.equal(ops.paged_verify(*args),
                       ops.paged_prefill_attention(*args))


def test_verify_counts_its_own_launches():
    """On the CPU nothing launches; the verify wrapper is a kernel of its
    own in the launch table, next to the prefill kernel it reuses."""
    ops.reset_launch_counts()
    q, kp, vp, rows, lens, cnts, _ = _verify_case(
        _rng("count"), b=2, k=2, h=2, kvh=2, d=8, pool=8, page=4, ctx=2,
        lengths=[1, 3], counts=[2, 1])
    ops.paged_verify(*[_t(a) for a in (q, kp, vp, rows, lens, cnts)])
    counts = ops.launch_counts()
    assert "paged_verify" in counts and "paged_prefill_attention" in counts
    assert set(counts.values()) == {0}


# ---------------------------------------------------------------------------
# Acceptance rule and drafters: bitwise against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_speculative_accept_bitwise_vs_jax(jx, k):
    rng = _rng("accept", k)
    b = 16
    drafts = rng.integers(0, 3, (b, k - 1)).astype(np.int32)
    greedy = rng.integers(0, 3, (b, k)).astype(np.int32)
    counts = rng.integers(0, k + 1, (b,)).astype(np.int32)
    want = jx.ops.speculative_accept(*(jx.jnp.asarray(a)
                                       for a in (drafts, greedy, counts)))
    got = ops.speculative_accept(_t(drafts), _t(greedy), _t(counts))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("drafts,greedy,counts,want", [
    ([[5, 9, 7]], [[5, 1, 7, 3]], [4], [2]),    # stops at the first mismatch
    ([[5, 9, 7]], [[5, 9, 7, 3]], [4], [4]),    # all match: plus the bonus
    ([[5, 9, 7]], [[5, 9, 7, 3]], [2], [2]),    # the capacity clamp caps it
    (np.zeros((3, 0)), [[4], [2], [9]], [1, 1, 0], [1, 1, 0]),  # K = 1
])
def test_speculative_accept_cases(drafts, greedy, counts, want):
    got = ops.speculative_accept(
        *(torch.as_tensor(np.asarray(a), dtype=torch.int32)
          for a in (drafts, greedy, counts)))
    assert got.tolist() == want


def test_ngram_drafter_state_bitwise_vs_jax(jx):
    """The same verify outcomes folded into both tables, rejected positions
    included, give the same tables and drafts."""
    from repro.serve.drafter import NGramDrafter as JaxNGram

    vocab, b, k = 11, 3, 4
    mine, theirs = NGramDrafter(vocab), JaxNGram(vocab)
    st, jst = mine.init_state(b, torch.device(CPU)), theirs.init_state(b)
    rng = _rng("ngram")
    for _ in range(6):
        feed = rng.integers(0, vocab, (b,)).astype(np.int32)
        d = mine.draft(st, _t(feed), k - 1)
        jd = theirs.draft(jst, jx.jnp.asarray(feed), k - 1)
        np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
        q = rng.integers(0, vocab, (b, k)).astype(np.int32)
        g = rng.integers(0, vocab, (b, k)).astype(np.int32)
        n = rng.integers(0, k + 1, (b,)).astype(np.int32)
        st = mine.update(st, _t(q), _t(g), _t(n))
        jst = theirs.update(jst, jx.jnp.asarray(q), jx.jnp.asarray(g),
                            jx.jnp.asarray(n))
        np.testing.assert_array_equal(st.numpy(), np.asarray(jst))
    assert st.any()


def test_tiny_lm_drafter_bitwise_vs_jax(jx):
    from repro.serve.drafter import TinyLMDrafter as JaxTiny

    jm = jx.serve.PagedLM(jx.cfg, jx.jax.random.PRNGKey(7), impl="ref")
    embed = params_from_numpy({"embed": np.asarray(jm.params["embed"])},
                              device=CPU, names=("embed",))["embed"]
    mine = TinyLMDrafter(embed, vocab=CFG.vocab)
    theirs = JaxTiny(jm.params["embed"], vocab=CFG.vocab)
    feed = np.arange(0, CFG.vocab, 17, dtype=np.int32)
    np.testing.assert_array_equal(
        mine.draft(mine.init_state(len(feed), torch.device(CPU)), _t(feed),
                   3).numpy(),
        np.asarray(theirs.draft(theirs.init_state(len(feed)),
                                jx.jnp.asarray(feed), 3)))


# ---------------------------------------------------------------------------
# Engine: verify_upto emits decode_upto's tokens, bit for bit
# ---------------------------------------------------------------------------


def _sharpen(model):
    """Random smoke models collapse to a one-token greedy fixed point;
    amplified weights give varied sequences (the reference's helper)."""
    model.params = {k: v * (3.0 if k == "embed" else 8.0)
                    for k, v in model.params.items()}
    return model


def _model(spec_k, kv_dtype=None, drafter=None, seed=4):
    return _sharpen(PagedLM(
        CFG, generator=torch.Generator().manual_seed(seed), device=CPU,
        spec_k=spec_k, kv_dtype=kv_dtype, drafter=drafter))


def _engine(spec_k, kv_dtype=None, drafter=None):
    model = _model(spec_k, kv_dtype, drafter)
    cache = PagedKVCache.create(CFG, batch=2, max_len=64, page=8,
                                kv_dtype=kv_dtype, device=CPU)
    prompts = [np.arange(1, 6, dtype=np.int32) % CFG.vocab,
               (np.arange(11, 23, dtype=np.int32) * 7) % CFG.vocab]
    feed = np.zeros((2,), np.int32)
    for s, p in enumerate(prompts):
        cache = cache.allocate(s, cache.pages_for(64))
        for start in range(0, len(p), 8):
            cnt = min(8, len(p) - start)
            buf = np.zeros((8,), np.int32)
            buf[:cnt] = p[start:start + cnt]
            logits, cache = model.prefill_chunk(buf, cnt, s, start, cache)
        feed[s] = int(logits.argmax())
    return model, cache, feed


def _spec_tokens(model, cache, feed, n_steps, total):
    dstate = model.drafter.init_state(2, model.device)
    toks, counts, cache, _ = model.verify_upto(
        feed, cache, np.ones((2,), bool), n_steps, dstate)
    assert toks.shape == (n_steps, 2, model.spec_k)
    assert counts.shape == (n_steps, 2)
    assert (cache.lengths.numpy() == cache.lengths_host).all()
    return [[int(t) for s in range(n_steps)
             for t in toks[s, b, :counts[s, b]]][:total] for b in range(2)]


@pytest.mark.parametrize("spec_k", [1, 2, 4])
@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_engine_emits_plain_greedy_sequence(spec_k, kv_dtype):
    total = 16
    model, cache, feed = _engine(1, kv_dtype)
    plain, _ = model.decode_upto(feed, cache, np.ones((2,), bool), total)
    want = [[int(t) for t in plain[:, s]] for s in range(2)]
    model, cache, feed = _engine(spec_k, kv_dtype)
    assert _spec_tokens(model, cache, feed, total, total) == want
    assert all(len(set(w)) > 1 for w in want)  # varied, not a fixed point


def test_engine_equivalence_is_drafter_independent():
    embed = _model(1, seed=7).params["embed"]
    outs = []
    for drafter in (None, TinyLMDrafter(embed, vocab=CFG.vocab)):
        model, cache, feed = _engine(4, drafter=drafter)
        outs.append(_spec_tokens(model, cache, feed, 12, 12))
    assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# Scheduler: spec_k > 1 equals the static batch, through evictions
# ---------------------------------------------------------------------------


def _prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(0, CFG.vocab, n).astype(np.int32)
            for n in (5, 12, 9)]


def _run_sched(spec_k, max_new, pool_pages=None, kv_dtype=None):
    kw = {} if pool_pages is None else dict(pool_pages=pool_pages)
    cache = PagedKVCache.create(CFG, batch=4, max_len=64, page=8,
                                kv_dtype=kv_dtype, device=CPU, **kw)
    sched = Scheduler(_model(spec_k, kv_dtype), cache, chunk=8)
    for i, p in enumerate(_prompts()):
        sched.submit(Request(rid=i, prompt=p, max_new=max_new))
    return sched.run(), sched


def test_speculative_family_builds_and_verifies():
    """What ``test_unported_modes_raise`` pinned before this slice: spec_k
    2 builds, the family reports its spec_k, ``verify_steps`` returns."""
    model = _model(4)
    assert PagedLM(CFG, device=CPU, spec_k=2, params=model.params).spec_k == 2
    with pytest.raises(ValueError, match="spec_k"):
        PagedLM(CFG, device=CPU, spec_k=0, params=model.params)
    fam = model.bind(PagedKVCache.create(CFG, 2, 16, page=4, device=CPU))
    assert fam.spec_k == 4
    fam.alloc_state(0, fam.units_for(8))
    toks, counts = fam.verify_steps(np.zeros(2, np.int32),
                                    np.array([True, False]), 2)
    assert toks.shape == (2, 2, 4) and counts.shape == (2, 2)
    assert counts[:, 1].tolist() == [0, 0] and (counts[:, 0] >= 1).all()


@pytest.mark.parametrize("spec_k", [2, 4])
def test_scheduler_matches_static_batch(spec_k):
    max_new = 12
    want = static_batch_generate(
        _model(1), PagedKVCache.create(CFG, batch=4, max_len=64, page=8,
                                       device=CPU),
        _prompts(), max_new, chunk=8)
    out, sched = _run_sched(spec_k, max_new)
    assert out == want
    st = sched.stats
    assert st.spec_steps > 0 and st.n_drafted > 0 and st.n_accepted > 0
    assert st.n_emitted == sum(len(v) for v in out.values()) - len(out)
    assert 0.0 < st.acceptance_rate <= 1.0
    assert st.pack_bytes > 0 and st.base_bytes > 0 and st.useful_bytes > 0


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_eviction_mid_speculation_replays_bit_for_bit(kv_dtype):
    max_new = 14
    roomy, _ = _run_sched(4, max_new, kv_dtype=kv_dtype)
    tight, sched = _run_sched(4, max_new, pool_pages=6, kv_dtype=kv_dtype)
    assert tight == roomy
    assert sched.stats.n_evictions > 0
    for r in sched.finished.values():
        assert r.replay_spent <= r.n_evictions * (r.prompt_len + max_new)


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
def test_scheduler_streams_and_accounting_equal_jax(jx, kv_dtype):
    """On the same weights, the port's speculative scheduler emits the JAX
    scheduler's tokens, and its verify accounting is the reference's."""
    jm = jx.serve.PagedLM(jx.cfg, jx.jax.random.PRNGKey(3), impl="ref",
                          spec_k=4, kv_dtype=kv_dtype)
    jm.params = {k: v * (3.0 if k == "embed" else 8.0)
                 for k, v in jm.params.items()}
    params = params_from_numpy({k: np.asarray(v)
                                for k, v in jm.params.items()}, device=CPU)
    port = PagedLM(CFG, params=params, device=CPU, spec_k=4,
                   kv_dtype=kv_dtype)
    runs = []
    for serve_mod, model, kw in ((jx.serve, jm, {}),
                                 (None, port, dict(device=CPU))):
        cache_cls = PagedKVCache if serve_mod is None else \
            serve_mod.PagedKVCache
        sched_cls = Scheduler if serve_mod is None else serve_mod.Scheduler
        req_cls = Request if serve_mod is None else serve_mod.Request
        cache = cache_cls.create(CFG if serve_mod is None else jx.cfg,
                                 batch=4, max_len=64, page=8, pool_pages=10,
                                 kv_dtype=kv_dtype, **kw)
        sched = sched_cls(model, cache, chunk=8)
        for i, p in enumerate(_prompts()):
            sched.submit(req_cls(rid=i, prompt=p, max_new=12))
        runs.append((sched.run(), sched.stats))
    (jout, jst), (out, st) = runs
    assert out == jout
    assert st.spec_steps == jst.spec_steps and st.n_evictions == jst.n_evictions
    assert (st.n_drafted, st.n_accepted) == (jst.n_drafted, jst.n_accepted)
    assert (st.useful_bytes, st.base_bytes, st.pack_bytes) == (
        jst.useful_bytes, jst.base_bytes, jst.pack_bytes)


def test_verify_accounting_functions_equal_jax(jx):
    from repro.core.packing import spec_verify_traffic as jtraffic
    from repro.core.streams import verify_table_streams as jstreams

    rng = _rng("acct")
    table = rng.permutation(64)[:32].reshape(4, 8)
    lens = np.array([0, 5, 17, 27])
    scored = np.array([4, 2, 0, 3])
    for kw in ({}, dict(elem_bits=8, scale_bytes_per_token=16)):
        assert dataclasses.astuple(
            spec_verify_traffic(lens, scored, 4, 8, 256, **kw)) == \
            dataclasses.astuple(jtraffic(lens, scored, 4, 8, 256, **kw))
    mine = verify_table_streams(table, lens, scored, 4, 256)
    theirs = jstreams(table, lens, scored, 4, 256)
    assert len(mine) == len(theirs) > 0
    for a, b in zip(mine, theirs):
        assert (a.base, a.elem_bits, a.count, a.index_bits) == (
            b.base, b.elem_bits, b.count, b.index_bits)
        np.testing.assert_array_equal(a.indices, b.indices)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the kernels are CUDA-only")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("gqa", [1, 2, 4, 8])
@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("d", [16, 128])
def test_paged_verify_kernel_on_card(cuda, k, gqa, int8, d):
    """Small K in the prefill kernel's 64-row tile, chunks that straddle a
    page, a padding row; launches counted under paged_verify only."""
    h = 8
    q, kp, vp, rows, lens, cnts, sc = _verify_case(
        _rng("card-verify", k, gqa, int8, d), b=4, k=k, h=h, kvh=h // gqa,
        d=d, pool=32, page=4, ctx=6, lengths=[0, 3, 8, 13],
        counts=[k, k, max(k - 1, 1), 0], int8=int8)
    args = [_t(a, cuda) for a in (q, kp, vp, rows, lens, cnts)]
    scales = {n: _t(a, cuda) for n, a in sc.items()}
    ops.reset_launch_counts()
    got = ops.paged_verify(*args, **scales)
    want = ops.paged_verify(*args, **scales, impl="ref")
    torch.testing.assert_close(got, want, **TOL)
    assert not got[3].any()
    assert ops.paged_verify.launches == 1
    assert ops.paged_prefill_attention.launches == 0


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
def test_paged_verify_never_reads_unmapped_pages(cuda, int8):
    q, kp, vp, rows, lens, cnts, sc = _verify_case(
        _rng("poison", int8), b=3, k=4, h=4, kvh=2, d=16, pool=24, page=4,
        ctx=6, lengths=[0, 5, 13], counts=[4, 2, 3], int8=int8)
    live = set()
    for row, n, c in zip(rows, lens, cnts):
        live.update(int(p) for p in row[: -(-int(n + c) // 4)])
    dead = [p for p in range(24) if p not in live]
    if int8:
        sc["k_scale"][dead], sc["v_scale"][dead] = np.nan, np.nan
    else:
        kp[dead], vp[dead] = np.nan, np.nan
    out = ops.paged_verify(*[_t(a, cuda) for a in (q, kp, vp, rows, lens,
                                                    cnts)],
                           **{n: _t(a, cuda) for n, a in sc.items()})
    assert torch.isfinite(out).all()


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
def test_speculative_scheduler_on_card(cuda, kv_dtype):
    """The scheduler on the kernels: spec_k=4 emits plain greedy."""
    model = PagedLM(CFG, generator=torch.Generator(cuda).manual_seed(3),
                    device=cuda, kv_dtype=kv_dtype)
    params = {k: v * (3.0 if k == "embed" else 8.0)
              for k, v in model.params.items()}
    want = static_batch_generate(
        PagedLM(CFG, device=cuda, kv_dtype=kv_dtype, params=params,
                impl="ref"),
        PagedKVCache.create(CFG, batch=4, max_len=64, page=8,
                            kv_dtype=kv_dtype, device=cuda),
        _prompts(), 12, chunk=8)
    ops.reset_launch_counts()
    sched = Scheduler(
        PagedLM(CFG, device=cuda, kv_dtype=kv_dtype, params=params,
                spec_k=4),
        PagedKVCache.create(CFG, batch=4, max_len=64, page=8, pool_pages=6,
                            kv_dtype=kv_dtype, device=cuda), chunk=8)
    for i, p in enumerate(_prompts()):
        sched.submit(Request(rid=i, prompt=p, max_new=12))
    assert sched.run() == want
    assert ops.paged_verify.launches > 0

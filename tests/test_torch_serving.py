"""The port's serving slice as a whole against the JAX reference.

The JAX ``PagedLM(impl='ref')`` on ``smoke_config('yi-6b')`` draws the
weights; ``params_from_numpy`` carries them into the port, so both
packages serve the same model.  The JAX ``Scheduler`` and the port's
``Scheduler`` must then emit equal greedy token streams: fp32 pools, int8
pools, prefix sharing, and a pool tight enough to force evictions.

Logits are compared with tolerances, never bitwise: the two frameworks
sum in different orders, and on the reference's own ``impl='ref'`` path
batched prefill is not bitwise equal to sequential chunks either.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    FaultPlan,
    PagedKVCache,
    PagedLM,
    Request,
    Scheduler,
    check_scheduler_invariants,
    params_from_numpy,
    static_batch_generate,
)

CFG = smoke_config("yi-6b")
CPU = "cpu"

#: fp32 logits: float32 sums in another order, through two layers.
FP32_TOL = dict(rtol=1e-5, atol=1e-5)
#: int8 pools: a one-ulp difference in a K/V projection can move a code by
#: one step (scale = amax / 127) before the attention reads it, which
#: shifts a logit by up to ~1e-3 at these widths.
INT8_TOL = dict(rtol=0.0, atol=2e-3)


@pytest.fixture(scope="module")
def jax_serve():
    jax = pytest.importorskip("jax")
    from repro.configs import smoke_config as jax_smoke
    from repro import serve

    return jax, serve, jax_smoke("yi-6b")


@pytest.fixture(scope="module")
def weights(jax_serve):
    jax, serve, jcfg = jax_serve
    jm = serve.PagedLM(jcfg, jax.random.PRNGKey(0), impl="ref")
    return {k: np.asarray(v) for k, v in jm.params.items()}


@pytest.fixture(scope="module")
def jax_models(jax_serve):
    """One JAX model per pool dtype, shared so its jitted programs are
    compiled once for the whole module."""
    jax, serve, jcfg = jax_serve
    return {kv: serve.PagedLM(jcfg, jax.random.PRNGKey(0), impl="ref",
                              kv_dtype=kv)
            for kv in ("fp32", "int8")}


def _port_model(weights, kv_dtype, impl="cuda"):
    return PagedLM(CFG, params=params_from_numpy(weights, device=CPU),
                   device=CPU, kv_dtype=kv_dtype, impl=impl)


def _prompts(seed, lens, prefix=0):
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, CFG.vocab, prefix).astype(np.int32)
    return [np.concatenate([shared, rng.integers(0, CFG.vocab, n)]).astype(
        np.int32) for n in lens]


def _run(sched_cls, req_cls, model, cache, prompts, max_new, chunk=4,
         **kw):
    sched = sched_cls(model, cache, chunk=chunk, **kw)
    for i, p in enumerate(prompts):
        sched.submit(req_cls(rid=i, prompt=p, max_new=max_new))
    return sched.run(), sched


CASES = {
    # name: (kv_dtype, seed, prompt lengths, shared prefix, pool pages,
    #        prefix sharing)
    "fp32": ("fp32", 1, (5, 9, 13, 3, 11), 0, None, False),
    "int8": ("int8", 1, (5, 9, 13, 3, 11), 0, None, False),
    "prefix_sharing": ("fp32", 2, (3, 6, 1, 5), 9, None, True),
    "int8_tight_pool_eviction": ("int8", 7, (9, 10, 11, 7), 0, 7, False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_scheduler_streams_equal_jax(jax_serve, jax_models, weights, case):
    kv_dtype, seed, lens, prefix, pool, sharing = CASES[case]
    _, serve, jcfg = jax_serve
    prompts = _prompts(seed, lens, prefix)
    geometry = dict(batch=4, max_len=32, page=4, pool_pages=pool,
                    kv_dtype=kv_dtype)
    want, jsched = _run(
        serve.Scheduler, serve.Request, jax_models[kv_dtype],
        serve.PagedKVCache.create(jcfg, **geometry), prompts, 6,
        prefix_sharing=sharing)
    got, sched = _run(
        Scheduler, Request, _port_model(weights, kv_dtype),
        PagedKVCache.create(CFG, device=CPU, **geometry), prompts, 6,
        prefix_sharing=sharing)
    assert got == want
    assert sched.stats.n_evictions == jsched.stats.n_evictions
    assert sched.stats.prefill_tokens_saved == \
        jsched.stats.prefill_tokens_saved
    if pool is not None:
        assert sched.stats.n_evictions >= 1
    if sharing:
        assert sched.stats.prefill_tokens_saved > 0
    # The host-side accounting is a numpy copy: same traffic records.
    assert [dataclasses.astuple(r.traffic) for r in sched.stats.records] == \
        [dataclasses.astuple(r.traffic) for r in jsched.stats.records]


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
@pytest.mark.parametrize("impl", ["cuda", "ref"])
def test_port_scheduler_equals_its_static_batch(weights, kv_dtype, impl):
    """Row-wise model: batch composition never changes a sequence's tokens,
    with evictions and replay in the run."""
    prompts = _prompts(7, (9, 10, 11, 7))
    model = _port_model(weights, kv_dtype, impl)
    got, sched = _run(
        Scheduler, Request, model,
        PagedKVCache.create(CFG, 4, 32, page=4, pool_pages=7,
                            kv_dtype=kv_dtype, device=CPU),
        prompts, 6)
    assert sched.stats.n_evictions >= 1
    static = static_batch_generate(
        model, PagedKVCache.create(CFG, 4, 32, page=4, kv_dtype=kv_dtype,
                                   device=CPU), prompts, 6, chunk=4)
    assert got == static


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chaos_plans_keep_outputs_and_invariants(weights, seed):
    prompts = _prompts(seed, (9, 10, 11, 7, 4))
    model = _port_model(weights, "int8")

    def make():
        return PagedKVCache.create(CFG, 4, 32, page=4, pool_pages=10,
                                   kv_dtype="int8", device=CPU)

    clean, _ = _run(Scheduler, Request, model, make(), prompts, 5,
                    prefix_sharing=True)
    sched = Scheduler(model, make(), chunk=4, prefix_sharing=True,
                      faults=FaultPlan.random(seed, n_steps=20))
    reqs = [Request(rid=i, prompt=p, max_new=5) for i, p in enumerate(prompts)]
    for r in reqs:
        sched.submit(r)
    while sched.queue or sched.resident:
        sched.step()
        check_scheduler_invariants(sched, reqs)
    for rid, r in sched.finished.items():
        assert r.generated == clean[rid]


def _host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _prefill_then_decode(model, cache, prompts, chunk=4):
    """Prefill equal-length prompts in batched chunks, then one greedy
    decode step; returns (last prefill logits, decode logits) as numpy."""
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
    return pre, _host(logits)


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
def test_prefill_and_decode_logits_close_to_jax(jax_serve, jax_models,
                                                weights, kv_dtype):
    _, serve, jcfg = jax_serve
    prompts = _prompts(3, (8, 8, 8, 8))
    geometry = dict(batch=4, max_len=32, page=4, kv_dtype=kv_dtype)
    jpre, jdec = _prefill_then_decode(
        jax_models[kv_dtype],
        serve.PagedKVCache.create(jcfg, **geometry), prompts)
    pre, dec = _prefill_then_decode(
        _port_model(weights, kv_dtype),
        PagedKVCache.create(CFG, device=CPU, **geometry), prompts)
    tol = FP32_TOL if kv_dtype == "fp32" else INT8_TOL
    np.testing.assert_allclose(pre, jpre, **tol)
    np.testing.assert_allclose(dec, jdec, **tol)


def test_unported_modes_raise():
    """Pool dtypes the reference has no name for raise; every bf16
    spelling, and ``None`` on a bf16 config, builds bf16 pools and serves.
    A plain model serves with ``spec_k == 1``."""
    params = PagedLM(CFG, device=CPU).params
    for name in ("fp16", "float16", torch.float16):
        with pytest.raises(ValueError, match="kv_dtype|KV pool dtype"):
            PagedLM(CFG, device=CPU, kv_dtype=name, params=params)
        with pytest.raises(ValueError, match="kv_dtype|KV pool dtype"):
            PagedKVCache.create(CFG, 2, 16, page=4, kv_dtype=name, device=CPU)
    bf16_cfg = dataclasses.replace(CFG, dtype="bfloat16")
    for cfg, name in ((CFG, "bf16"), (CFG, "bfloat16"),
                      (CFG, torch.bfloat16), (bf16_cfg, None)):
        model = PagedLM(cfg, device=CPU, kv_dtype=name, params=params)
        cache = PagedKVCache.create(cfg, 2, 16, page=4, kv_dtype=name,
                                    device=CPU)
        assert model.kv_dtype == cache.k_pages.dtype == torch.bfloat16
        assert model.kv_elem_bits == 16 and cache.k_scale is None
        out, _ = _run(Scheduler, Request, model, cache, _prompts(0, (5, 3)),
                      3)
        assert sorted(out) == [0, 1] and all(len(t) == 3
                                             for t in out.values())
    fam = PagedLM(CFG, device=CPU, params=params).bind(
        PagedKVCache.create(CFG, 2, 16, page=4, device=CPU))
    assert fam.spec_k == 1


def test_generator_init_is_seeded_and_scaled():
    a = PagedLM(CFG, generator=torch.Generator().manual_seed(3), device=CPU)
    b = PagedLM(CFG, generator=torch.Generator().manual_seed(3), device=CPU)
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k])
    assert abs(a.params["embed"].std().item() - 0.02) < 0.002
    fan_in = CFG.d_model
    assert abs(a.params["wq"].std().item() - fan_in ** -0.5) < 0.01


def test_model_and_cache_must_agree(weights):
    with pytest.raises(ValueError, match="kv_dtype"):
        Scheduler(_port_model(weights, "fp32"),
                  PagedKVCache.create(CFG, 2, 16, page=4, kv_dtype="int8",
                                      device=CPU))


def test_serving_on_cpu_launches_no_kernel(weights):
    ops.reset_launch_counts()
    _run(Scheduler, Request, _port_model(weights, "int8"),
         PagedKVCache.create(CFG, 2, 16, page=4, kv_dtype="int8",
                             device=CPU), _prompts(0, (5, 3)), 3)
    assert set(ops.launch_counts().values()) == {0}

"""The port's dense inference path against JAX: contiguous KV cache,
prefill, decode, extend, chunked prefill and ``dense_generate``.

This is how the reference serves a Mixture-of-Experts model (olmoe-1b-7b:
``repro.launch.serve.dense_generate`` over ``lm.prefill`` /
``lm.decode_step``); yi-6b's smoke config covers the dense MLP and GQA.
The reference's weights are carried over leaf for leaf, and prompts come
from fixed numpy seeds.  On this CPU host the MoE dispatch and combine run
the plain converters inside the same autograd Functions as the kernels on
the card.

Tolerances: logits within rtol = atol = 1e-5 (float32 sums in another
order: the reference's prefill attention is an online softmax over KV
chunks, the port's one softmax a chunk of queries); the cache's K and V
within 1e-5 (int8 codes equal, scales within 1e-6 relative); greedy token
streams equal.  The JAX functions run under ``jax.jit``, as the
reference's ``dense_generate`` runs them (its int8 scale is then
``amax * (1 / 127)``, the port's formula).
"""
import dataclasses
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import attention, lm  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"
TOL = dict(rtol=1e-5, atol=1e-5)
B, S0, MAX_LEN = 3, 16, 64

#: name → (arch, config replacements)
MODELS = {
    "olmoe": ("olmoe-1b-7b", {}),
    "yi": ("yi-6b", {}),
    "yi-int8-cache": ("yi-6b", dict(cache_dtype="int8")),
    "olmoe-window": ("olmoe-1b-7b", dict(window=6, global_interval=2)),
    "yi-non-causal-prefill": ("yi-6b", dict(causal=False)),
}


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import smoke_config as jax_smoke
    from repro.launch import serve as jserve
    from repro.models import lm as jlm
    from repro.parallel.sharding import make_rules

    return types.SimpleNamespace(
        jax=jax, jnp=jnp, smoke=jax_smoke, lm=jlm, serve=jserve,
        rules=make_rules(with_pod=False, batch_axes=("data",)))


def _model(jx, name):
    arch, repl = MODELS[name]
    jcfg = dataclasses.replace(jx.smoke(arch), **repl)
    cfg = dataclasses.replace(smoke_config(arch), **repl)
    jp = jx.lm.init_model(jcfg, jx.jax.random.PRNGKey(0))
    tp = lm.lm_params_from_numpy(jx.jax.tree.map(np.asarray, jp), cfg,
                                 device=CPU)
    return jcfg, jp, cfg, tp


def _prompts(vocab, seed=1, b=B, s=S0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def _close_cache(cache, jcache):
    for name, t in cache.items():
        want = np.asarray(jcache[name], np.float32)
        if t.dtype == torch.int8:
            np.testing.assert_array_equal(t.numpy(), want, err_msg=name)
        elif name.endswith("scale"):
            np.testing.assert_allclose(t.numpy(), want, rtol=1e-6,
                                       err_msg=name)
        else:
            np.testing.assert_allclose(t.float().numpy(), want, **TOL,
                                       err_msg=name)


@pytest.mark.parametrize("name", list(MODELS))
def test_prefill_decode_extend_match_jax(jx, name):
    jcfg, jp, cfg, tp = _model(jx, name)
    jl, rules, jnp = jx.lm, jx.rules, jx.jnp
    prompts = _prompts(cfg.vocab)
    rng = np.random.default_rng(2)
    step = rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
    chunk = rng.integers(0, cfg.vocab, (B, 4)).astype(np.int32)

    jprefill = jx.jax.jit(lambda p, t, c: jl.prefill(p, {"tokens": t}, c,
                                                     jcfg, rules))
    jdecode = jx.jax.jit(lambda p, t, c, pos: jl.decode_step(
        p, t, c, pos, jcfg, rules))
    jextend = jx.jax.jit(lambda p, t, c, pos: jl.extend_step(
        p, t, c, pos, jcfg, rules))
    jcache = jl.init_cache(jcfg, B, MAX_LEN)
    want_pre, jcache = jprefill(jp, jnp.asarray(prompts), jcache)
    want_dec, jcache = jdecode(jp, jnp.asarray(step), jcache, S0)
    want_ext, jcache = jextend(jp, jnp.asarray(chunk), jcache, S0 + 1)

    cache = lm.init_cache(cfg, B, MAX_LEN, device=CPU)
    with torch.no_grad():
        pre, cache = lm.prefill(tp, {"tokens": torch.as_tensor(prompts)},
                                cache, cfg)
        dec, cache = lm.decode_step(tp, torch.as_tensor(step), cache, S0, cfg)
        ext, cache = lm.extend_step(tp, torch.as_tensor(chunk), cache, S0 + 1,
                                    cfg)
    assert tuple(pre.shape) == (B, 1, cfg.vocab)
    assert tuple(dec.shape) == (B, cfg.vocab)
    assert tuple(ext.shape) == (B, 1, cfg.vocab)
    for what, got, want in (("prefill", pre, want_pre),
                            ("decode", dec, want_dec),
                            ("extend", ext, want_ext)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                   err_msg=what)
    _close_cache(cache, jcache)


@pytest.mark.parametrize("name", list(MODELS))
def test_prefill_in_query_chunks_matches_jax(jx, name, monkeypatch):
    """The prefill's queries 5 at a time (16 = 5 + 5 + 5 + 1): logits and
    cache as the reference's prefill."""
    monkeypatch.setattr(attention, "PREFILL_CHUNK", 5)
    jcfg, jp, cfg, tp = _model(jx, name)
    prompts = _prompts(cfg.vocab, seed=5)
    run = jx.jax.jit(lambda p, t, c: jx.lm.prefill(p, {"tokens": t}, c,
                                                   jcfg, jx.rules))
    want, jcache = run(jp, jx.jnp.asarray(prompts),
                       jx.lm.init_cache(jcfg, B, MAX_LEN))
    with torch.no_grad():
        got, cache = lm.prefill(tp, {"tokens": torch.as_tensor(prompts)},
                                lm.init_cache(cfg, B, MAX_LEN, device=CPU),
                                cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _close_cache(cache, jcache)


@pytest.mark.parametrize("name", ["olmoe", "yi"])
def test_prefill_chunked_matches_jax(jx, name):
    jcfg, jp, cfg, tp = _model(jx, name)
    prompts = _prompts(cfg.vocab, seed=3)
    run = jx.jax.jit(lambda p, t, c: jx.lm.prefill_chunked(
        p, {"tokens": t}, c, jcfg, jx.rules, 4))
    want, jcache = run(jp, jx.jnp.asarray(prompts),
                       jx.lm.init_cache(jcfg, B, MAX_LEN))
    with torch.no_grad():
        got, cache = lm.prefill_chunked(
            tp, {"tokens": torch.as_tensor(prompts)},
            lm.init_cache(cfg, B, MAX_LEN, device=CPU), cfg, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _close_cache(cache, jcache)
    with pytest.raises(ValueError, match="multiple"):
        lm.prefill_chunked(tp, {"tokens": torch.as_tensor(prompts)},
                           lm.init_cache(cfg, B, MAX_LEN, device=CPU), cfg, 5)


@pytest.mark.parametrize("name", ["olmoe", "yi", "yi-int8-cache"])
def test_dense_generate_tokens_equal_jax(jx, name):
    jcfg, jp, cfg, tp = _model(jx, name)
    prompts = _prompts(cfg.vocab, seed=4)
    want = jx.serve.dense_generate(jcfg, jp, jx.rules,
                                   jx.jnp.asarray(prompts), 12,
                                   max_len=MAX_LEN)
    for impl in ("cuda", "ref"):
        got = serve.dense_generate(cfg, tp, torch.as_tensor(prompts), 12,
                                   max_len=MAX_LEN, impl=impl)
        np.testing.assert_array_equal(got, np.asarray(want), err_msg=impl)


def test_cache_layout_and_dims(jx):
    for name in ("olmoe", "yi-int8-cache"):
        jcfg, _, cfg, _ = _model(jx, name)
        cache = lm.init_cache(cfg, B, MAX_LEN, device=CPU)
        jcache = jx.lm.init_cache(jcfg, B, MAX_LEN)
        assert sorted(cache) == sorted(jcache)
        for key, t in cache.items():
            assert tuple(t.shape) == jcache[key].shape
            assert not t.any()


def test_sampling_is_seeded_and_bounded():
    cfg = smoke_config("olmoe-1b-7b")
    params = lm.init_model(cfg, seed=0, device=CPU)
    prompts = torch.as_tensor(_prompts(cfg.vocab, seed=5))
    runs = [serve.dense_generate(cfg, params, prompts, 6, max_len=32,
                                 greedy=False,
                                 generator=torch.Generator().manual_seed(7))
            for _ in range(2)]
    np.testing.assert_array_equal(runs[0], runs[1])
    assert runs[0].shape == (B, 6) and runs[0].max() < cfg.vocab
    with pytest.raises(ValueError, match="max_len"):
        serve.dense_generate(cfg, params, prompts, 20, max_len=32)


def test_unported_families_raise_for_the_dense_path():
    """Every causal family has a dense cache now (A7c is done); what still
    refuses the dense path is an encoder, which has no decode step."""
    cache = lm.init_cache(smoke_config("rwkv6-3b"), 1, 8, device=CPU)
    assert sorted(cache) == ["s", "x_cm", "x_tm"]
    with pytest.raises(SystemExit, match="encoder-only"):
        serve.main(["--arch", "hubert-xlarge", "--smoke", "--device", CPU])


def test_serve_launcher_runs_olmoe_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "olmoe-1b-7b", "--smoke", "--device", "cpu", "--batch", "2",
         "--prompt-len", "8", "--new-tokens", "4"],
        env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "arch=olmoe-1b-7b on cpu: generated (2, 4)" in res.stdout


def test_serve_launcher_and_cache_raise_without_a_card():
    """``python -m repro_torch.launch.serve`` and ``lm.init_cache`` run on
    the GPU unless asked for the CPU: with no card they fail, naming the
    GPU, before any output."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="GPU"):
        lm.init_cache(smoke_config("olmoe-1b-7b"), 1, 8)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "olmoe-1b-7b", "--smoke"],
        env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert "GPU" in res.stderr and "device='cpu'" in res.stderr
    assert res.stdout == ""

"""The port's ten model families against the JAX reference.

Every registry entry (``repro_torch.configs.ALL_ARCH_NAMES``) is held
against ``repro.configs`` field for field, at full size and at its smoke
size.  At the smoke size the reference's ``lm.init_model`` draws the
weights, ``lm_params_from_numpy`` carries them into the port leaf for
leaf, and both packages get the same numpy batches (those of
``tests/test_arch_smoke.py``: audio frames for hubert-xlarge, a patch
prefix for internvl2-1b), all from fixed seeds.  On the CPU the port's
attention runs the flash kernels' plain versions through the same
autograd Function as on the card, and the recurrent scans run their
chunked forms (``models.mamba.CHUNK``, ``models.rwkv6.CHUNK``).

Tolerances, set from float32 summed in other orders: the loss within
1e-5 relative and each gradient leaf within 1e-4 of its largest entry
(``tests/test_torch_train.py``'s; the reference under ``jax.jit``, as
``tests/test_arch_smoke.py`` runs it); prefill and decode logits within
rtol = atol = 1e-5 of the reference's under ``jax.jit``
(``tests/test_torch_dense_serve.py``'s), and rwkv6-3b's within atol =
3e-5: its group norm magnifies float32 rounding, and the port's stepped
form, which sums in the reference's order token by token, is already
1.5e-5 from the reference's prefill logits; inside the port, prefill plus
decode against one full forward within ``tests/test_arch_smoke.py``'s
2e-4 (0.05 with an int8 KV cache); the chunked scans within 1e-5 of the
reference's (the port's chunks are longer and its log-depth tree is
another, so sums round differently) and bitwise equal to the stepped form
at T = 1, and the Mamba scan's own backward within 1e-12 of autograd
through the stepped form in float64; int8 MLP codes and scales bitwise,
the w8a16 MLP within 1e-6.
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

from repro_torch.configs import (  # noqa: E402
    ALL_ARCH_NAMES, get_config, smoke_config)
from repro_torch.models import lm, mamba, mlp, rwkv6  # noqa: E402
from repro_torch.models.common import rms_norm, tree_paths  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"
B, S = 2, 32
TOL = dict(rtol=1e-5, atol=1e-5)
CAUSAL = [n for n in ALL_ARCH_NAMES if get_config(n).causal]


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro import configs as jconfigs
    from repro.models import common as jcommon
    from repro.models import lm as jlm
    from repro.models import mamba as jmamba
    from repro.models import mlp as jmlp
    from repro.models import rwkv6 as jrwkv
    from repro.parallel.sharding import make_rules

    return types.SimpleNamespace(
        jax=jax, jnp=jnp, configs=jconfigs, common=jcommon, lm=jlm,
        mamba=jmamba, mlp=jmlp, rwkv=jrwkv,
        rules=make_rules(with_pod=False, batch_axes=("data",)))


def _model(jx, name, **repl):
    """(JAX config, JAX params, the port's config, its copy of the
    params) at the smoke size."""
    jcfg = dataclasses.replace(jx.configs.smoke_config(name), **repl)
    cfg = dataclasses.replace(smoke_config(name), **repl)
    jp = jx.lm.init_model(jcfg, jx.jax.random.PRNGKey(0))
    tp = lm.lm_params_from_numpy(jx.jax.tree.map(np.asarray, jp), cfg,
                                 device=CPU)
    return jcfg, jp, cfg, tp


def _batch(cfg, rng, s=S):
    """``tests/test_arch_smoke.py``'s batch as numpy arrays."""
    tokens = rng.integers(0, cfg.vocab, (B, s)).astype(np.int32)
    targets = rng.integers(0, cfg.vocab, (B, s)).astype(np.int32)
    mask = np.ones((B, s), np.float32)
    batch = {"tokens": tokens, "targets": targets, "mask": mask}
    if cfg.modality == "audio":
        batch = {"frontend": rng.normal(size=(B, s, cfg.frontend_dim))
                 .astype(np.float32), "targets": targets, "mask": mask}
    elif cfg.modality == "vlm":
        batch["tokens"] = tokens[:, : s - cfg.frontend_len]
        batch["frontend"] = rng.normal(
            size=(B, cfg.frontend_len, cfg.frontend_dim)).astype(np.float32)
    return batch


def _t(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _j(jx, batch):
    return {k: jx.jnp.asarray(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# Configurations
# ---------------------------------------------------------------------------


def test_registry_is_the_references(jx):
    assert ALL_ARCH_NAMES == jx.configs.ALL_ARCH_NAMES


@pytest.mark.parametrize("name", ALL_ARCH_NAMES)
def test_configs_equal_the_references_field_for_field(jx, name):
    for ours, theirs in ((get_config(name), jx.configs.get_config(name)),
                         (smoke_config(name), jx.configs.smoke_config(name))):
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert get_config(name).param_count() == \
        jx.configs.get_config(name).param_count()


@pytest.mark.parametrize("name", ALL_ARCH_NAMES)
def test_global_flags_and_cache_dims_equal_the_references(jx, name):
    for cfg, jcfg in ((get_config(name), jx.configs.get_config(name)),
                      (smoke_config(name), jx.configs.smoke_config(name))):
        np.testing.assert_array_equal(lm.global_flags(cfg),
                                      jx.lm.global_flags(jcfg))
        assert lm.cache_dims_tree(cfg) == jx.lm.cache_dims_tree(jcfg)
    want = jx.jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                           jx.lm.init_cache(jcfg, B, 16))
    got = lm.init_cache(cfg, B, 16, device=CPU)
    want = dict(_paths(want))
    assert sorted(p for p, _ in tree_paths(got)) == sorted(want)
    for path, t in tree_paths(got):
        shape, dtype = want[path]
        assert tuple(t.shape) == tuple(shape), path
        assert str(t.dtype).replace("torch.", "") == dtype, path
        assert not t.any(), path


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in _paths(tree[k], f"{prefix}['{k}']")]
    return [(prefix, tree)]


# ---------------------------------------------------------------------------
# Training: loss and gradients
# ---------------------------------------------------------------------------


def _loss_and_grads(cfg, tp, batch):
    for leaf in [t for _, t in tree_paths(tp)]:
        leaf.requires_grad_(True)
    loss, aux = lm.train_loss(tp, _t(batch), cfg)
    grads = torch.autograd.grad(loss, [t for _, t in tree_paths(tp)])
    return loss.detach(), aux, grads


@pytest.mark.parametrize("name", ALL_ARCH_NAMES)
def test_train_loss_and_grads_match_jax(jx, name):
    jcfg, jp, cfg, tp = _model(jx, name)
    batch = _batch(cfg, np.random.default_rng(0))
    (jloss, jaux), jg = jx.jax.jit(jx.jax.value_and_grad(
        lambda p, b: jx.lm.train_loss(p, b, jcfg, jx.rules),
        has_aux=True))(jp, _j(jx, batch))
    loss, aux, grads = _loss_and_grads(cfg, tp, batch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(aux["ce_loss"]), float(jaux["ce_loss"]),
                               rtol=1e-5)
    assert float(aux["tokens"]) == float(jaux["tokens"]) == B * S
    want = dict(_paths(jx.jax.tree.map(np.asarray, jg)))
    paths = [p for p, _ in tree_paths(tp)]
    assert sorted(paths) == sorted(want)
    for path, g in zip(paths, grads):
        w = want[path]
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4 * scale,
                                   err_msg=path)


@pytest.mark.parametrize("name", ["hymba-1.5b", "rwkv6-3b"])
def test_remat_grads_equal_plain_grads(jx, name):
    """Layer remat around the chunked scans' own checkpoints (nested
    non-reentrant checkpoints) recomputes the same values."""
    _, _, cfg, tp = _model(jx, name)
    batch = _batch(cfg, np.random.default_rng(3))
    loss, _, grads = _loss_and_grads(cfg, tp, batch)
    rloss, _, rgrads = _loss_and_grads(
        dataclasses.replace(cfg, remat=True), tp, batch)
    assert float(rloss) == float(loss)
    for (path, _), g, rg in zip(tree_paths(tp), grads, rgrads):
        np.testing.assert_allclose(rg.numpy(), g.numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=path)


# ---------------------------------------------------------------------------
# Dense inference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", CAUSAL)
def test_prefill_and_decode_match_jax(jx, name):
    jcfg, jp, cfg, tp = _model(jx, name)
    rng = np.random.default_rng(1)
    p_len, n_dec, max_len = 8, 4, 24
    prompt = {"tokens": rng.integers(0, cfg.vocab, (B, p_len)).astype(
        np.int32)}
    if cfg.modality == "vlm":  # patches before the prompt's tokens
        prompt["frontend"] = rng.normal(
            size=(B, cfg.frontend_len, cfg.frontend_dim)).astype(np.float32)
    pos0 = p_len + (cfg.frontend_len if cfg.modality == "vlm" else 0)
    steps = rng.integers(0, cfg.vocab, (n_dec, B, 1)).astype(np.int32)

    jl, rules = jx.lm, jx.rules
    jprefill = jx.jax.jit(lambda p, b, c: jl.prefill(p, b, c, jcfg, rules))
    jdecode = jx.jax.jit(lambda p, t, c, pos: jl.decode_step(
        p, t, c, pos, jcfg, rules))
    jcache = jl.init_cache(jcfg, B, max_len)
    want, jcache = jprefill(jp, _j(jx, prompt), jcache)
    wants = [np.asarray(want)]
    for i in range(n_dec):
        w, jcache = jdecode(jp, jx.jnp.asarray(steps[i]), jcache, pos0 + i)
        wants.append(np.asarray(w))

    cache = lm.init_cache(cfg, B, max_len, device=CPU)
    with torch.no_grad():
        got, cache = lm.prefill(tp, _t(prompt), cache, cfg)
        gots = [got.numpy()]
        for i in range(n_dec):
            g, cache = lm.decode_step(tp, torch.as_tensor(steps[i]), cache,
                                      pos0 + i, cfg)
            gots.append(g.numpy())
    tol = dict(TOL, atol=3e-5) if cfg.ssm == "rwkv6" else TOL
    for i, (g, w) in enumerate(zip(gots, wants)):
        np.testing.assert_allclose(g, w, **tol, err_msg=f"step {i}")
    jleaves = dict(_paths(jx.jax.tree.map(np.asarray, jcache)))
    for path, t in tree_paths(cache):
        w = jleaves[path]
        if t.dtype == torch.int8:
            continue  # int8 codes may flip at a rounding tie; logits agree
        np.testing.assert_allclose(t.float().numpy(), w.astype(np.float32),
                                   **tol, err_msg=path)


@pytest.mark.parametrize("name", CAUSAL)
def test_decode_matches_full_forward(name):
    """``tests/test_arch_smoke.py``'s contract on the port: prefill plus
    one decode step a token equals one full forward (windows in the cache,
    recurrent states carried, hymba's global layers)."""
    cfg = smoke_config(name)
    if cfg.n_experts:  # no capacity drops: exactness holds without them
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    tol = 0.05 if cfg.cache_dtype == "int8" else 2e-4
    tp = lm.init_model(cfg, seed=1, device=CPU)
    s = 16
    tokens = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, (B, s)))
    flags = lm.global_flags(cfg)
    with torch.no_grad():
        x = lm.embed_tokens(tp, {"tokens": tokens}, cfg)
        positions = torch.arange(s)
        for i in range(cfg.n_layers):
            lp = {k: v for k, v in _layer(tp, i).items()}
            x, _ = lm._block_train(x, lp, cfg, bool(flags[i]), positions,
                                   "cuda")
        full = rms_norm(x, tp["final_norm"]) @ lm.output_weight(tp, cfg)
        p_len = s // 2
        cache = lm.init_cache(cfg, B, s, device=CPU)
        lg, cache = lm.prefill(tp, {"tokens": tokens[:, :p_len]}, cache, cfg)
        errs = [float((lg[:, 0] - full[:, p_len - 1]).abs().max())]
        for t in range(p_len, s):
            lg, cache = lm.decode_step(tp, tokens[:, t:t + 1], cache, t, cfg)
            errs.append(float((lg - full[:, t]).abs().max()))
    assert max(errs) < tol, f"{name}: decode divergence {max(errs)}"


def _layer(tp, i):
    from repro_torch.models.common import map_tree
    return map_tree(lambda t: t[i], tp["layers"])


# ---------------------------------------------------------------------------
# w8a16 MLP weights (qwen1.5-32b's serve_mlp_int8)
# ---------------------------------------------------------------------------


def test_quantize_mlp_weights_is_bitwise_the_references(jx):
    jcfg, jp, cfg, tp = _model(jx, "qwen1.5-32b")
    assert cfg.serve_mlp_int8
    want = dict(_paths(jx.jax.tree.map(
        np.asarray, jx.lm.quantize_mlp_weights(jp, jcfg))))
    got = tree_paths(lm.quantize_mlp_weights(tp, cfg))
    assert sorted(p for p, _ in got) == sorted(want)
    n_int8 = 0
    for path, t in got:
        assert str(t.dtype).replace("torch.", "") == str(want[path].dtype)
        np.testing.assert_array_equal(t.numpy(), want[path], err_msg=path)
        n_int8 += t.dtype == torch.int8
    assert n_int8 == 3  # w_up, w_gate, w_down of the stacked layers


def test_w8a16_mlp_fwd_matches_jax(jx):
    jcfg, jp, cfg, tp = _model(jx, "qwen1.5-32b")
    jq = jx.jax.tree.map(lambda a: a[0], jx.lm.quantize_mlp_weights(
        jp, jcfg)["layers"]["mlp"])
    tq = {k: {n: torch.as_tensor(np.asarray(a)) for n, a in v.items()}
          for k, v in jq.items()}
    x = np.random.default_rng(4).normal(size=(B, 8, cfg.d_model)).astype(
        np.float32)
    want = jx.mlp.mlp_fwd(jq, jx.jnp.asarray(x), jcfg, jx.rules)
    got = mlp.mlp_fwd(tq, torch.as_tensor(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    # and the quantized model still generates through the dense path
    qp = lm.quantize_mlp_weights(tp, cfg)
    with torch.no_grad():
        cache = lm.init_cache(cfg, B, 12, device=CPU)
        tokens = torch.zeros((B, 4), dtype=torch.int32)
        lg, _ = lm.prefill(qp, {"tokens": tokens}, cache, cfg)
    assert bool(torch.isfinite(lg).all())


# ---------------------------------------------------------------------------
# The chunked scans
# ---------------------------------------------------------------------------


def _mamba_case(jx, t, seed):
    cfg = smoke_config("hymba-1.5b")
    jdefs = jx.mamba.mamba_defs(jx.configs.smoke_config("hymba-1.5b"))
    jp = jx.common.init_params(jdefs, jx.jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    jp = jx.jax.tree.map(np.asarray, jp)
    jp["b_dt"] = rng.normal(size=jp["b_dt"].shape).astype(np.float32) * 0.5
    tp = {k: torch.as_tensor(v) for k, v in jp.items()}
    x = rng.normal(size=(B, t, cfg.d_model)).astype(np.float32)
    di, _, n = mamba.mamba_dims(cfg)
    state = {"h": rng.normal(size=(B, di, n)).astype(np.float32),
             "conv": rng.normal(size=(B, cfg.ssm_conv - 1, di)).astype(
                 np.float32)}
    return cfg, jp, tp, x, state


def test_chunked_mamba_scan_matches_jax_and_the_stepped_form(jx):
    cfg, jp, tp, x, state = _mamba_case(jx, 64, 5)
    jstate = {k: jx.jnp.asarray(v) for k, v in state.items()}
    tstate = {k: torch.as_tensor(v) for k, v in state.items()}
    want, wst = jx.mamba.mamba_fwd(
        jx.jax.tree.map(jx.jnp.asarray, jp), jx.jnp.asarray(x),
        jx.configs.smoke_config("hymba-1.5b"), jx.rules, state=jstate)
    with torch.no_grad():
        got, gst = mamba.mamba_fwd(tp, torch.as_tensor(x), cfg, tstate,
                                   chunk=mamba.CHUNK)
        # a last chunk shorter than the rest: T = 70 against the stepped form
        x70 = torch.as_tensor(np.concatenate([x, x[:, :6]], axis=1))
        c70, s70 = mamba.mamba_fwd(tp, x70, cfg, tstate, chunk=mamba.CHUNK)
        p70, q70 = mamba.mamba_fwd(tp, x70, cfg, tstate)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for k in ("h", "conv"):
        np.testing.assert_allclose(gst[k].numpy(), np.asarray(wst[k]), **TOL,
                                   err_msg=k)
    np.testing.assert_allclose(c70.numpy(), p70.numpy(), **TOL)
    np.testing.assert_allclose(s70["h"].numpy(), q70["h"].numpy(), **TOL)


def test_chunked_mamba_scan_at_one_token_is_the_stepped_form(jx):
    cfg, _, tp, x, state = _mamba_case(jx, 1, 6)
    tstate = {k: torch.as_tensor(v) for k, v in state.items()}
    with torch.no_grad():
        a, sa = mamba.mamba_fwd(tp, torch.as_tensor(x), cfg, tstate)
        b, sb = mamba.mamba_fwd(tp, torch.as_tensor(x), cfg, tstate,
                                chunk=mamba.CHUNK)
    assert torch.equal(a, b) and torch.equal(sa["h"], sb["h"])
    assert torch.equal(sa["conv"], sb["conv"])


@pytest.mark.parametrize("t,chunk,span", [(70, 8, 32), (64, 32, 1024)])
def test_selective_scan_gradients_are_the_stepped_forms(monkeypatch, t,
                                                        chunk, span):
    """The chunked scan's own backward against autograd through the
    stepped form, in float64 (to rounding: 1e-12), over several blocks
    and a ragged last chunk, with gradients flowing into the start state
    and out of the final one."""
    monkeypatch.setattr(mamba, "SPAN", span)
    rng = np.random.default_rng(9)
    f64 = lambda *shape: torch.tensor(rng.normal(size=shape))  # noqa: E731
    ins = [torch.nn.functional.softplus(f64(t, B, 12)), f64(t, B, 12),
           f64(t, B, 4), f64(t, B, 4), -torch.exp(0.5 * f64(12, 4)),
           f64(B, 12, 4)]
    ins = [x.requires_grad_() for x in ins]
    gy, gh = f64(t, B, 12), f64(B, 12, 4)

    def stepped(delta, dx, bm, cm, a, h0):
        da = torch.exp(delta[..., None] * a)
        hs, h = mamba.decayed_cumsum(da, dx[..., None] * bm[:, :, None, :],
                                     h0)
        return torch.einsum("tbdn,tbn->tbd", hs, cm), h

    outs = {}
    for name, fn in (("stepped", stepped), ("chunked", lambda *x:
                                             mamba.selective_scan(
                                                 *x, chunk=chunk))):
        y, h = fn(*ins)
        outs[name] = (y, h, torch.autograd.grad(
            (y * gy).sum() + (h * gh).sum(), ins))
    (y1, h1, g1), (y2, h2, g2) = outs["stepped"], outs["chunked"]
    for want, got in [(y1, y2), (h1, h2), *zip(g1, g2)]:
        np.testing.assert_allclose(got.detach().numpy(), want.detach()
                                   .numpy(), rtol=1e-12, atol=1e-12)


def _wkv_case(t, seed):
    rng = np.random.default_rng(seed)
    h, hd = 2, rwkv6.HEAD_DIM
    r, k, v = (rng.normal(size=(B, t, h, hd)).astype(np.float32) * 0.5
               for _ in range(3))
    w = np.exp(-np.exp(rng.normal(size=(B, t, h, hd)) * 0.5 - 1.0)).astype(
        np.float32)
    u = rng.normal(size=(h, hd)).astype(np.float32) * 0.3
    s0 = rng.normal(size=(B, h, hd, hd)).astype(np.float32) * 0.3
    return r, k, v, w, u, s0


def test_chunked_wkv6_matches_jax_and_the_stepped_form(jx):
    args = _wkv_case(64, 7)
    want, wst = jx.rwkv.wkv6(*(jx.jnp.asarray(a) for a in args))
    targs = [torch.as_tensor(a) for a in args]
    with torch.no_grad():
        got, gst = rwkv6.wkv6(*targs, chunk=rwkv6.CHUNK)
        step, sst = rwkv6.wkv6(*targs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(gst.numpy(), np.asarray(wst), **TOL)
    np.testing.assert_allclose(got.numpy(), step.numpy(), **TOL)
    np.testing.assert_allclose(gst.numpy(), sst.numpy(), **TOL)


def test_chunked_wkv6_at_one_token_is_the_stepped_form():
    targs = [torch.as_tensor(a) for a in _wkv_case(1, 8)]
    with torch.no_grad():
        a, sa = rwkv6.wkv6(*targs)
        b, sb = rwkv6.wkv6(*targs, chunk=rwkv6.CHUNK)
    assert torch.equal(a, b) and torch.equal(sa, sb)


# ---------------------------------------------------------------------------
# Launchers
# ---------------------------------------------------------------------------


def _launch(tmp_path, module, *argv):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               TMPDIR=str(tmp_path))
    return subprocess.run([sys.executable, "-m", module, *argv], env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.fixture(scope="module")
def corpus_dir(tmp_path_factory):
    """One synthetic corpus for the launchers (both smoke vocabularies are
    256, so the second run finds the first's)."""
    return tmp_path_factory.mktemp("corpus")


@pytest.mark.parametrize("name", ["hymba-1.5b", "hubert-xlarge"])
def test_train_launcher_runs_the_family_on_the_cpu(tmp_path, corpus_dir,
                                                   name):
    assert smoke_config(name).vocab == 256
    res = _launch(tmp_path, "repro_torch.launch.train", "--arch", name,
                  "--smoke", "--steps", "2", "--seq-len", "32",
                  "--global-batch", "4", "--device", "cpu", "--data-dir",
                  str(corpus_dir), "--ckpt-dir", str(tmp_path / "ckpt"))
    assert res.returncode == 0, res.stdout + res.stderr
    assert f"arch={name}" in res.stdout and "loss" in res.stdout


def test_serve_launcher_refuses_an_encoder(tmp_path):
    res = _launch(tmp_path, "repro_torch.launch.serve", "--arch",
                  "hubert-xlarge", "--smoke", "--device", "cpu")
    assert res.returncode != 0
    assert "encoder-only: no decode step" in res.stderr

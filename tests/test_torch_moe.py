"""The port's Mixture-of-Experts layer and its training against JAX.

MoE token dispatch is one indirect scatter of the T·K token rows into
(E, C, D) expert buffers and combine one indirect gather back
(``ops.moe_dispatch`` / ``moe_combine``), each inside an autograd Function
whose backward is the other converter.  On this CPU host the converters
are their plain versions inside the same Functions; the tests marked
``cuda`` run the kernels on the card
(``python -m pytest -m cuda tests/test_torch_moe.py``).

Every input comes from a fixed numpy seed (no Hypothesis), and the
weights of the smoke model (``smoke_config('olmoe-1b-7b')``: 2 layers,
d_model 128, 4 experts, top-2, d_ff 64, float32) are the reference's own,
carried over leaf for leaf.  Tolerances: the dispatch is data movement and
must match bitwise, buffers, ``src`` and ``keep``, against both of the
reference's impls (``'pallas'`` in interpret mode and ``'ref'``); the
combine (a float32 einsum over K) within 1e-6; gradients of the dispatch
and combine within 1e-5 of ``jax.grad`` of the reference's composite,
with a dropped assignment's gradient exactly zero; the training loss and
gradients at the tolerances of ``tests/test_torch_train.py`` (loss 1e-5
relative, each gradient leaf within 1e-4 of its largest entry, one AdamW
update of the MoE tree from the same gradients within 1e-6, three train
steps' losses and gradient norms within 1e-5 relative).
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

from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.kernels import ops, plans, ref  # noqa: E402
from repro_torch.models import lm, mlp  # noqa: E402
from repro_torch.models.common import tree_paths  # noqa: E402
from repro_torch.optim import OptimizerConfig, make_optimizer  # noqa: E402
from repro_torch.train import make_train_step  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"
ARCH = "olmoe-1b-7b"
CFG = smoke_config(ARCH)

#: (T, E, K, C): no drops, some, heavy (capacity far under the load), and
#: olmoe's 64 experts top-8 at a small T.
ROUTING = {
    "no_drops": (24, 4, 2, 16),
    "some_drops": (40, 4, 2, 16),
    "heavy_drops": (64, 8, 2, 8),
    "one_slot": (16, 4, 3, 1),
    "olmoe_64x8": (48, 64, 8, 8),
}


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro import optim, train
    from repro.configs import smoke_config as jax_smoke
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    from repro.models import lm as jlm
    from repro.models import mlp as jmlp
    from repro.parallel.sharding import make_rules

    return types.SimpleNamespace(
        jax=jax, jnp=jnp, smoke=jax_smoke, ops=jops, ref=jref, lm=jlm,
        mlp=jmlp, optim=optim, train=train, rules=make_rules(with_pod=False))


def _routing(case, seed=0, dtype=np.float32, d=32):
    """tokens (T, D) and each token's K distinct experts (T, K)."""
    t, e, k, c = ROUTING[case]
    rng = np.random.default_rng(seed)
    tok = rng.normal(size=(t, d)).astype(dtype)
    # Skewed toward low experts, so some experts overflow.
    weights = np.linspace(2.0, 0.5, e)
    idx = np.stack([rng.choice(e, size=k, replace=False,
                               p=weights / weights.sum()) for _ in range(t)])
    return tok, idx.astype(np.int32), e, c


def _np(x):
    return np.asarray(x.detach().float() if hasattr(x, "detach") else x)


# ---------------------------------------------------------------------------
# Dispatch and combine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("jimpl", ["pallas", "ref"])
@pytest.mark.parametrize("case", list(ROUTING))
def test_dispatch_bitwise_equals_jax(jx, case, jimpl):
    tok, idx, e, c = _routing(case)
    want = jx.ops.moe_dispatch(jx.jnp.asarray(tok), jx.jnp.asarray(idx), e,
                               c, impl=jimpl)
    for impl in ("cuda", "ref"):
        got = ops.moe_dispatch(torch.as_tensor(tok), torch.as_tensor(idx), e,
                               c, impl=impl)
        for name, g, w in zip(("buffers", "src", "keep"), got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=f"{impl} {name}")
    if case in ("heavy_drops", "one_slot"):
        assert not got[2].all()


def test_dispatch_bf16_rows_bitwise(jx):
    tok, idx, e, c = _routing("heavy_drops", seed=3, d=64)
    jtok = jx.jnp.asarray(tok, jx.jnp.bfloat16)
    want = jx.ops.moe_dispatch(jtok, jx.jnp.asarray(idx), e, c,
                               impl="pallas")[0]
    got = ops.moe_dispatch(torch.as_tensor(tok).to(torch.bfloat16),
                           torch.as_tensor(idx), e, c)[0]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


@pytest.mark.parametrize("jimpl", ["pallas", "ref"])
@pytest.mark.parametrize("case", ["no_drops", "heavy_drops", "olmoe_64x8"])
def test_combine_matches_jax(jx, case, jimpl):
    tok, idx, e, c = _routing(case, seed=1)
    rng = np.random.default_rng(11)
    t, k = idx.shape
    outputs = rng.normal(size=(e, c, tok.shape[1])).astype(np.float32)
    gates = rng.random((t, k)).astype(np.float32)
    _, src, keep = ops.moe_dispatch(torch.as_tensor(tok),
                                    torch.as_tensor(idx), e, c)
    gw = gates * keep.numpy()
    want = jx.ops.moe_combine(jx.jnp.asarray(outputs),
                              jx.jnp.asarray(src.numpy()),
                              jx.jnp.asarray(gw), t, impl=jimpl)
    for impl in ("cuda", "ref"):
        got = ops.moe_combine(torch.as_tensor(outputs), src,
                              torch.as_tensor(gw), t, impl=impl)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6, err_msg=impl)


def _composite_torch(impl, tok, idx, e, c, scale, bias, gates):
    """dispatch → an affine 'expert' whose empty slots output ``bias`` →
    combine, weighted by the kept gates."""
    buf, src, keep = ops.moe_dispatch(tok, idx, e, c, impl=impl)
    out_buf = buf * scale[:, None, :] + bias[:, None, :]
    return ops.moe_combine(out_buf, src, gates * keep, tok.shape[0],
                           impl=impl), keep


@pytest.mark.parametrize("case", ["some_drops", "heavy_drops", "one_slot"])
def test_dispatch_combine_grads_match_jax(jx, case):
    tok, idx, e, c = _routing(case, seed=2)
    t, k = idx.shape
    rng = np.random.default_rng(5)
    d = tok.shape[1]
    scale = rng.normal(size=(e, d)).astype(np.float32)
    bias = rng.normal(size=(e, d)).astype(np.float32)
    gates = rng.random((t, k)).astype(np.float32)
    w = rng.normal(size=(t, d)).astype(np.float32)
    jnp = jx.jnp

    def jloss(tok_, scale_, bias_, gates_):
        buf, src, keep = jx.ref.moe_dispatch(tok_, jnp.asarray(idx), e, c)
        out_buf = buf * scale_[:, None, :] + bias_[:, None, :]
        out = jx.ref.moe_combine(out_buf, src, gates_ * keep, t)
        return jnp.sum(out * jnp.asarray(w))

    args = [jnp.asarray(a) for a in (tok, scale, bias, gates)]
    want = jx.jax.grad(jloss, argnums=(0, 1, 2, 3))(*args)
    for impl in ("cuda", "ref"):
        leaves = [torch.tensor(a, requires_grad=True)
                  for a in (tok, scale, bias, gates)]
        out, keep = _composite_torch(impl, leaves[0], torch.as_tensor(idx),
                                     e, c, *leaves[1:])
        got = torch.autograd.grad((out * torch.as_tensor(w)).sum(), leaves)
        for name, g, wg in zip(("tokens", "scale", "bias", "gates"), got,
                               want):
            np.testing.assert_allclose(g.numpy(), np.asarray(wg), rtol=1e-5,
                                       atol=1e-5, err_msg=f"{impl} {name}")
        keep = keep.numpy()
        dropped_all = ~keep.any(1)
        if dropped_all.any():  # a token with no expert gets no gradient
            assert not got[0][torch.as_tensor(dropped_all)].any()
        assert not got[3][torch.as_tensor(~keep)].any()
    assert not keep.all()


@pytest.mark.parametrize("case", ["heavy_drops", "one_slot"])
def test_function_backwards_zero_dropped_and_empty_rows(case):
    """The Functions' own backwards: the combine's scatter leaves empty
    slots at exactly zero and does not write the row the forward gather
    clipped a dropped assignment to; the dispatch's gather gives a dropped
    assignment exactly zero.  Both equal the oracle's gradients bitwise."""
    tok, idx, e, c = _routing(case, seed=4)
    rng = np.random.default_rng(6)
    t, k = idx.shape
    tok_t = torch.as_tensor(tok)
    idx_t = torch.as_tensor(idx)
    buf, src, keep = ops.moe_dispatch(tok_t, idx_t, e, c)
    outputs = torch.tensor(rng.normal(size=tuple(buf.shape)).astype(
        np.float32), requires_grad=True)
    gw = torch.as_tensor(rng.random((t, k)).astype(np.float32)) * keep
    w = torch.as_tensor(rng.normal(size=(t, tok.shape[1])).astype(
        np.float32))
    grads = []
    for impl in ("cuda", "ref"):
        out = ops.moe_combine(outputs, src, gw, t, impl=impl)
        grads.append(torch.autograd.grad((out * w).sum(), outputs)[0])
    assert torch.equal(grads[0], grads[1])
    assert not grads[0][src < 0].any()
    # The dispatch's backward, against the oracle's, bitwise.
    g_buf = torch.as_tensor(rng.normal(size=tuple(buf.shape)).astype(
        np.float32))
    tg = []
    for impl in ("cuda", "ref"):
        leaf = tok_t.clone().requires_grad_(True)
        b = ops.moe_dispatch(leaf, idx_t, e, c, impl=impl)[0]
        tg.append(torch.autograd.grad((b * g_buf).sum(), leaf)[0])
    np.testing.assert_allclose(tg[0].numpy(), tg[1].numpy(), rtol=1e-6,
                               atol=1e-6)
    dropped_all = ~keep.any(1)
    assert dropped_all.any() or case == "heavy_drops"
    assert not tg[0][dropped_all].any()


def test_dispatch_and_combine_move_rows_by_the_converters(monkeypatch):
    """Forward: one scatter (dispatch) and one gather (combine); backward:
    one gather (dispatch) and one scatter (combine), with the dropped
    assignments' sentinel E·C passed as it is."""
    calls = []

    def spy(name, fn):
        def wrapped(*args, **kwargs):
            calls.append((name, int(args[-1].max())))
            return fn(*args, **kwargs)
        monkeypatch.setattr(ops, name, wrapped)

    spy("indirect_scatter", ops.indirect_scatter)
    spy("indirect_gather", ops.indirect_gather)
    tok, idx, e, c = _routing("heavy_drops", seed=7)
    leaf = torch.tensor(tok, requires_grad=True)
    buf, src, keep = ops.moe_dispatch(leaf, torch.as_tensor(idx), e, c)
    out = ops.moe_combine(buf * 2.0, src, keep.float(), tok.shape[0])
    assert [n for n, _ in calls] == ["indirect_scatter", "indirect_gather"]
    out.sum().backward()
    assert [n for n, _ in calls] == ["indirect_scatter", "indirect_gather",
                                     "indirect_scatter", "indirect_gather"]
    assert all(top == e * c for _, top in calls)  # drops reach the kernels


def test_gather_plan_takes_16_byte_units_at_olmoe_rows():
    """bf16 rows of d_model 2048 are 4 KB: 16-byte units, one 4 KB slab of
    256 threads a row, at the training microbatch's 65,536 rows."""
    plan = plans.gather_plan(2048 * 2, 0, 65536)
    assert (plan.unit, plan.threads, plan.slabs, plan.grid_x) == \
        (16, 256, 1, 65536)


# ---------------------------------------------------------------------------
# Router and layer
# ---------------------------------------------------------------------------


def test_router_ties_follow_lax_top_k(jx):
    """Equal probabilities among experts: the lower index comes first, as
    ``jax.lax.top_k`` orders them."""
    rng = np.random.default_rng(8)
    probs = rng.integers(0, 4, (64, 64)).astype(np.float32) / 4.0
    probs[0] = 0.5  # all 64 tied
    want_v, want_i = jx.jax.lax.top_k(jx.jnp.asarray(probs), 8)
    got_v, got_i = mlp._top_k(torch.as_tensor(probs), 8)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def _params(jx, cfg=CFG, seed=0):
    jcfg = dataclasses.replace(jx.smoke(ARCH), **{
        f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})
    jp = jx.lm.init_model(jcfg, jx.jax.random.PRNGKey(seed))
    tree = jx.jax.tree.map(np.asarray, jp)
    return jcfg, jp, lm.lm_params_from_numpy(tree, cfg, device=CPU)


@pytest.mark.parametrize("dense_residual", [False, True])
def test_moe_fwd_and_aux_match_jax(jx, dense_residual):
    cfg = dataclasses.replace(CFG, dense_residual=dense_residual)
    jcfg, jp, tp = _params(jx, cfg)
    x = np.random.default_rng(9).normal(size=(2, 16, cfg.d_model)).astype(
        np.float32)
    jpl = jx.jax.tree.map(lambda a: a[0], jp["layers"]["moe"])
    tpl = {k: (v[0] if not isinstance(v, dict) else
               {kk: vv[0] for kk, vv in v.items()})
           for k, v in tp["layers"]["moe"].items()}
    for jimpl in ("pallas", "ref"):
        want, want_aux = jx.mlp.moe_fwd(jpl, jx.jnp.asarray(x), jcfg,
                                        jx.rules, impl=jimpl)
        for impl in ("cuda", "ref"):
            got, aux = mlp.moe_fwd(tpl, torch.as_tensor(x), cfg, impl=impl)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(float(aux), float(want_aux),
                                       rtol=1e-6)


def test_capacity_matches_reference(jx):
    full = get_config(ARCH)
    jfull = dataclasses.replace(jx.smoke(ARCH), n_experts=64, top_k=8)
    for n in (1, 8, 64, 2048, 8192):
        assert mlp.moe_capacity(full, n) == jx.mlp.moe_capacity(jfull, n)
    assert mlp.moe_capacity(full, 8192) == 1280  # 81,920-row buffer


# ---------------------------------------------------------------------------
# Model tree and configuration
# ---------------------------------------------------------------------------


def test_smoke_and_full_configs_equal_the_references(jx):
    from repro.configs import get_config as jget

    for port, ref_cfg in ((CFG, jx.smoke(ARCH)), (get_config(ARCH),
                                                  jget(ARCH))):
        for f in dataclasses.fields(port):
            assert getattr(port, f.name) == getattr(ref_cfg, f.name), f.name
    # 6,919,028,736 parameters by the reference's count, norms aside.
    full = get_config(ARCH)
    defs = lm.model_defs(full)
    n = sum(int(np.prod(p.shape)) for _, p in tree_paths(defs))
    norms = (2 * full.n_layers + 1) * full.d_model
    assert n - norms == jget(ARCH).param_count() == 6_919_028_736


def test_moe_tree_carries_over_leaf_for_leaf(jx):
    jcfg, jp, tp = _params(jx)
    want = [(jx.jax.tree_util.keystr(k), tuple(np.shape(v))) for k, v in
            jx.jax.tree_util.tree_flatten_with_path(jp)[0]]
    got = [(path, tuple(t.shape)) for path, t in tree_paths(tp)]
    assert got == want
    assert "['layers']['moe']['router']" in dict(got)
    for (path, a), (_, b) in zip(tree_paths(tp),
                                 tree_paths(jx.jax.tree.map(np.asarray, jp))):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=path)
    # The port's own draw: the router at 0.02, the stacked (L, E, d, f)
    # experts at the reference's fan-in, 1 / sqrt(L * E * d).
    own = dict(tree_paths(lm.init_model(CFG, seed=1, device=CPU)))
    ref_leaves = dict(tree_paths(jx.jax.tree.map(np.asarray, jp)))
    for path, t in own.items():
        assert tuple(t.shape) == ref_leaves[path].shape, path
        want_std = float(np.std(ref_leaves[path]))
        assert abs(float(t.std()) - want_std) <= 0.1 * want_std + 1e-6, path
    assert abs(float(own["['layers']['moe']['router']"].std()) - 0.02) < 2e-3
    fan_in = CFG.n_layers * CFG.n_experts * CFG.d_model
    assert abs(float(own["['layers']['moe']['w_up']"].std())
               - fan_in ** -0.5) < 0.05 * fan_in ** -0.5


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


def _batch(b=2, s=32, vocab=256, seed=0, mask_tail=0):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, vocab, (b, s + 1))
    mask = np.ones((b, s), np.float32)
    if mask_tail:
        mask[:, -mask_tail:] = 0.0
    return {"tokens": rows[:, :-1].astype(np.int32),
            "targets": rows[:, 1:].astype(np.int32), "mask": mask}


@pytest.mark.parametrize("impl", ["cuda", "ref"])
@pytest.mark.parametrize("remat", [False, True])
def test_train_loss_and_grads_match_jax(jx, remat, impl):
    cfg = dataclasses.replace(CFG, remat=remat)
    jcfg, jp, tp = _params(jx, cfg)
    batch = _batch(mask_tail=3)
    (jloss, jaux), jg = jx.jax.value_and_grad(
        jx.lm.train_loss, has_aux=True)(
        jp, {k: jx.jnp.asarray(v) for k, v in batch.items()}, jcfg, jx.rules)
    leaves = [t.requires_grad_(True) for _, t in tree_paths(tp)]
    loss, aux = lm.train_loss(tp, {k: torch.as_tensor(v)
                                   for k, v in batch.items()}, cfg, impl=impl)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    for key in ("ce_loss", "aux_loss"):
        np.testing.assert_allclose(float(aux[key].detach()),
                                   float(jaux[key]), rtol=1e-5, err_msg=key)
    assert float(aux["aux_loss"].detach()) > 0.0
    want = dict(tree_paths(jx.jax.tree.map(np.asarray, jg)))
    for (path, _), g in zip(tree_paths(tp), grads):
        w = want[path]
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4 * scale,
                                   err_msg=path)


def test_one_adamw_update_matches_jax(jx):
    """One AdamW update of the MoE tree, from the reference's own gradients
    of a batch, in both packages: every leaf within 1e-6.  (From each
    package's own gradients the update is as close only where a gradient
    entry is large against its summation error: Adam's first step moves a
    weight by about lr whatever the gradient's size, so an entry that sums
    to nearly zero moves by a different fraction of lr in each package.)"""
    ocfg = dict(lr=1e-2, warmup_steps=1, total_steps=20)
    jopt = jx.optim.make_optimizer(jx.optim.OptimizerConfig(**ocfg))
    topt = make_optimizer(OptimizerConfig(**ocfg))
    jcfg, jp, tp = _params(jx)
    batch = {k: jx.jnp.asarray(v) for k, v in _batch(b=2, seed=20).items()}
    jg = jx.jax.grad(lambda p: jx.lm.train_loss(p, batch, jcfg,
                                                jx.rules)[0])(jp)
    jp, _, jm = jopt.update(jg, jopt.init(jp), jp, 1)
    tg = lm.lm_params_from_numpy(jx.jax.tree.map(np.asarray, jg), CFG,
                                 device=CPU)
    tp, _, tm = topt.update(tg, topt.init(tp), tp, 1)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-6)
    for (path, a), (_, b) in zip(tree_paths(jx.jax.tree.map(np.asarray, jp)),
                                 tree_paths(tp)):
        np.testing.assert_allclose(b.detach().numpy(), a, rtol=1e-6,
                                   atol=1e-6, err_msg=path)


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_three_train_steps_match_jax(jx, grad_accum):
    ocfg = dict(lr=1e-2, warmup_steps=1, total_steps=20)
    jopt = jx.optim.make_optimizer(jx.optim.OptimizerConfig(**ocfg))
    topt = make_optimizer(OptimizerConfig(**ocfg))
    jcfg, jp, tp = _params(jx)
    jstep = jx.jax.jit(jx.train.make_train_step(
        jcfg, jopt, jx.rules, grad_accum=grad_accum))
    tstep = make_train_step(CFG, topt, grad_accum=grad_accum)
    jstate, tstate = jopt.init(jp), topt.init(tp)
    for step in range(3):
        batch = _batch(b=4, seed=30 + step)
        jp, jstate, jm = jstep(jp, jstate, {k: jx.jnp.asarray(v)
                                            for k, v in batch.items()}, step)
        tp, tstate, tm = tstep(tp, tstate, {k: torch.as_tensor(v)
                                            for k, v in batch.items()}, step)
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=1e-5, err_msg=f"step {step} {key}")


def test_launcher_trains_olmoe_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
         "--smoke", "--steps", "3", "--device", "cpu", "--global-batch", "4",
         "--seq-len", "32", "--data-dir", str(tmp_path / "data"),
         "--ckpt-dir", str(tmp_path / "ckpt")],
        env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert f"arch={ARCH}" in res.stdout and "on cpu" in res.stdout
    assert (tmp_path / "ckpt" / "step_00000003" / "manifest.json").exists()


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the converter kernels are CUDA-only")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["some_drops", "heavy_drops",
                                  "olmoe_64x8"])
def test_dispatch_combine_kernels_on_card(cuda, case, dtype):
    """Forward and backward through the kernels: bitwise against the same
    Functions on the CPU (the plain converters) and against the oracles
    on the card, one scatter and one gather each way."""
    tok, idx, e, c = _routing(case, seed=12, d=256)
    rng = np.random.default_rng(13)
    t, k = idx.shape
    outputs = rng.normal(size=(e, c, 256)).astype(np.float32)
    gates = rng.random((t, k)).astype(np.float32)
    w = rng.normal(size=(t, 256)).astype(np.float32)

    def run(dev, impl):
        leaf = torch.as_tensor(tok).to(dev, dtype).requires_grad_(True)
        outs = torch.as_tensor(outputs).to(dev, dtype).requires_grad_(True)
        buf, src, keep = ops.moe_dispatch(leaf, torch.as_tensor(idx).to(dev),
                                          e, c, impl=impl)
        out = ops.moe_combine(outs, src, torch.as_tensor(gates).to(dev)
                              * keep, t, impl=impl)
        g_buf = torch.ones_like(buf)
        grads = torch.autograd.grad(
            [(out * torch.as_tensor(w).to(dev, dtype)).sum(),
             (buf * g_buf).sum()], [leaf, outs])
        return [x.detach().cpu() for x in (buf, src, keep, out, *grads)]

    ops.reset_launch_counts()
    got = run(cuda, "cuda")
    torch.cuda.synchronize()
    assert ops.indirect_scatter.launches == 2
    assert ops.indirect_gather.launches == 2
    names = ("buf", "src", "keep", "out", "d_tokens", "d_outputs")
    for name, g, wv in zip(names, got, run(cuda, "ref")):
        assert torch.equal(g, wv), f"{name} vs the oracles on the card"
    # Against the plain converters on the CPU: data movement bitwise; the
    # gate einsum and its gradient within a float32 step or one bf16 step.
    tol = 1e-6 if dtype == torch.float32 else 2.0 ** -7
    for name, g, wv in zip(names, got, run(CPU, "cuda")):
        if name in ("out", "d_outputs"):
            np.testing.assert_allclose(g.float().numpy(), wv.float().numpy(),
                                       rtol=tol, atol=tol, err_msg=name)
        else:
            assert torch.equal(g, wv), f"{name} vs the CPU"

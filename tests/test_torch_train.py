"""The port's training path against the JAX reference.

The reference's ``lm.init_model`` draws the weights of yi-6b's smoke
config (2 layers, d_model 128, 4/2 heads of 32, vocab 256, float32);
``lm_params_from_numpy`` carries them into the port leaf for leaf, and
batches come from numpy seeds, so both packages train the same model on
the same data.  On the CPU the port's attention runs the flash kernels'
plain versions through the same autograd Function as on the card.

Tolerances, set from float32 summed in other orders: attention within
1e-5; the loss within 1e-5 relative and each gradient leaf within 1e-4 of
its largest entry; one optimizer update within 1e-6 (Adafactor's bfloat16
first moment within one bfloat16 step, at most 2^-7 relative: a float32
value that differs in its last bits can round to the neighbouring
bfloat16); three train steps' losses and gradient norms within 1e-5
relative.  Inside the port, a preempted and resumed run equals a straight
one bit for bit.
"""
import dataclasses
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.data import TokenDataset, synthetic_corpus  # noqa: E402
from repro_torch.models import attention, lm, mlp  # noqa: E402
from repro_torch.models.common import (apply_rope,  # noqa: E402
                                       chunked_softmax_xent, tree_paths)
from repro_torch.optim import (OptimizerConfig, cosine_schedule,  # noqa: E402
                               make_optimizer)
from repro_torch.runtime import (FaultToleranceConfig,  # noqa: E402
                                 TrainController)
from repro_torch.train import (make_compressed_train_step,  # noqa: E402
                               make_train_step)

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"
CFG = smoke_config("yi-6b")


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro import checkpoint, data, optim, train
    from repro.configs import smoke_config as jax_smoke
    from repro.models import attention as jattn
    from repro.models import common as jcommon
    from repro.models import lm as jlm
    from repro.parallel.sharding import make_rules

    return types.SimpleNamespace(
        jax=jax, jnp=jnp, smoke=jax_smoke, lm=jlm, attn=jattn,
        common=jcommon, optim=optim, train=train, data=data,
        ckpt=checkpoint, rules=make_rules(with_pod=False))


def _np_tree(jx, tree):
    return jx.jax.tree.map(np.asarray, tree)


def _jax_cfg(jx, **repl):
    return dataclasses.replace(jx.smoke("yi-6b"), **repl)


def _params(jx, **repl):
    """(JAX params, the port's copy on the CPU) of the smoke model."""
    jp = jx.lm.init_model(_jax_cfg(jx, **repl), jx.jax.random.PRNGKey(0))
    cfg = dataclasses.replace(CFG, **repl)
    return jp, lm.lm_params_from_numpy(_np_tree(jx, jp), cfg, device=CPU)


def _batch(b=2, s=32, vocab=256, seed=0, mask_tail=0):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, vocab, (b, s + 1))
    mask = np.ones((b, s), np.float32)
    if mask_tail:
        mask[:, -mask_tail:] = 0.0
    return {"tokens": rows[:, :-1].astype(np.int32),
            "targets": rows[:, 1:].astype(np.int32), "mask": mask}


def _t(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _j(jx, batch):
    return {k: jx.jnp.asarray(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# Model pieces
# ---------------------------------------------------------------------------


def test_rope_and_chunked_xent_match_jax(jx):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 16, 4, 32)).astype(np.float32)
    pos = np.arange(16)
    want = jx.common.apply_rope(jx.jnp.asarray(x), jx.jnp.asarray(pos), 5e6)
    got = apply_rope(torch.as_tensor(x), torch.as_tensor(pos), 5e6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    xs = rng.normal(size=(2, 32, 16)).astype(np.float32)
    w = rng.normal(size=(16, 40)).astype(np.float32)
    labels = rng.integers(0, 30, (2, 32))
    mask = (rng.random((2, 32)) > 0.3).astype(np.float32)
    jl, jc = jx.common.chunked_softmax_xent(
        jx.jnp.asarray(xs), jx.jnp.asarray(w), jx.jnp.asarray(labels),
        jx.jnp.asarray(mask), seq_chunk=8, n_valid=30)
    tl, tc = chunked_softmax_xent(
        torch.as_tensor(xs), torch.as_tensor(w), torch.as_tensor(labels),
        torch.as_tensor(mask), seq_chunk=8, n_valid=30)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    assert float(tc) == float(jc)


ATTN_VARIANTS = {
    "causal": ({}, True),
    "window-local": (dict(window=8, global_interval=2), False),
    "window-global": (dict(window=8, global_interval=2), True),
    "qkv-bias": (dict(qkv_bias=True), True),
    "non-causal": (dict(causal=False), True),
}


@pytest.mark.parametrize("variant", list(ATTN_VARIANTS))
def test_attention_fwd_matches_jax(jx, variant):
    repl, is_global = ATTN_VARIANTS[variant]
    jp, tp = _params(jx, **repl)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 32, CFG.d_model)).astype(np.float32)
    jpl = jx.jax.tree.map(lambda a: a[0], jp["layers"]["attn"])
    if "bq" in jpl:  # zeros at init: give the biases values
        jpl = {k: (a + 0.1 * jx.jnp.asarray(
            rng.normal(size=a.shape), a.dtype) if k[0] == "b" else a)
            for k, a in jpl.items()}
    want = jx.attn.attention_fwd(
        jpl, jx.jnp.asarray(x), _jax_cfg(jx, **repl), jx.rules,
        float(is_global), jx.jnp.arange(32))
    tpl = {k: torch.tensor(np.asarray(a)) for k, a in jpl.items()}
    got = attention.attention_fwd(tpl, torch.as_tensor(x),
                                  dataclasses.replace(CFG, **repl),
                                  is_global, torch.arange(32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("remat", [False, True])
def test_train_loss_and_grads_match_jax(jx, remat):
    jp, tp = _params(jx, remat=remat)
    batch = _batch(mask_tail=5)
    jcfg = _jax_cfg(jx, remat=remat)
    (jloss, jaux), jg = jx.jax.value_and_grad(
        jx.lm.train_loss, has_aux=True)(jp, _j(jx, batch), jcfg, jx.rules)
    for leaf in jx.jax.tree.leaves(tp):
        leaf.requires_grad_(True)
    cfg = dataclasses.replace(CFG, remat=remat)
    loss, aux = lm.train_loss(tp, _t(batch), cfg)
    grads = torch.autograd.grad(loss, [t for _, t in tree_paths(tp)])
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(aux["ce_loss"].detach()),
                               float(jaux["ce_loss"]), rtol=1e-5)
    assert float(aux["tokens"]) == float(jaux["tokens"]) == 2 * 27
    assert float(aux["aux_loss"]) == 0.0
    want = dict(tree_paths(_np_tree(jx, jg)))
    for (path, _), g in zip(tree_paths(tp), grads):
        w = want[path]
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4 * scale,
                                   err_msg=path)


def test_init_model_leaves_are_the_references_in_order(jx):
    """Leaf i of the port's tree is leaf i of the reference's: the same
    ``keystr`` path and shape, in ``jax.tree_util``'s flattening order,
    the order in which both packages write checkpoints."""
    jp = jx.lm.init_model(_jax_cfg(jx), jx.jax.random.PRNGKey(0))
    want = [(jx.jax.tree_util.keystr(k), tuple(np.shape(v))) for k, v in
            jx.jax.tree_util.tree_flatten_with_path(jp)[0]]
    got = [(path, tuple(t.shape)) for path, t in
           tree_paths(lm.init_model(CFG, seed=0, device=CPU))]
    assert got == want


def test_init_model_is_seeded_with_the_reference_scales(jx):
    a = lm.init_model(CFG, seed=3, device=CPU)
    b = lm.init_model(CFG, seed=3, device=CPU)
    jp = jx.lm.init_model(_jax_cfg(jx), jx.jax.random.PRNGKey(0))
    want = dict(tree_paths(_np_tree(jx, jp)))
    for (path, x), (_, y) in zip(tree_paths(a), tree_paths(b)):
        assert torch.equal(x, y) and x.dtype == torch.float32
        assert tuple(x.shape) == want[path].shape, path
        ref_std = float(np.std(want[path]))
        got_std = float(x.std()) if x.numel() > 1 else 0.0
        assert abs(got_std - ref_std) <= 0.1 * ref_std + 1e-6, path


def test_params_from_numpy_rejects_another_tree(jx):
    jp, _ = _params(jx)
    tree = _np_tree(jx, jp)
    del tree["head"]
    with pytest.raises(ValueError, match="leaves"):
        lm.lm_params_from_numpy(tree, CFG, device=CPU)


def test_unported_families_and_steps_raise():
    """Nothing of the port raises for want of a mesh any more (A9b): the
    expert-parallel MoE and the compressed data-parallel step exist, and
    the compressed step refuses ``fsdp=True``, as the reference's
    asserts (``tests/test_torch_ep.py`` and ``test_torch_collectives.py``
    hold them against the reference on CPU processes).  Every family's
    tree builds (A7c is done): MoE, rwkv6, hymba and the front ends."""
    assert callable(mlp._ep_moe_fwd) and callable(mlp._ep_shard)
    with pytest.raises(ValueError, match="replicated params"):
        make_compressed_train_step(dataclasses.replace(CFG, fsdp=True),
                                   None, None)
    assert "moe" in lm.model_defs(smoke_config("olmoe-1b-7b"))["layers"]
    assert "tm" in lm.model_defs(get_config("rwkv6-3b"))["layers"]
    assert "hymba" in lm.model_defs(smoke_config("hymba-1.5b"))["layers"]
    audio = lm.model_defs(dataclasses.replace(CFG, modality="audio",
                                              frontend_dim=16))
    assert "frontend_proj" in audio and "embed" not in audio


# ---------------------------------------------------------------------------
# Optimizers and the train step
# ---------------------------------------------------------------------------


def test_cosine_schedule_equals_jax(jx):
    jfn = jx.optim.optimizers.cosine_schedule(3e-4, 10, 100)
    tfn = cosine_schedule(3e-4, 10, 100)
    for step in [0, 1, 5, 9, 10, 11, 50, 99, 100, 150]:
        assert float(tfn(step)) == float(jfn(step)), step


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_update_matches_jax(jx, name):
    ocfg = dict(name=name, lr=1e-2, warmup_steps=2, total_steps=50)
    jopt = jx.optim.make_optimizer(jx.optim.OptimizerConfig(**ocfg))
    topt = make_optimizer(OptimizerConfig(**ocfg))
    jp, tp = _params(jx)
    jstate, tstate = jopt.init(jp), topt.init(tp)
    rng = np.random.default_rng(4)
    for step in (3, 4):
        grads = jx.jax.tree.map(
            lambda a: rng.normal(size=a.shape).astype(np.float32) * 0.05,
            _np_tree(jx, jp))
        jp, jstate, jm = jopt.update(
            jx.jax.tree.map(jx.jnp.asarray, grads), jstate, jp, step)
        tgrads = {k: v for k, v in lm.lm_params_from_numpy(
            grads, CFG, device=CPU).items()}
        tp, tstate, tm = topt.update(tgrads, tstate, tp, step)
        assert float(tm["lr"]) == float(jm["lr"])
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        for (path, a), (_, b) in zip(tree_paths(_np_tree(jx, jp)),
                                     tree_paths(tp)):
            np.testing.assert_allclose(b.numpy(), a, rtol=1e-6, atol=1e-6,
                                       err_msg=f"{name} step {step} {path}")
        jleaves = tree_paths(_np_tree(jx, jstate))
        tleaves = tree_paths(tstate)
        assert [p for p, _ in jleaves] == [p for p, _ in tleaves]
        for (path, a), (_, b) in zip(jleaves, tleaves):
            bf16 = str(a.dtype) == "bfloat16"
            assert b.dtype == (torch.bfloat16 if bf16 else torch.float32)
            np.testing.assert_allclose(b.float().numpy(),
                                       np.asarray(a, np.float32),
                                       rtol=2.0 ** -7 if bf16 else 1e-6,
                                       atol=1e-6, err_msg=path)


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_steps_match_jax(jx, grad_accum):
    ocfg = dict(lr=1e-2, warmup_steps=1, total_steps=20)
    jopt = jx.optim.make_optimizer(jx.optim.OptimizerConfig(**ocfg))
    topt = make_optimizer(OptimizerConfig(**ocfg))
    jp, tp = _params(jx)
    jstep = jx.jax.jit(jx.train.make_train_step(
        _jax_cfg(jx), jopt, jx.rules, grad_accum=grad_accum))
    tstep = make_train_step(CFG, topt, grad_accum=grad_accum)
    jstate, tstate = jopt.init(jp), topt.init(tp)
    for step in range(3):
        batch = _batch(b=4, seed=10 + step)
        jp, jstate, jm = jstep(jp, jstate, _j(jx, batch), step)
        tp, tstate, tm = tstep(tp, tstate, _t(batch), step)
        assert set(tm) == set(jm)
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=1e-5, err_msg=f"step {step} {key}")


# ---------------------------------------------------------------------------
# Data, checkpoints, fault tolerance, launcher
# ---------------------------------------------------------------------------


def test_token_dataset_windows_equal_across_packages(jx, tmp_path):
    synthetic_corpus(str(tmp_path / "port"), n_tokens=5_000, vocab=256,
                     seed=1)
    jx.data.synthetic_corpus(str(tmp_path / "jax"), n_tokens=5_000,
                             vocab=256, seed=1)
    for name in ("port", "jax"):
        assert (tmp_path / "port" / "shard_00000.bin").read_bytes() == \
            (tmp_path / name / "shard_00000.bin").read_bytes()
        ours = TokenDataset(str(tmp_path / name), 32, 4)
        theirs = jx.data.TokenDataset(str(tmp_path / name), 32, 4)
        for step in (0, 1, 7, 40):
            a, b = ours.batch(step), theirs.batch(step)
            for k in ("tokens", "targets", "mask"):
                np.testing.assert_array_equal(a[k], b[k])


def _state_tree(jx, tp):
    opt = make_optimizer(OptimizerConfig())
    state = {"params": tp, "opt": opt.init(tp)}
    state["params"]["final_norm"] = state["params"]["final_norm"].to(
        torch.bfloat16)
    return state


def test_checkpoint_round_trip_and_reference_checkpoints(jx, tmp_path):
    jp, tp = _params(jx)
    state = _state_tree(jx, tp)
    mgr = CheckpointManager(str(tmp_path / "port"), keep=2)
    mgr.save(3, state)
    target = jx.jax.tree.map(torch.zeros_like, state)
    back = mgr.restore(3, target)
    for (pa, a), (pb, b) in zip(tree_paths(state), tree_paths(back)):
        assert pa == pb and a.dtype == b.dtype and torch.equal(a, b)
    manifest = json.loads(
        (tmp_path / "port" / "step_00000003" / "manifest.json").read_text())
    # The reference reads the port's checkpoint, leaf for leaf.
    jstate = {"params": jp, "opt": jx.optim.make_optimizer(
        jx.optim.OptimizerConfig()).init(jp)}
    jstate["params"]["final_norm"] = jstate["params"]["final_norm"].astype(
        jx.jnp.bfloat16)
    jmgr = jx.ckpt.CheckpointManager(str(tmp_path / "port"))
    jback = jmgr.restore(3, jstate)
    jpaths = [jx.jax.tree_util.keystr(k) for k, _ in
              jx.jax.tree_util.tree_flatten_with_path(jback)[0]]
    assert manifest["paths"] == jpaths
    for (_, a), b in zip(tree_paths(state), jx.jax.tree.leaves(jback)):
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(b, np.float32))
    # And the port reads the reference's.
    jx.ckpt.CheckpointManager(str(tmp_path / "jax")).save(5, jstate)
    back = CheckpointManager(str(tmp_path / "jax")).restore(5, target)
    for (path, a), b in zip(tree_paths(back), jx.jax.tree.leaves(jstate)):
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(b, np.float32), err_msg=path)
    # Retention keeps the newest two, and a shape mismatch raises.
    for step in (4, 5):
        mgr.save(step, state)
    assert mgr.all_steps() == [4, 5]
    bad = dict(target, params=dict(target["params"],
                                   embed=torch.zeros(3, 3)))
    with pytest.raises(ValueError, match="embed"):
        mgr.restore(5, bad)


def _controller_setup(tmp_path, name):
    opt = make_optimizer(OptimizerConfig(lr=1e-2, warmup_steps=2,
                                         total_steps=100))
    step_raw = make_train_step(CFG, opt)

    def step_fn(state, batch, step):
        p, o, metrics = step_raw(state["params"], state["opt"], batch, step)
        return {"params": p, "opt": o}, metrics

    data = np.random.default_rng(42).integers(0, CFG.vocab, (64, 33))

    def make_batch(step):
        rows = data[(step * 4 + np.arange(4)) % 64]
        return _t({"tokens": rows[:, :-1], "targets": rows[:, 1:],
                   "mask": np.ones((4, 32), np.float32)})

    def fresh_state():
        params = lm.init_model(CFG, seed=0, device=CPU)
        return {"params": params, "opt": opt.init(params)}

    ft = FaultToleranceConfig(ckpt_dir=str(tmp_path / name), ckpt_every=5)
    return step_fn, make_batch, ft, fresh_state


def test_preempt_resume_bitwise_equals_straight_run(tmp_path):
    step_fn, make_batch, ft, fresh = _controller_setup(tmp_path, "a")
    c1 = TrainController(step_fn, make_batch, ft)
    final_a = c1.run(fresh(), 12, log_every=100)

    ft_b = dataclasses.replace(ft, ckpt_dir=str(tmp_path / "b"))
    c2 = TrainController(step_fn, make_batch, ft_b)
    with pytest.raises(KeyboardInterrupt):
        c2.run(fresh(), 12, preempt_at=8, log_every=100)
    c3 = TrainController(step_fn, make_batch, ft_b)
    assert c3.ckpt.latest_step() == 5
    final_b = c3.run(fresh(), 12, log_every=100)

    assert [h["loss"] for h in c3.history] == \
        [h["loss"] for h in c1.history[5:]]
    for (path, a), (_, b) in zip(tree_paths(final_a), tree_paths(final_b)):
        assert torch.equal(a, b), path


def test_launcher_trains_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "yi-6b",
         "--smoke", "--steps", "3", "--device", "cpu", "--global-batch", "4",
         "--seq-len", "32", "--data-dir", str(tmp_path / "data"),
         "--ckpt-dir", str(tmp_path / "ckpt")],
        env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "arch=yi-6b" in res.stdout and "on cpu" in res.stdout
    assert (tmp_path / "ckpt" / "step_00000003" / "manifest.json").exists()

"""The port's int8 error-feedback all-reduce and compressed data-parallel
step against the reference (``repro.optim.compression``,
``repro.train.make_compressed_train_step``).

The quantizer and the tree flattening are held in this process against
``jax.jit`` of the reference's functions: codes and scales bitwise (the
reference always runs them under ``jit``, where XLA computes ``amax /
127`` as ``amax * float32(1/127)``).  ``int8_psum`` runs as 8 and as 4
``gloo`` ranks (``tests/_torch_dist.py``) against the reference's jitted
``shard_map`` on 8 and 4 fake CPU devices, over 20 error-feedback rounds
at unit-normal inputs: every output and residual bitwise equal to the
reference's (XLA fuses each dequantize-and-add into a multiply-add with
one rounding, and the port computes it so), and the reference test's
convergence (the mean of the rounds nearer the true sum than one round,
under 5% relative).  The compressed
step runs the yi-6b smoke model (``shard_kv_heads=False``) on 8 and on 4
ranks for 6 AdamW steps from the reference's weights and batch: step 0's
loss within 1e-5 relative of the reference's, the later ones within
1e-3, and the loss falls.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_dist  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.launch.mesh import Mesh, bind_mesh  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.common import tree_paths  # noqa: E402
from repro_torch.optim import (OptimizerConfig, compression,  # noqa: E402
                               make_optimizer)
from repro_torch.parallel import collectives  # noqa: E402
from repro_torch.train import make_compressed_train_step  # noqa: E402

N = 1000
ROUNDS = 20
STEPS = 6
BATCH = (8, 32)
#: (length, devices): lengths that need padding to devices * CHUNK, and one
#: that does not.
PAD_CASES = [(1000, 8), (129, 4), (4096, 8), (5000, 1), (127, 2)]


def _yi_cfg(smoke):
    return dataclasses.replace(smoke("yi-6b"), shard_kv_heads=False)


def _opt_cfg():
    return dict(lr=1e-2, warmup_steps=2, total_steps=50)


@pytest.fixture(scope="module")
def jx():
    import jax

    from repro.optim import compression as jc
    return jax, jc


# ---------------------------------------------------------------------------
# In this process: the quantizer and the tree flattening
# ---------------------------------------------------------------------------


def _values(n, seed):
    """Unit normals with a zero chunk, a tiny chunk and a wide one."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=n).astype(np.float32)
    x[:min(n, 128)] = 0.0
    x[128:256] *= np.float32(1e-30)
    x[256:384] *= np.float32(1e6)
    return x


@pytest.mark.parametrize("n,n_dev", PAD_CASES)
def test_quantize_matches_jitted_reference(jx, n, n_dev):
    jax, jc = jx
    x = _values(n, seed=n)
    mult = n_dev * compression.CHUNK
    want_flat = np.asarray(jc._pad_to(jax.numpy.asarray(x), mult))
    flat = compression._pad_to(torch.tensor(x), mult)
    np.testing.assert_array_equal(flat.numpy(), want_flat)
    rows = flat.reshape(n_dev, -1)
    q, s = compression._quantize(rows)
    jq, js = jax.jit(jc._quantize)(want_flat.reshape(n_dev, -1))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(
        compression._dequantize(q, s).numpy(),
        np.asarray(jax.jit(jc._dequantize)(jq, js)))


def test_flatten_tree_leaf_order_is_the_reference(jx):
    jax, jc = jx
    rng = np.random.default_rng(0)
    tree = {"w": {"b": rng.normal(size=(3, 4)), "a": rng.normal(size=(5,))},
            "emb": rng.normal(size=(2, 2, 2)), "c": rng.normal(size=())}
    tree = jax.tree_util.tree_map(lambda a: a.astype(np.float32), tree)
    tt = jax.tree_util.tree_map(torch.tensor, tree)
    tt["w"]["a"] = tt["w"]["a"].to(torch.bfloat16)
    jt = jax.tree_util.tree_map(jax.numpy.asarray, tree)
    jt["w"]["a"] = jt["w"]["a"].astype(jax.numpy.bfloat16)
    flat, aux = compression.flatten_tree(tt)
    jflat, jaux = jc.flatten_tree(jt)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jflat))
    assert compression.tree_size(tt) == jc.tree_size(jt) == flat.shape[0]
    back = compression.unflatten_tree(flat, aux)
    jback = jc.unflatten_tree(jflat, jaux)
    for (path, got), want in zip(tree_paths(back),
                                 jax.tree_util.tree_leaves(jback)):
        assert tuple(got.shape) == want.shape, path
        assert str(got.dtype).endswith(str(want.dtype)), path
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))


def test_compressed_step_refuses_fsdp():
    cfg = dataclasses.replace(smoke_config("yi-6b"), fsdp=True)
    with pytest.raises(ValueError, match="replicated"):
        make_compressed_train_step(cfg, None, Mesh(("data",), (1,)))


# ---------------------------------------------------------------------------
# Spawned: int8_psum and the compressed step at 8 and 4 ranks
# ---------------------------------------------------------------------------


def _psum_rounds(rank, world, inp, mesh=None, axes="data"):
    mesh = mesh or bind_mesh(Mesh(("data",), (world,)), "cpu")
    group = collectives.axis_group(mesh, axes)
    assert collectives.axis_index(mesh, axes) == rank
    x = torch.tensor(inp[f"xs{world}"][rank])
    err = torch.zeros(N)
    outs, errs = [], []
    for _ in range(ROUNDS):
        out, err = compression.int8_psum(x, group, err)
        outs.append(out.numpy())
        errs.append(err.numpy().copy())
    return mesh, {"outs": np.stack(outs), "errs": np.stack(errs)}


def _compressed_losses(mesh, inp):
    cfg = _yi_cfg(smoke_config)
    params = lm.lm_params_from_numpy(_torch_dist.nest(inp, "lm"), cfg,
                                     device="cpu")
    opt = make_optimizer(OptimizerConfig(**_opt_cfg()))
    state = opt.init(params)
    step = make_compressed_train_step(cfg, opt, mesh, dp_axes=("data",))
    err = step.init_err_fb(params)
    assert err.shape == (1, compression.tree_size(params))
    batch = {k: torch.tensor(inp[f"batch/{k}"])
             for k in ("tokens", "targets", "mask")}
    losses = []
    for i in range(STEPS):
        params, state, err, metrics = step(params, state, batch, i, err)
        losses.append(float(metrics["loss"]))
    return dict(losses=np.array(losses), err_norm=float(err.norm()))


def _worker(rank, world, work):
    inp = dict(np.load(work / "inputs.npz"))
    mesh, out = _psum_rounds(rank, world, inp)
    out.update(_compressed_losses(mesh, inp))
    if world == 8:
        # the group of a tuple of axes: ('pod', 'data') of a 2 x 4 mesh
        # lists the 8 ranks in the order of the 'data' axis of 8
        pod = bind_mesh(Mesh(("pod", "data"), (2, 4)), "cpu")
        out["tuple_outs"] = _psum_rounds(rank, world, inp, pod,
                                         ("pod", "data"))[1]["outs"]
    return out


REFERENCE = """
import dataclasses, sys, numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P, AxisType
from repro.configs import smoke_config
from repro.models import lm
from repro.optim import OptimizerConfig, make_optimizer, compression
from repro.train import make_compressed_train_step
from _torch_dist import nest
from test_torch_collectives import ROUNDS, STEPS, _opt_cfg, _yi_cfg

inp = dict(np.load("inputs.npz"))
out = {}
for world in (8, 4):
    mesh = Mesh(np.array(jax.devices()[:world]), ("data",),
                axis_types=(AxisType.Auto,))
    def f(x, e):
        o, ne = compression.int8_psum(x[0], "data", e[0])
        return o[None], ne[None]
    fm = jax.jit(jax.shard_map(f, mesh=mesh, in_specs=(P("data"), P("data")),
                               out_specs=(P("data"), P("data")),
                               check_vma=False))
    xs = jnp.asarray(inp[f"xs{world}"])
    err = jnp.zeros_like(xs)
    outs, errs = [], []
    for _ in range(ROUNDS):
        o, err = fm(xs, err)
        outs.append(np.asarray(o))
        errs.append(np.asarray(err))
    out[f"outs{world}"] = np.stack(outs, 1)  # (world, rounds, N)
    out[f"errs{world}"] = np.stack(errs, 1)

for world in (8, 4):
    mesh = Mesh(np.array(jax.devices()[:world]), ("data",),
                axis_types=(AxisType.Auto,))
    cfg = _yi_cfg(smoke_config)
    opt = make_optimizer(OptimizerConfig(**_opt_cfg()))
    params = jax.tree_util.tree_map(jnp.asarray, nest(inp, "lm"))
    state = opt.init(params)
    step = make_compressed_train_step(cfg, opt, mesh, dp_axes=("data",))
    err_fb = step.init_err_fb(params)
    batch = {k: jnp.asarray(inp[f"batch/{k}"])
             for k in ("tokens", "targets", "mask")}
    losses = []
    with jax.set_mesh(mesh):
        jstep = jax.jit(step)
        for i in range(STEPS):
            params, state, err_fb, metrics = jstep(params, state, batch, i,
                                                   err_fb)
            losses.append(float(metrics["loss"]))
    out[f"losses{world}"] = np.array(losses)
np.savez("reference.npz", **out)
print("REFERENCE_OK")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory, jx):
    jax, _ = jx
    from repro.configs import smoke_config as jax_smoke_config
    from repro.models import lm as jlm

    work = tmp_path_factory.mktemp("collectives")
    rng = np.random.default_rng(0)
    inp = {f"xs{w}": rng.normal(size=(w, N)).astype(np.float32)
           for w in (8, 4)}
    inp.update(_torch_dist.keyed("lm", jlm.init_model(
        _yi_cfg(jax_smoke_config), jax.random.PRNGKey(0))))
    vocab = jax_smoke_config("yi-6b").vocab
    inp["batch/tokens"] = rng.integers(0, vocab, BATCH).astype(np.int32)
    inp["batch/targets"] = rng.integers(0, vocab, BATCH).astype(np.int32)
    inp["batch/mask"] = np.ones(BATCH, np.float32)
    np.savez(work / "inputs.npz", **inp)

    procs = _torch_dist.start_reference(
        f"import sys; sys.path.insert(0, {str(_torch_dist.ROOT / 'tests')!r})"
        "\n" + REFERENCE, work)
    procs += _torch_dist.start_ranks(__file__, "w8", 8, work)
    _torch_dist.wait_all(procs, work)
    _torch_dist.wait_all(_torch_dist.start_ranks(__file__, "w4", 4, work),
                         work)
    ranks = {w: [torch.load(work / f"w{w}_{r}.pt", weights_only=False)
                 for r in range(w)] for w in (8, 4)}
    return inp, dict(np.load(work / "reference.npz")), ranks


@pytest.mark.parametrize("world", [8, 4])
def test_int8_psum_matches_reference(runs, world):
    _, ref, ranks = runs
    for rank, r in enumerate(ranks[world]):
        np.testing.assert_array_equal(r["outs"], ref[f"outs{world}"][rank])
        np.testing.assert_array_equal(r["errs"], ref[f"errs{world}"][rank])


@pytest.mark.parametrize("world", [8, 4])
def test_int8_psum_error_feedback_converges(runs, world):
    inp, _, ranks = runs
    true = inp[f"xs{world}"].astype(np.float64).sum(0)
    outs = ranks[world][0]["outs"]
    r0 = np.abs(outs[-1] - true).max() / np.abs(true).max()
    r20 = np.abs(outs.mean(0) - true).max() / np.abs(true).max()
    assert r0 < 0.05 and r20 < r0, (r0, r20)


@pytest.mark.parametrize("world", [8, 4])
def test_int8_psum_ranks_agree(runs, world):
    _, _, ranks = runs
    for r in ranks[world][1:]:
        np.testing.assert_array_equal(r["outs"], ranks[world][0]["outs"])


def test_int8_psum_over_a_tuple_of_axes(runs):
    _, _, ranks = runs
    for r in ranks[8]:
        np.testing.assert_array_equal(r["tuple_outs"], r["outs"])


@pytest.mark.parametrize("world", [8, 4])
def test_compressed_step_losses_match_reference(runs, world):
    _, ref, ranks = runs
    want = ref[f"losses{world}"]
    for r in ranks[world]:
        got = r["losses"]
        assert abs(got[0] - want[0]) <= 1e-5 * abs(want[0]), (got, want)
        np.testing.assert_allclose(got[1:], want[1:], rtol=1e-3)
        assert got[-1] < got[0]
        assert r["err_norm"] > 0.0  # the residual carries what int8 lost


if __name__ == "__main__":
    _torch_dist.worker_main({"w8": _worker, "w4": _worker})

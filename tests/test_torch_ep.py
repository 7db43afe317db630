"""The port's mesh paths of the model against the reference, on 8 CPU
processes: expert-parallel MoE (``mlp._ep_moe_fwd``), the vocab-sharded
embedding gather (``lm._embed_lookup``) and a smoke olmoe ``train_loss``
with sharding rules, on a 2 x 4 ``data x model`` mesh of 8 ranks and a
2 x 2 mesh of 4.

The port runs as ``gloo`` ranks (``tests/_torch_dist.py``), each holding
the batch whole, as the reference's ``shard_map`` over the experts (or
vocab) axis sees it; the reference runs under ``jax.jit`` on fake CPU
devices in a subprocess, its mesh built from
``np.array(jax.devices()[:n]).reshape(shape)`` so that device *i* and rank
*i* sit at the same coordinates.  Inputs come from fixed numpy seeds and the
weights are the reference's own, carried over.  One spawn of each side
serves every case of the file.

Tolerances: the MoE output and gradients within 1e-5 of the reference's
expert-parallel path at ``capacity_factor`` 8.0 and 1.25; the sharded
loss within 1e-5 relative of the reference's; the embedding's forward
bitwise, its gradient within 1e-4 of ``np.add.at`` and 1e-5 of the
reference's.  Against the portable (single-device) path the tolerance is
the reference's own, 1e-4, where capacity does not bind (8.0).  At 1.25
it binds: the reference's expert-parallel path packs all tokens with the
capacity of one data shard's tokens (``t // n_data``), so it drops
assignments its portable path keeps and the two differ by far more than
1e-4; the port follows the expert-parallel path there, and the test
checks that the gap is the reference's own.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_dist  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.launch.mesh import Mesh, bind_mesh  # noqa: E402
from repro_torch.models import lm, mlp  # noqa: E402
from repro_torch.parallel import collectives, make_rules  # noqa: E402

ARCH = "olmoe-1b-7b"
#: world size → the ``data x model`` mesh of the ranks
MESHES = {8: (2, 4), 4: (2, 2)}
CAPACITY = {"cf8": 8.0, "cf1.25": 1.25}
#: The train_loss cases: the config's own capacity factor (1.25), and 8.0.
LOSS_CF = {"own": None, "cf8": 8.0}
MOE_X = (4, 16)           # (B, S) of the MoE layer's input
LOSS_BATCH = (4, 16)      # (B, S) of the train_loss case
EMB = (128, 64, (4, 8))   # vocab, width, ids shape


def _moe_cfg(cf):
    return dataclasses.replace(smoke_config(ARCH), n_experts=8, top_k=2,
                               capacity_factor=cf)


def _loss_cfg(smoke, cf):
    cfg = smoke(ARCH)
    return cfg if cf is None else dataclasses.replace(cfg,
                                                      capacity_factor=cf)


# ---------------------------------------------------------------------------
# The port's side: one process a rank
# ---------------------------------------------------------------------------


def _worker(rank, world, work):
    inp = dict(np.load(work / "inputs.npz"))
    mesh = bind_mesh(Mesh(("data", "model"), MESHES[world]), "cpu")
    rules = make_rules(with_pod=False, batch_axes=("data",), mesh=mesh)
    model = collectives.axis_group(mesh, "model")
    out = {}
    for tag, cf in CAPACITY.items():
        cfg = _moe_cfg(cf)
        p = {k: torch.tensor(v, requires_grad=True)
             for k, v in _torch_dist.nest(inp, f"{tag}/moe").items()}
        o, aux = mlp.moe_fwd(p, torch.tensor(inp["moe_x"]), cfg,
                             rules=rules)
        grads = torch.autograd.grad((o ** 2).sum() + aux, list(p.values()))
        out[f"{tag}/out"] = o.detach().numpy()
        out[f"{tag}/aux"] = aux.detach().numpy()
        for name, g in zip(p, grads):
            if name != "router":  # each rank holds its experts' rows
                g = collectives.psum(g, model)
            out[f"{tag}/grad/{name}"] = g.numpy()

    batch = {k: torch.tensor(inp[f"batch/{k}"])
             for k in ("tokens", "targets", "mask")}
    for tag, cf in LOSS_CF.items():
        cfg = _loss_cfg(smoke_config, cf)
        params = lm.lm_params_from_numpy(_torch_dist.nest(inp, "lm"), cfg,
                                         device="cpu")
        with torch.no_grad():
            out[f"loss/{tag}/sharded"] = lm.train_loss(
                params, batch, cfg, rules=rules)[0].numpy()
            out[f"loss/{tag}/unsharded"] = lm.train_loss(
                params, batch, cfg)[0].numpy()

    table = torch.tensor(inp["emb/table"], requires_grad=True)
    ids = torch.tensor(inp["emb/ids"])
    got = lm._embed_lookup(table, ids, rules, torch.float32)
    (g,) = torch.autograd.grad((got ** 2).sum(), [table])
    out["emb/out"] = got.detach().numpy()
    out["emb/grad"] = collectives.psum(g, model).numpy()
    out.update(_dtensor_params(inp, mesh, model))
    return out


def _dtensor_params(inp, mesh, model):
    """``_ep_moe_fwd`` and ``_embed_lookup`` with ``param_shardings``
    DTensor parameters, fsdp off and on, against the same calls with the
    plain tensors: the outputs, and the gradients gathered whole against
    the plain ones summed over the model axis, as equality flags."""
    from repro_torch.models.common import Param
    from repro_torch.parallel.sharding import param_shardings

    x = torch.tensor(inp["moe_x"])
    ids = torch.tensor(inp["emb/ids"])
    flags = {}
    for fsdp in (False, True):
        rules = make_rules(with_pod=False, batch_axes=("data",), fsdp=fsdp,
                           mesh=mesh)
        for tag, cf in CAPACITY.items():
            cfg = _moe_cfg(cf)
            plain = {k: torch.tensor(v, requires_grad=True)
                     for k, v in _torch_dist.nest(inp, f"{tag}/moe").items()}
            shard = param_shardings(mlp.moe_defs(cfg), rules, mesh)
            dt = {k: shard[k].distribute(v.detach()).requires_grad_(True)
                  for k, v in plain.items()}
            res = {}
            for side, p in (("plain", plain), ("dtensor", dt)):
                o, aux = mlp.moe_fwd(p, x, cfg, rules=rules)
                grads = torch.autograd.grad((o ** 2).sum() + aux,
                                            list(p.values()))
                res[side] = (o.detach(), aux.detach(), dict(zip(p, grads)))
            (o0, a0, g0), (o1, a1, g1) = res["plain"], res["dtensor"]
            key = f"dt/fsdp{int(fsdp)}/{tag}"
            flags[f"{key}/out"] = torch.equal(o0, o1) and torch.equal(a0, a1)
            for name in g0:
                whole = g0[name] if name == "router" else collectives.psum(
                    g0[name], model)
                flags[f"{key}/grad/{name}"] = torch.equal(
                    whole, g1[name].full_tensor())
        table = torch.tensor(inp["emb/table"], requires_grad=True)
        vocab, width, _ = EMB
        shard = param_shardings({"embed": Param((vocab, width),
                                                ("vocab", "d_model"))},
                                rules, mesh)["embed"]
        tdt = shard.distribute(table.detach()).requires_grad_(True)
        o0 = lm._embed_lookup(table, ids, rules, torch.float32)
        o1 = lm._embed_lookup(tdt, ids, rules, torch.float32)
        (g0,) = torch.autograd.grad((o0 ** 2).sum(), [table])
        (g1,) = torch.autograd.grad((o1 ** 2).sum(), [tdt])
        key = f"dt/fsdp{int(fsdp)}/emb"
        flags[f"{key}/out"] = torch.equal(o0, o1)
        flags[f"{key}/grad"] = torch.equal(collectives.psum(g0, model),
                                           g1.full_tensor())
    return flags


# ---------------------------------------------------------------------------
# The reference's side: jit on 8 fake devices
# ---------------------------------------------------------------------------

REFERENCE = """
import dataclasses, numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P, AxisType
from repro.configs import smoke_config
from repro.models import lm, mlp as M
from repro.models.lm import _embed_lookup
from repro.parallel.sharding import make_rules
from _torch_dist import nest
from test_torch_ep import ARCH, CAPACITY, LOSS_CF, MESHES, _loss_cfg

inp = dict(np.load("inputs.npz"))
rules_ref = make_rules(with_pod=False, batch_axes=None)
x = jnp.asarray(inp["moe_x"])
params = jax.tree_util.tree_map(jnp.asarray, nest(inp, "lm"))
batch = {k: jnp.asarray(inp[f"batch/{k}"]) for k in ("tokens", "targets",
                                                     "mask")}
table, ids = jnp.asarray(inp["emb/table"]), jnp.asarray(inp["emb/ids"])


def moe(out, mesh, rules_ep, tag, cf):
    cfg = dataclasses.replace(smoke_config(ARCH), n_experts=8, top_k=2,
                              capacity_factor=cf)
    mp = {k: jnp.asarray(v) for k, v in nest(inp, f"{tag}/moe").items()}

    def loss(p, rules):
        o, a = M.moe_fwd(p, x, cfg, rules)
        return jnp.sum(o ** 2) + a

    out[f"{tag}/plain_out"], out[f"{tag}/plain_aux"] = M.moe_fwd(
        mp, x, cfg, rules_ref)
    for name, g in jax.grad(loss)(mp, rules_ref).items():
        out[f"{tag}/plain_grad/{name}"] = g
    with jax.set_mesh(mesh):
        out[f"{tag}/ep_out"], out[f"{tag}/ep_aux"] = jax.jit(
            lambda p, xx: M.moe_fwd(p, xx, cfg, rules_ep))(
                mp, jax.device_put(x, NamedSharding(mesh, P("data"))))
        grads = jax.jit(jax.grad(lambda p: loss(p, rules_ep)))(mp)
    for name, g in grads.items():
        out[f"{tag}/ep_grad/{name}"] = g


def losses(out, mesh, rules_ep, tag, cf):
    cfg = _loss_cfg(smoke_config, cf)
    out[f"loss/{tag}/plain"] = lm.train_loss(params, batch, cfg,
                                             rules_ref)[0]
    with jax.set_mesh(mesh):
        out[f"loss/{tag}/sharded"] = jax.jit(
            lambda p, b: lm.train_loss(p, b, cfg, rules_ep)[0])(params, batch)


def embedding(out, mesh, rules_ep):
    with jax.set_mesh(mesh):
        out["emb/out"] = jax.jit(
            lambda t, i: _embed_lookup(t, i, rules_ep, jnp.float32))(
                table, ids)
        out["emb/grad"] = jax.jit(jax.grad(lambda t: jnp.sum(
            _embed_lookup(t, ids, rules_ep, jnp.float32) ** 2)))(table)


res = {}
for world, shape in MESHES.items():
    mesh = Mesh(np.array(jax.devices()[:world]).reshape(shape),
                ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    rules_ep = make_rules(with_pod=False, batch_axes=("data",), mesh=mesh)
    out = {}
    for tag, cf in CAPACITY.items():
        moe(out, mesh, rules_ep, tag, cf)
    for tag, cf in LOSS_CF.items():
        losses(out, mesh, rules_ep, tag, cf)
    embedding(out, mesh, rules_ep)
    res.update({f"{world}/{k}": np.asarray(v) for k, v in out.items()})
np.savez("reference.npz", **res)
print("REFERENCE_OK")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax

    from repro.models import lm as jlm
    from repro.models.common import init_params
    from repro.models.mlp import moe_defs

    work = tmp_path_factory.mktemp("ep")
    rng = np.random.default_rng(0)
    inp = {"moe_x": rng.normal(size=MOE_X + (smoke_config(ARCH).d_model,))
           .astype(np.float32)}
    from repro.configs import smoke_config as jax_smoke_config

    for tag, cf in CAPACITY.items():
        jcfg = dataclasses.replace(jax_smoke_config(ARCH), n_experts=8,
                                   top_k=2, capacity_factor=cf)
        p = init_params(moe_defs(jcfg), jax.random.PRNGKey(0))
        inp.update(_torch_dist.keyed(f"{tag}/moe", p))
    cfg = smoke_config(ARCH)
    inp.update(_torch_dist.keyed("lm", jlm.init_model(
        jax_smoke_config(ARCH), jax.random.PRNGKey(0))))
    inp["batch/tokens"] = rng.integers(0, cfg.vocab, LOSS_BATCH).astype(
        np.int32)
    inp["batch/targets"] = rng.integers(0, cfg.vocab, LOSS_BATCH).astype(
        np.int32)
    inp["batch/mask"] = np.ones(LOSS_BATCH, np.float32)
    vocab, width, ids_shape = EMB
    inp["emb/table"] = rng.normal(size=(vocab, width)).astype(np.float32)
    inp["emb/ids"] = rng.integers(0, vocab, ids_shape).astype(np.int32)
    np.savez(work / "inputs.npz", **inp)

    procs = _torch_dist.start_reference(
        f"import sys; sys.path.insert(0, {str(_torch_dist.ROOT / 'tests')!r})"
        "\n" + REFERENCE, work)
    procs += _torch_dist.start_ranks(__file__, "w8", 8, work)
    _torch_dist.wait_all(procs, work)
    _torch_dist.wait_all(_torch_dist.start_ranks(__file__, "w4", 4, work),
                         work)
    ref = dict(np.load(work / "reference.npz"))
    return inp, {w: {k[len(f"{w}/"):]: v for k, v in ref.items()
                     if k.startswith(f"{w}/")} for w in MESHES}, {
        w: [torch.load(work / f"w{w}_{r}.pt", weights_only=False)
            for r in range(w)] for w in MESHES}


def _at(runs, world):
    """(inputs, the reference's results, the ranks' results) at a world
    size."""
    inp, ref, ranks = runs
    return inp, ref[world], ranks[world]


def _max_err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64) - b)))


@pytest.mark.parametrize("world", list(MESHES))
@pytest.mark.parametrize("tag", list(CAPACITY))
def test_ep_moe_output_matches_reference(runs, tag, world):
    _, ref, ranks = _at(runs, world)
    for r in ranks:
        assert _max_err(r[f"{tag}/out"], ref[f"{tag}/ep_out"]) < 1e-5
        assert _max_err(r[f"{tag}/aux"], ref[f"{tag}/ep_aux"]) < 1e-6


@pytest.mark.parametrize("world", list(MESHES))
@pytest.mark.parametrize("tag", list(CAPACITY))
def test_ep_moe_gradients_match_reference(runs, tag, world):
    _, ref, ranks = _at(runs, world)
    names = [k.split("/")[-1] for k in ref if k.startswith(f"{tag}/ep_grad/")]
    assert sorted(names) == ["router", "w_down", "w_gate", "w_up"]
    for r in ranks:
        for name in names:
            g = r[f"{tag}/grad/{name}"]
            assert _max_err(g, ref[f"{tag}/ep_grad/{name}"]) < 1e-5, name


@pytest.mark.parametrize("world", list(MESHES))
def test_ep_moe_matches_the_portable_path_where_capacity_is_free(runs,
                                                                 world):
    _, ref, ranks = _at(runs, world)
    for r in ranks:
        assert _max_err(r["cf8/out"], ref["cf8/plain_out"]) < 1e-4
        for name in ("router", "w_down", "w_gate", "w_up"):
            assert _max_err(r[f"cf8/grad/{name}"],
                            ref[f"cf8/plain_grad/{name}"]) < 1e-4, name


@pytest.mark.parametrize("world", list(MESHES))
def test_ep_moe_capacity_gap_is_the_reference_own(runs, world):
    """At capacity factor 1.25 the expert-parallel path drops what the
    portable path keeps, in the reference as in the port."""
    _, ref, ranks = _at(runs, world)
    gap = _max_err(ref["cf1.25/ep_out"], ref["cf1.25/plain_out"])
    assert gap > 1e-4
    for r in ranks:
        assert abs(_max_err(r["cf1.25/out"], ref["cf1.25/plain_out"])
                   - gap) < 1e-5


@pytest.mark.parametrize("world", list(MESHES))
def test_ep_ranks_agree(runs, world):
    """Every rank ends with the same output and summed gradients."""
    _, _, ranks = _at(runs, world)
    for r in ranks[1:]:
        for key, val in r.items():
            np.testing.assert_array_equal(val, ranks[0][key], err_msg=key)


@pytest.mark.parametrize("world", list(MESHES))
@pytest.mark.parametrize("tag", list(LOSS_CF))
def test_sharded_train_loss_matches_reference(runs, tag, world):
    _, ref, ranks = _at(runs, world)
    want = float(ref[f"loss/{tag}/sharded"])
    for r in ranks:
        assert abs(float(r[f"loss/{tag}/sharded"]) - want) <= 1e-5 * abs(want)
    plain = float(ref[f"loss/{tag}/plain"])
    assert abs(float(ranks[0][f"loss/{tag}/unsharded"]) - plain) \
        <= 1e-5 * abs(plain)


@pytest.mark.parametrize("world", list(MESHES))
def test_sharded_train_loss_matches_unsharded_where_capacity_is_free(
        runs, world):
    _, _, ranks = _at(runs, world)
    for r in ranks:
        want = float(r["loss/cf8/unsharded"])
        assert abs(float(r["loss/cf8/sharded"]) - want) <= 1e-5 * abs(want)


@pytest.mark.parametrize("world", list(MESHES))
def test_sharded_embedding_forward_is_bitwise(runs, world):
    inp, ref, ranks = _at(runs, world)
    want = inp["emb/table"][inp["emb/ids"]]
    for r in ranks:
        np.testing.assert_array_equal(r["emb/out"], want)
    np.testing.assert_array_equal(ref["emb/out"], want)


@pytest.mark.parametrize("world", list(MESHES))
def test_sharded_embedding_gradient(runs, world):
    inp, ref, ranks = _at(runs, world)
    table, ids = inp["emb/table"], inp["emb/ids"]
    expect = np.zeros_like(table)
    np.add.at(expect, ids.ravel(), 2 * table[ids].reshape(-1, table.shape[1]))
    for r in ranks:
        np.testing.assert_allclose(r["emb/grad"], expect, rtol=1e-4,
                                   atol=1e-4)
        assert _max_err(r["emb/grad"], ref["emb/grad"]) < 1e-5


DT_KEYS = [f"dt/fsdp{f}/{t}/{part}" for f in (0, 1) for t in CAPACITY
           for part in ("out", "grad/router", "grad/w_up", "grad/w_gate",
                        "grad/w_down")] + [
    f"dt/fsdp{f}/emb/{part}" for f in (0, 1) for part in ("out", "grad")]


@pytest.mark.parametrize("world", list(MESHES))
@pytest.mark.parametrize("key", DT_KEYS)
def test_dtensor_params_are_bitwise_the_plain_call(runs, key, world):
    """``param_shardings`` DTensor parameters (each expert weight laid out
    with its experts on the model axis, d_model on the data axis under
    fsdp; the vocab-sharded table) give the plain-tensor call's output and
    gradients bit for bit, on every rank."""
    _, _, ranks = _at(runs, world)
    for r in ranks:
        assert bool(r[key]), key


def test_embedding_without_mesh_is_the_plain_gather():
    table = torch.randn(16, 4, generator=torch.Generator().manual_seed(0))
    ids = torch.tensor([[3, 1, 3]])
    for rules in (None, make_rules(with_pod=False, batch_axes=None)):
        got = lm._embed_lookup(table, ids, rules, torch.float32)
        assert torch.equal(got, table[ids])


if __name__ == "__main__":
    _torch_dist.worker_main({"w8": _worker, "w4": _worker})

"""The port's device-bound shardings and the elastic path against the
reference, on CPU processes: ``launch.mesh.bind_mesh``,
``parallel.sharding.param_shardings`` / ``constrain``,
``runtime.reshard_state`` and ``CheckpointManager`` with DTensor leaves
and sharding targets.

``param_shardings`` runs on 8 ``gloo`` ranks (``tests/_torch_dist.py``)
bound to a 2 x 2 x 2 ``pod x data x model`` mesh with ``fsdp=True``, for
every leaf of the yi-6b and olmoe-1b-7b smoke models: each rank's local
block must be, exactly, the block that the reference's
``NamedSharding(...).devices_indices_map`` gives the device at the same
coordinates (device *i* of ``np.array(jax.devices()).reshape(2, 2, 2)``
on 8 fake CPU devices).  That holds the fsdp rule ``('data', 'pod')``,
the reverse of the mesh's order, to the reference's block order.

The elastic path: a state sharded on 8 ranks (4 x 2 ``data x model``) is
saved, resharded in memory onto 2 x 4, and restored from disk in a
second spawn of 4 ranks (2 x 2), values bitwise; a checkpoint that the
reference's manager wrote from its 8-device state restores there too.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_dist  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.launch.mesh import Mesh, bind_mesh  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.common import tree_paths  # noqa: E402
from repro_torch.parallel import (Sharding, collectives,  # noqa: E402
                                  constrain, make_rules, param_shardings)
from repro_torch.runtime import reshard_state  # noqa: E402

ARCHS = ("yi-6b", "olmoe-1b-7b")
POD = (("pod", "data", "model"), (2, 2, 2))
#: Layouts of the pod x data x model axes over 8 ranks, bound in turn.
LAYOUTS = ((2, 2, 2), (2, 4, 1), (1, 2, 4), (2, 2, 2))
TREE_SPECS = {"w": ("data", "model"), "b": ("data",)}


def _tree():
    return {"w": np.arange(64.0, dtype=np.float32).reshape(8, 8),
            "b": np.ones(16, np.float32)}


def _full(shape):
    """Values that name their own position."""
    return torch.arange(int(np.prod(shape)), dtype=torch.float64).reshape(
        shape)


# ---------------------------------------------------------------------------
# The port's side
# ---------------------------------------------------------------------------


def _worker8(rank, world, work):
    from torch.distributed.tensor import Replicate, distribute_tensor

    out = {}
    mesh = bind_mesh(Mesh(*POD), "cpu")
    rules = make_rules(fsdp=True, mesh=mesh)
    for arch in ARCHS:
        defs = lm.model_defs(smoke_config(arch))
        for (path, p), (_, sh) in zip(
                tree_paths(defs), tree_paths(param_shardings(defs, rules,
                                                             mesh))):
            full = _full(p.shape)
            dt = sh.distribute(full)
            out[f"{arch}{path}"] = dt.to_local().numpy()
            out[f"{arch}{path}/full_equal"] = bool(
                torch.equal(dt.full_tensor(), full))

    # constrain: a pass-through on plain tensors and without a mesh, the
    # rules' placements on a DTensor
    x = _full((8, 6))
    out["constrain/plain"] = constrain(x, rules, ("batch", None)) is x
    rep = distribute_tensor(x, mesh.device_mesh, [Replicate()] * 3)
    out["constrain/no_mesh"] = constrain(rep, make_rules(), ("batch",
                                                             None)) is rep
    for dims in (("batch", None), ("fsdp", "heads")):
        c = constrain(rep, rules, dims)
        out[f"constrain/{dims}"] = c.to_local().numpy()
        out[f"constrain/{dims}/placements"] = repr(tuple(c.placements))
        out[f"constrain/{dims}/full_equal"] = bool(
            torch.equal(c.full_tensor(), x))

    # the group of ('pod', 'data') follows the layout of each mesh, bound
    # in turn, each freed before the next
    for i, sizes in enumerate(LAYOUTS):
        m = bind_mesh(Mesh(POD[0], sizes), "cpu")
        mine = torch.tensor([1.0, float(rank)])
        out[f"group/{i}"] = collectives.psum(
            mine, collectives.axis_group(m, ("pod", "data"))).tolist()
        del m

    # the elastic path: save on 4 x 2, reshard onto 2 x 4 in memory
    mesh42 = bind_mesh(Mesh(("data", "model"), (4, 2)), "cpu")
    mesh24 = bind_mesh(Mesh(("data", "model"), (2, 4)), "cpu")
    tree = {k: torch.tensor(v) for k, v in _tree().items()}
    state = {k: Sharding(mesh42, TREE_SPECS[k]).distribute(v)
             for k, v in tree.items()}
    CheckpointManager(str(work / "ckpt_port")).save(1, state)
    moved = reshard_state(state, {k: Sharding(mesh24, s)
                                  for k, s in TREE_SPECS.items()})
    for k, v in moved.items():
        out[f"reshard/{k}"] = v.to_local().numpy()
        out[f"reshard/{k}/full_equal"] = bool(torch.equal(v.full_tensor(),
                                                          tree[k]))
        out[f"reshard/{k}/mesh"] = dict(zip(v.device_mesh.mesh_dim_names,
                                            v.device_mesh.shape))
    return out


def _worker4(rank, world, work):
    mesh = bind_mesh(Mesh(("data", "model"), (2, 2)), "cpu")
    targets = {k: Sharding(mesh, s) for k, s in TREE_SPECS.items()}
    out = {}
    for who in ("port", "reference"):
        state = CheckpointManager(str(work / f"ckpt_{who}")).restore(
            1, targets)
        for k, v in state.items():
            out[f"{who}/{k}"] = v.to_local().numpy()
            out[f"{who}/{k}/full"] = v.full_tensor().numpy()
            out[f"{who}/{k}/mesh"] = dict(zip(v.device_mesh.mesh_dim_names,
                                              v.device_mesh.shape))
        # a tree of DTensors as the target takes their meshes and dtypes
        again = CheckpointManager(str(work / f"ckpt_{who}")).restore(
            1, state)
        out[f"{who}/again_equal"] = all(
            torch.equal(again[k].to_local(), state[k].to_local())
            for k in state)
    return out


# ---------------------------------------------------------------------------
# The reference's side
# ---------------------------------------------------------------------------

REFERENCE = """
import json, numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P, AxisType
from repro.checkpoint import CheckpointManager
from repro.configs import smoke_config
from repro.models import lm
from repro.models.common import map_params
from repro.parallel.sharding import make_rules, param_shardings
from test_torch_mesh import ARCHS, POD, TREE_SPECS, _tree

names, sizes = POD
mesh = Mesh(np.array(jax.devices()).reshape(sizes), names,
            axis_types=(AxisType.Auto,) * 3)
rules = make_rules(fsdp=True, mesh=mesh)
blocks = {}
for arch in ARCHS:
    defs = lm.model_defs(smoke_config(arch))
    shapes = map_params(lambda p: jax.ShapeDtypeStruct(p.shape, jnp.float32),
                        defs)
    flat, _ = jax.tree_util.tree_flatten_with_path(
        param_shardings(defs, rules, mesh))
    sflat = jax.tree_util.tree_leaves(shapes)
    for (path, sh), s in zip(flat, sflat):
        idx = sh.devices_indices_map(s.shape)
        blocks[arch + jax.tree_util.keystr(path)] = [
            [[sl.start or 0, s.shape[d] if sl.stop is None else sl.stop]
             for d, sl in enumerate(idx[dev])] for dev in jax.devices()]
json.dump(blocks, open("blocks.json", "w"))

mesh8 = Mesh(np.array(jax.devices()).reshape(4, 2), ("data", "model"))
state8 = {k: jax.device_put(jnp.asarray(v),
                            NamedSharding(mesh8, P(*TREE_SPECS[k])))
          for k, v in _tree().items()}
CheckpointManager("ckpt_reference").save(1, state8)
print("REFERENCE_OK")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("mesh")
    procs = _torch_dist.start_reference(
        f"import sys; sys.path.insert(0, {str(_torch_dist.ROOT / 'tests')!r})"
        "\n" + REFERENCE, work)
    procs += _torch_dist.start_ranks(__file__, "w8", 8, work)
    _torch_dist.wait_all(procs, work)
    _torch_dist.wait_all(_torch_dist.start_ranks(__file__, "w4", 4, work),
                         work)
    ranks = {w: [torch.load(work / f"w{w}_{r}.pt", weights_only=False)
                 for r in range(w)] for w in (8, 4)}
    return json.loads((work / "blocks.json").read_text()), ranks


def _leaves(arch):
    return [(path, p.shape) for path, p in
            tree_paths(lm.model_defs(smoke_config(arch)))]


@pytest.mark.parametrize("arch", ARCHS)
def test_param_shardings_place_each_block_as_the_reference(runs, arch):
    blocks, ranks = runs
    for path, shape in _leaves(arch):
        key = arch + path
        full = _full(shape).numpy()
        for rank, r in enumerate(ranks[8]):
            want = full[tuple(slice(a, b) for a, b in blocks[key][rank])]
            np.testing.assert_array_equal(r[key], want, err_msg=f"{key} "
                                          f"rank {rank}")
            assert r[f"{key}/full_equal"], key


def test_fsdp_blocks_follow_the_reference_order_not_the_mesh_order(runs):
    """The fsdp rule ('data', 'pod') puts the pod index innermost: the
    rank at (pod 1, data 0) holds the second quarter of the fsdp dim."""
    blocks, ranks = runs
    wq = "yi-6b['layers']['attn']['wq']"  # (layers, fsdp, heads, head_dim)
    shape = dict(_leaves("yi-6b"))["['layers']['attn']['wq']"]
    fsdp_rows = shape[1] // 4
    rank = 4  # coordinates (pod 1, data 0, model 0)
    assert blocks[wq][rank][1] == [fsdp_rows, 2 * fsdp_rows]
    full = _full(shape).numpy()
    np.testing.assert_array_equal(
        ranks[8][rank][wq], full[:, fsdp_rows:2 * fsdp_rows, :shape[2] // 2])


def test_constrain(runs):
    _, ranks = runs
    x = _full((8, 6)).numpy()
    for rank, r in enumerate(ranks[8]):
        pod, data = rank // 4, (rank // 2) % 2
        assert r["constrain/plain"] and r["constrain/no_mesh"]
        # batch ('pod', 'data'): pod outermost
        i = pod * 2 + data
        np.testing.assert_array_equal(r["constrain/('batch', None)"],
                                      x[2 * i:2 * i + 2])
        # fsdp ('data', 'pod') on rows, heads ('model') on columns
        i, m = data * 2 + pod, rank % 2
        np.testing.assert_array_equal(r["constrain/('fsdp', 'heads')"],
                                      x[2 * i:2 * i + 2, 3 * m:3 * m + 3])
        assert "_StridedShard" in r["constrain/('fsdp', 'heads')/placements"]
        for dims in ("('batch', None)", "('fsdp', 'heads')"):
            assert r[f"constrain/{dims}/full_equal"]


def test_tuple_axis_groups_follow_each_mesh_layout(runs):
    """The ranks of a ('pod', 'data') group, one mesh after another of
    other shapes: each group is the ranks sharing this rank's model
    index in that mesh."""
    _, ranks = runs
    for i, sizes in enumerate(LAYOUTS):
        grid = np.arange(8).reshape(sizes)
        for rank, r in enumerate(ranks[8]):
            line = grid[..., rank % sizes[2]]
            assert r[f"group/{i}"] == [float(line.size),
                                       float(line.sum())], (sizes, rank)


def test_reshard_state_in_memory(runs):
    _, ranks = runs
    tree = _tree()
    for rank, r in enumerate(ranks[8]):
        data, model = rank // 4, rank % 4
        np.testing.assert_array_equal(
            r["reshard/w"], tree["w"][4 * data:4 * data + 4,
                                      2 * model:2 * model + 2])
        np.testing.assert_array_equal(r["reshard/b"],
                                      tree["b"][8 * data:8 * data + 8])
        assert r["reshard/w/full_equal"] and r["reshard/b/full_equal"]
        assert r["reshard/w/mesh"] == {"data": 2, "model": 4}


@pytest.mark.parametrize("who", ["port", "reference"])
def test_checkpoint_restores_onto_a_smaller_mesh(runs, who):
    _, ranks = runs
    tree = _tree()
    for rank, r in enumerate(ranks[4]):
        data, model = rank // 2, rank % 2
        for k, v in tree.items():
            np.testing.assert_array_equal(r[f"{who}/{k}/full"], v)
            assert r[f"{who}/{k}/mesh"] == {"data": 2, "model": 2}
        np.testing.assert_array_equal(
            r[f"{who}/w"], tree["w"][4 * data:4 * data + 4,
                                     4 * model:4 * model + 4])
        np.testing.assert_array_equal(r[f"{who}/b"],
                                      tree["b"][8 * data:8 * data + 8])
        assert r[f"{who}/again_equal"]


def test_bind_mesh_keeps_the_abstract_shape():
    m = Mesh(("data", "model"), (2, 4))
    bound = dataclasses.replace(m, device_mesh=object())
    assert bound == m and bound.shape == {"data": 2, "model": 4}
    assert make_rules(mesh=bound, with_pod=False).axis_size("vocab") == 4


if __name__ == "__main__":
    _torch_dist.worker_main({"w8": _worker8, "w4": _worker4})

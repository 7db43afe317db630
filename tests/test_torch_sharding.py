"""The port's sharding rules and mesh (``repro_torch.parallel.sharding``,
``repro_torch.launch.mesh``, ``launch.specs.rules_for``) against the
reference's ``repro.parallel.sharding`` and ``repro.launch.specs``.

Everything here is exact: the parameter declarations' paths, shapes and
logical dims for all ten configs at tp 1 and 16 (and at the smoke size);
the rules over the grid of ``make_rules``' keywords; ``rules_for`` for
every (arch x shape x mesh) cell, the reference's built on a
``jax.sharding.AbstractMesh``; which (config, tp, mesh, rules) pairs
``validate_divisibility`` refuses, with the same message; and
``shard_shape`` against ``NamedSharding.shard_shape``.
"""
import itertools
import types

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import (  # noqa: E402
    ALL_ARCH_NAMES, SHAPES, applicable_shapes, get_config, smoke_config)
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch.mesh import Mesh, make_production_mesh  # noqa: E402
from repro_torch.launch.specs import rules_for  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.common import Param, tree_paths  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "4x2": ((4, 2), ("data", "model")),
          "2x2x4": ((2, 2, 4), ("pod", "data", "model"))}


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    from jax.sharding import AbstractMesh, AxisType, NamedSharding
    from jax.sharding import PartitionSpec as P

    from repro import configs as jconfigs
    from repro.launch import specs as jspecs
    from repro.models import lm as jlm
    from repro.models.common import Param as JParam
    from repro.parallel import sharding as jsharding

    def mesh(name):
        shape, names = MESHES[name]
        return AbstractMesh(shape, names,
                            axis_types=(AxisType.Auto,) * len(names))

    return types.SimpleNamespace(
        jax=jax, NamedSharding=NamedSharding, P=P, configs=jconfigs,
        specs=jspecs, lm=jlm, JParam=JParam, sharding=jsharding, mesh=mesh)


def port_mesh(name):
    shape, names = MESHES[name]
    return Mesh(names, shape)


def ref_defs(jx, defs):
    flat, _ = jx.jax.tree_util.tree_flatten_with_path(
        defs, is_leaf=lambda x: isinstance(x, jx.JParam))
    return [(jx.jax.tree_util.keystr(path), p.shape, p.dims, p.init,
             p.scale) for path, p in flat]


def port_defs(defs):
    return [(path, p.shape, p.dims, p.init, p.scale)
            for path, p in tree_paths(defs)]


@pytest.mark.parametrize("tp", [1, 16])
@pytest.mark.parametrize("arch", ALL_ARCH_NAMES)
def test_model_defs_equal_the_reference(jx, arch, tp):
    want = ref_defs(jx, jx.lm.model_defs(jx.configs.get_config(arch), tp))
    assert port_defs(lm.model_defs(get_config(arch), tp)) == want
    if tp == 1:
        want = ref_defs(jx, jx.lm.model_defs(
            jx.configs.smoke_config(arch), 1))
        assert port_defs(lm.model_defs(smoke_config(arch), 1)) == want


def test_param_dims_must_match_the_shape():
    with pytest.raises(ValueError, match="differ in length"):
        Param((4, 8), ("d_model",))
    stacked = lm.model_defs(smoke_config("yi-6b"))["layers"]["attn"]["wq"]
    assert stacked.dims == ("layers", "fsdp", "heads", "head_dim")


KEYWORDS = dict(
    fsdp=[False, True],
    fsdp_mlp=[None, False, True],
    shard_kv_heads=[False, True],
    batch_axes=[("pod", "data"), ("data",), "data", ("pod",), None],
    cache_seq_axes=["model", ("data", "model"), ("pod", "data", "model")],
    cache_batch_axes=["data", ("pod", "data"), None],
)


@pytest.mark.parametrize("with_pod", [True, False])
def test_make_rules_equal_the_reference_over_the_keyword_grid(jx, with_pod):
    names = list(KEYWORDS)
    n = 0
    for values in itertools.product(*KEYWORDS.values()):
        kw = dict(zip(names, values), with_pod=with_pod)
        assert sharding.make_rules(**kw).rules == \
            jx.sharding.make_rules(**kw).rules, kw
        n += 1
    assert n == 540


RULE_CELLS = [(arch, sh.name, mesh) for mesh in ("16x16", "2x16x16")
              for arch in ALL_ARCH_NAMES
              for sh in applicable_shapes(get_config(arch))]


@pytest.mark.parametrize("arch,shape,mesh", RULE_CELLS,
                         ids=[f"{a}-{s}-{m}" for a, s, m in RULE_CELLS])
def test_rules_for_equals_the_reference(jx, arch, shape, mesh):
    want = jx.specs.rules_for(jx.configs.get_config(arch),
                              jx.configs.SHAPES[shape], jx.mesh(mesh))
    got = rules_for(get_config(arch), SHAPES[shape], port_mesh(mesh))
    assert got.rules == want.rules
    assert got.mesh.shape == dict(want.mesh.shape)
    for name in ("vocab", "experts", "batch", "heads"):
        assert got.axis_size(name) == want.axis_size(name)
    # and the param specs the rules give
    defs = lm.model_defs(get_config(arch), 16)
    jdefs = jx.lm.model_defs(jx.configs.get_config(arch), 16)
    specs = [spec for _, spec in tree_paths(sharding.param_specs(defs, got))]
    jspecs = jx.jax.tree_util.tree_leaves(
        jx.sharding.param_specs(jdefs, want),
        is_leaf=lambda x: isinstance(x, jx.P))
    assert specs == [tuple(s) for s in jspecs]


def _outcome(fn):
    try:
        fn()
    except (ValueError, AssertionError) as err:
        return str(err)
    return None


@pytest.mark.parametrize("mesh", list(MESHES))
def test_validate_divisibility_refuses_the_same_pairs(jx, mesh):
    with_pod = "pod" in MESHES[mesh][1]
    refused = 0
    for arch, fsdp in itertools.product(ALL_ARCH_NAMES, (False, True)):
        kw = dict(fsdp=fsdp, shard_kv_heads=fsdp, with_pod=with_pod)
        # the smoke configs' 4 heads do not pad to tp 16
        for jcfg, cfg, tp in (
                (jx.configs.get_config(arch), get_config(arch), 1),
                (jx.configs.get_config(arch), get_config(arch), 16),
                (jx.configs.smoke_config(arch), smoke_config(arch), 1)):
            want = _outcome(lambda: jx.sharding.validate_divisibility(
                jx.lm.model_defs(jcfg, tp), jx.sharding.make_rules(**kw),
                jx.mesh(mesh)))
            got = _outcome(lambda: sharding.validate_divisibility(
                lm.model_defs(cfg, tp), sharding.make_rules(**kw),
                port_mesh(mesh)))
            assert got == want, (arch, tp, fsdp)
            refused += want is not None
    assert refused > 0  # the grid holds configs that do not divide


SHARD_CASES = [
    ((64, 128), (None, "model")),
    ((64, 128), ("data", "model")),
    ((32, 48, 128), (("data", "pod"), None, "model")),
    ((32, 48, 128), (("pod", "data"), "model", None)),
    ((1024, 8, 4), (("pod", "data", "model"),)),
    ((2, 16), ("pod",)),
    ((), ()),
    ((48, 40), ("model", None)),     # 40 and 48: not over 16
    ((40,), ("model",)),
    ((30, 8), (("data", "pod"), None)),
]


@pytest.mark.parametrize("shape,spec", SHARD_CASES,
                         ids=[str(i) for i in range(len(SHARD_CASES))])
def test_shard_shape_matches_named_sharding(jx, shape, spec):
    for name in ("2x16x16", "2x2x4"):
        want = _outcome(lambda: tuple(jx.NamedSharding(
            jx.mesh(name), jx.P(*spec)).shard_shape(shape)))
        got = _outcome(lambda: sharding.shard_shape(shape, spec,
                                                    port_mesh(name)))
        if want is None:
            assert got is None
            assert sharding.shard_shape(shape, spec, port_mesh(name)) == \
                tuple(jx.NamedSharding(jx.mesh(name), jx.P(*spec))
                      .shard_shape(shape))
        else:
            assert got is not None, (name, shape, spec)


def test_production_meshes():
    one = make_production_mesh()
    two = make_production_mesh(multi_pod=True)
    assert one.shape == {"data": 16, "model": 16} and one.size == 256
    assert two.shape == {"pod": 2, "data": 16, "model": 16}
    assert two.axis_names == ("pod", "data", "model") and two.size == 512
    assert (one.name, two.name) == ("pod16x16", "pod2x16x16")
    assert mesh_mod.mesh_axes(two) == ("pod", "data", "model")
    assert mesh_mod.has_pod_axis(two) and not mesh_mod.has_pod_axis(one)
    assert one.devices == () and two.devices == ()


def test_host_mesh_counts_the_visible_cards():
    n = torch.cuda.device_count()
    with pytest.raises(RuntimeError, match=f"have {n}"):
        mesh_mod.make_host_mesh(n + 1, 1)
    if n:
        m = mesh_mod.make_host_mesh(1, 1)
        assert m.devices == ("cuda:0",) and m.shape == {"data": 1,
                                                        "model": 1}

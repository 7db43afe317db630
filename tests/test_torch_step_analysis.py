"""The dry run's per-device analysis (``launch.step_analysis``) against the
reference's HLO analysis (``repro.launch.hlo_analysis``).

The reference compiles each smoke cell on 8 fake CPU devices, its meshes
built as its own ``launch.mesh`` builds them (``AxisType.Auto``), and
reads ``loop_aware_flops`` and the collectives from the compiled text.
The port runs the same cell once as ``meta`` DTensors over a fake process
group of 8 ranks (``dryrun.analyze_per_device``) in a subprocess of its
own, with the 1 x 1 cells and yi-6b ``decode_32k`` at full size on both
production meshes; both sides run at once under one timeout
(``tests/_torch_dist.py``).

FLOPs: per-device dot FLOPs equal the reference's exactly, plus the
terms of ``test_torch_dryrun.port_minus_reference`` as they fall on one
rank (:func:`terms_on_one_rank`), in every cell on 4 x 2, 2 x 2 x 2 and
8 x 1.  Collectives: where DTensor and XLA pick other collectives for one
layout, the tests hold what both must move: the decode steps' wire bytes
a device, kind by kind; rwkv6-3b's serving collectives op for op; on a
data-only 8 x 1 mesh the gradients' all-reduce, 2·(g-1)/g of their bytes
on the wire on both sides; what Adafactor's factored update adds to
arctic-480b's step (its step less the same step with AdamW): the
reference's all-reduce payload, and all-gathers of at most the factored
moments' bytes.  PERF.md names the other differences.
"""
import dataclasses
import json
import math
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import _torch_dist  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.launch.step_analysis import (  # noqa: E402
    CollectiveOp, summarize_collectives)
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402
from test_torch_dryrun import (FLOP_CELLS, SMOKE_SHAPES,  # noqa: E402
                               port_minus_reference)

#: The smoke shapes, and a batch of 8 for the data-only 8 x 1 mesh.
SHAPES = {**SMOKE_SHAPES, "dp_train": ("train", 64, 8)}

#: mesh name → (axis names, sizes)
MESHES = {"4x2": (("data", "model"), (4, 2)),
          "2x2x2": (("pod", "data", "model"), (2, 2, 2)),
          "8x1": (("data", "model"), (8, 1))}
CASES = ([(a, n, "4x2") for a, n in FLOP_CELLS]
         + [(a, "smoke_train", "2x2x2") for a in
            ("yi-6b", "olmoe-1b-7b", "rwkv6-3b", "hymba-1.5b",
             "arctic-480b")]
         + [(a, n, "2x2x2") for a in ("yi-6b", "rwkv6-3b")
            for n in ("smoke_prefill", "smoke_decode")]
         + [("yi-6b", "dp_train", "8x1")])
#: Cells counted on a 1 x 1 mesh too (port side only).
ONE_CASES = [("yi-6b", "smoke_train"), ("olmoe-1b-7b", "smoke_prefill"),
             ("hymba-1.5b", "smoke_decode")]
DECODE = [(a, n, m) for a, n, m in CASES if n == "smoke_decode"]
#: arctic-480b's training (Adafactor) again with AdamW, on both sides:
#: the difference is what Adafactor's factored update moves.
ADAMW_MESHES = ("4x2", "2x2x2")
#: The reference's cells are compiled, and the port's counted, by this
#: many processes a side at once.
REFERENCE_PROCS = PORT_PROCS = 2


def terms_on_one_rank(cfg, b: int, s: int, mesh: str) -> int:
    """``port_minus_reference``'s terms as they fall on one rank: each is
    sharded over every device (the batch over the batch axes, heads, vocab
    and d_inner over the model axis), but the MoE combine's, which runs
    on each batch shard's tokens on every rank of the experts axis."""
    names, sizes = MESHES[mesh]
    chips = math.prod(sizes)
    dp = math.prod(n for a, n in zip(names, sizes) if a != "model")
    out = 0
    for name, flops in port_minus_reference(cfg, b, s).items():
        share = dp if name == "moe_combine_outer_product" else chips
        assert flops % share == 0, name
        out += flops // share
    return out


def _cfg(arch):
    cfg = smoke_config(arch)
    return (dataclasses.replace(cfg, prefill_chunk=32) if cfg.prefill_chunk
            else cfg)


REFERENCE = """
import dataclasses, json, sys
import numpy as np, jax
from jax.sharding import Mesh, AxisType
from repro.configs import smoke_config
from repro.configs.base import ShapeConfig
from repro.launch import hlo_analysis, specs
from test_torch_step_analysis import (ADAMW_MESHES, CASES, MESHES,
                                      REFERENCE_PROCS, SHAPES)


def cfg_of(arch):
    c = smoke_config(arch)
    return dataclasses.replace(c, prefill_chunk=32) if c.prefill_chunk else c


out = {}
saved = specs.get_config
for arch, name, mesh_name in CASES[PART::REFERENCE_PROCS]:
    kind, s, b = SHAPES[name]
    names, shape = MESHES[mesh_name]
    n = int(np.prod(shape))
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(shape), names,
                axis_types=(AxisType.Auto,) * len(names))
    specs.get_config = cfg_of
    specs.SHAPES[name] = ShapeConfig(name, s, b, kind)
    try:
        cell = specs.build_cell(arch, name, mesh, tp=1)
    finally:
        specs.get_config = saved
        specs.SHAPES.pop(name)
    with mesh:
        txt = jax.jit(cell.step_fn, in_shardings=cell.in_shardings,
                      donate_argnums=cell.donate).lower(
                          *cell.args_sds).compile().as_text()
    colls = hlo_analysis.collect_collectives(txt)
    out[f"{arch}/{name}/{mesh_name}"] = {
        "flops": hlo_analysis.loop_aware_flops(txt),
        "collectives": hlo_analysis.summarize_collectives(colls),
        "ops": [(c.kind, c.bytes_payload, c.group_size, c.multiplier)
                for c in colls]}
for mesh_name in ADAMW_MESHES if PART == 1 else ():
    names, shape = MESHES[mesh_name]
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(shape), names,
                axis_types=(AxisType.Auto,) * len(names))
    specs.get_config = lambda a: dataclasses.replace(cfg_of(a),
                                                     optimizer="adamw")
    specs.SHAPES["smoke_train"] = ShapeConfig("smoke_train", 64, 4, "train")
    try:
        cell = specs.build_cell("arctic-480b", "smoke_train", mesh, tp=1)
    finally:
        specs.get_config = saved
        specs.SHAPES.pop("smoke_train")
    with mesh:
        txt = jax.jit(cell.step_fn, in_shardings=cell.in_shardings,
                      donate_argnums=cell.donate).lower(
                          *cell.args_sds).compile().as_text()
    out[f"arctic-480b/smoke_train/{mesh_name}/adamw"] = {"ops": [
        (c.kind, c.bytes_payload, c.group_size, c.multiplier)
        for c in hlo_analysis.collect_collectives(txt)]}
json.dump(out, open(f"reference_{PART}.json", "w"))
print("REFERENCE_OK")
"""

PORT = """
import dataclasses, json
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.specs import build_cell
from test_torch_step_analysis import (ADAMW_MESHES, CASES, MESHES,
                                      ONE_CASES, PORT_PROCS, SHAPES, _cfg)


def shape(name):
    kind, s, b = SHAPES[name]
    return ShapeConfig(name, s, b, kind)


out = {}
for arch, name, mesh_name in CASES[PART::PORT_PROCS]:
    names, sizes = MESHES[mesh_name]
    out[f"{arch}/{name}/{mesh_name}"] = dryrun.analyze_per_device(
        arch, name, cfg=_cfg(arch), shape_cfg=shape(name), tp=1,
        mesh=Mesh(names, sizes))
one = Mesh(("data", "model"), (1, 1))
for arch, name in ONE_CASES if PART == 0 else ():
    res = dryrun.analyze_per_device(arch, name, cfg=_cfg(arch),
                                    shape_cfg=shape(name), tp=1, mesh=one)
    res["global"] = dryrun.count_flops(build_cell(
        arch, name, one, tp=1, device="meta", cfg=_cfg(arch),
        shape=shape(name)))
    out[f"{arch}/{name}/1x1"] = res
for multi_pod in (False, True) if PART == 1 else ():
    mesh = dryrun.make_production_mesh(multi_pod=multi_pod)
    res = dryrun.analyze_per_device("yi-6b", "decode_32k", multi_pod)
    res["global"] = dryrun.count_flops(build_cell(
        "yi-6b", "decode_32k", mesh, device="meta"))
    out[f"yi-6b/decode_32k/{mesh.name}"] = res
for mesh_name in ADAMW_MESHES if PART == 0 else ():
    names, sizes = MESHES[mesh_name]
    out[f"arctic-480b/smoke_train/{mesh_name}/adamw"] = \
        dryrun.analyze_per_device(
            "arctic-480b", "smoke_train", shape_cfg=shape("smoke_train"),
            cfg=dataclasses.replace(_cfg("arctic-480b"), optimizer="adamw"),
            tp=1, mesh=Mesh(names, sizes))
json.dump(out, open(f"port_{PART}.json", "w"))
print("PORT_OK")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    pytest.importorskip("jax")
    work = tmp_path_factory.mktemp("step_analysis")
    tests = str(_torch_dist.ROOT / "tests")
    head = f"import sys; sys.path.insert(0, {tests!r})\n"
    procs = []
    for part in range(REFERENCE_PROCS):
        procs += _torch_dist.start_reference(
            head + f"PART = {part}\n" + REFERENCE, work, f"reference_{part}")
    for part in range(PORT_PROCS):
        log = open(work / f"port_{part}.log", "w")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", head + f"PART = {part}\n" + PORT],
            stdout=log, stderr=subprocess.STDOUT, cwd=work,
            env=_torch_dist._env()))
    _torch_dist.wait_all(procs, work)
    ref, port = {}, {}
    for part in range(REFERENCE_PROCS):
        ref.update(json.loads((work / f"reference_{part}.json").read_text()))
    for part in range(PORT_PROCS):
        port.update(json.loads((work / f"port_{part}.json").read_text()))
    return ref, port


def test_wire_bytes_and_summary_equal_the_reference():
    from repro.launch import hlo_analysis

    ops = [("all-reduce", 4096, 8, 1.0), ("all-gather", 1000, 4, 3.0),
           ("reduce-scatter", 512, 2, 1.0), ("all-to-all", 96, 16, 2.0),
           ("collective-permute", 77, 2, 5.0), ("all-reduce", 8, 1, 1.0)]
    mine = [CollectiveOp(k, b, g, "c", m) for k, b, g, m in ops]
    theirs = [hlo_analysis.CollectiveOp(k, b, g, "c", m)
              for k, b, g, m in ops]
    assert [o.wire_bytes for o in mine] == [o.wire_bytes for o in theirs]
    assert summarize_collectives(mine) == \
        hlo_analysis.summarize_collectives(theirs)


@pytest.mark.parametrize("arch,name", ONE_CASES,
                         ids=[f"{a}-{n}" for a, n in ONE_CASES])
def test_one_by_one_equals_the_global_count(runs, arch, name):
    """At 1 x 1 every op is the whole op: the per-device count is the
    global one and no collective moves a byte."""
    got = runs[1][f"{arch}/{name}/1x1"]
    assert got["dot_flops_per_device"] == got["global"]
    assert all(op[2] == 1 for op in got["ops"])
    assert got["collective_wire_bytes_per_device"] == 0


@pytest.mark.parametrize("arch,name,mesh", CASES,
                         ids=[f"{a}-{n}-{m}" for a, n, m in CASES])
def test_per_device_flops_equal_the_reference(runs, arch, name, mesh):
    ref, port = runs
    key = f"{arch}/{name}/{mesh}"
    kind, s, b = SHAPES[name]
    want = ref[key]["flops"]
    if kind == "train":
        want += terms_on_one_rank(_cfg(arch), b, s, mesh)
    assert port[key]["dot_flops_per_device"] == want


def _moved(ops):
    """``summarize_collectives`` of the ops that cross a wire: a
    collective-permute, or any op over more than one device."""
    return summarize_collectives([
        CollectiveOp(op[0], op[1], op[2], "c", op[3] if len(op) > 3 else 1.0)
        for op in ops if op[2] > 1 or op[0] == "collective-permute"])


@pytest.mark.parametrize("arch,name,mesh", DECODE,
                         ids=[f"{a}-{n}-{m}" for a, n, m in DECODE])
def test_decode_collectives_move_the_reference_bytes(runs, arch, name, mesh):
    """The decode step: all-reduces move the reference's wire bytes (XLA
    sums the attention's weighted values over the sequence axes in two
    stages, the port in one), all-gathers are the reference's by count,
    payload and wire (hymba: plus the two halves of its Mamba input
    projection, which XLA swaps by collective-permute), and the total wire
    bytes a device are equal."""
    ref, port = runs
    key = f"{arch}/{name}/{mesh}"
    r, p = _moved(ref[key]["ops"]), _moved(port[key]["ops"])
    assert p["all-reduce"]["wire"] == r["all-reduce"]["wire"]
    if "collective-permute" in r:
        assert p["all-gather"]["wire"] == (r["all-gather"]["wire"]
                                           + r["collective-permute"]["wire"])
    else:
        assert p["all-gather"] == r["all-gather"]
    assert port[key]["collective_wire_bytes_per_device"] == sum(
        v["wire"] for v in r.values())


@pytest.mark.parametrize("name", ["smoke_prefill", "smoke_decode"])
@pytest.mark.parametrize("mesh", ["4x2", "2x2x2"])
def test_rwkv6_serving_collectives_are_the_reference(runs, name, mesh):
    """rwkv6-3b's prefill and decode issue the reference's collectives:
    kind by kind, the same count, payload and wire bytes."""
    ref, port = runs
    key = f"rwkv6-3b/{name}/{mesh}"
    assert _moved(port[key]["ops"]) == _moved(ref[key]["ops"])


def test_data_parallel_gradient_reduction_moves_the_ring_bytes(runs):
    """On a data-only 8 x 1 mesh the only collectives are all-reduces over
    the 8 ranks: one of each parameter's float32 gradient and one of the
    loss's two sums, 2·7/8 of their bytes on the wire.  XLA combines them
    into three; the bytes, payload and wire, are the reference's."""
    ref, port = runs
    key = "yi-6b/dp_train/8x1"
    r, p = _moved(ref[key]["ops"]), _moved(port[key]["ops"])
    assert set(p) == set(r) == {"all-reduce"}
    assert p["all-reduce"]["payload"] == r["all-reduce"]["payload"]
    assert p["all-reduce"]["wire"] == pytest.approx(
        r["all-reduce"]["wire"], rel=1e-12)
    assert p["all-reduce"]["wire"] == pytest.approx(
        2 * 7 / 8 * p["all-reduce"]["payload"], rel=1e-12)
    leaves = sorted(4 * math.prod(x.shape) for x in tree_leaves(
        lm.model_defs(_cfg("yi-6b"), 1)))
    assert sorted(op[1] for op in port[key]["ops"]) == sorted(leaves + [8])


def _factored_bytes(cfg) -> int:
    """The float32 bytes of Adafactor's factored moments (``vr`` and
    ``vc``) of the smoke model's parameters."""
    from repro_torch.optim.optimizers import OptimizerConfig

    th = OptimizerConfig().factored_threshold
    out = 0
    for p in tree_leaves(lm.model_defs(cfg, 1)):
        s = p.shape
        if len(s) >= 2 and s[-1] >= th and s[-2] >= th:
            out += 4 * (math.prod(s[:-1]) + math.prod(s[:-2]) * s[-1])
    return out


@pytest.mark.parametrize("mesh", ADAMW_MESHES)
def test_adafactor_update_moves_its_moments_not_its_parameters(runs, mesh):
    """arctic-480b's step with Adafactor less the same step with AdamW, on
    each side, is what the factored update moves.  Its all-reduces (the
    row means of a gradient sharded along its rows' dims, the update's
    RMS of each sharded leaf) carry the reference's payload; its
    all-gathers and reduce-scatters (the factored moments laid out as
    the gradient) move at most the moments' bytes: no tensor the size of
    a parameter is gathered."""
    ref, port = runs
    key = f"arctic-480b/smoke_train/{mesh}"

    def delta(side, kind):
        def tot(ops):
            return sum(op[1] * (op[3] if len(op) > 3 else 1.0) for op in ops
                       if op[0] == kind and op[2] > 1)
        return tot(side[key]["ops"]) - tot(side[key + "/adamw"]["ops"])

    assert delta(port, "all-reduce") == delta(ref, "all-reduce") > 0
    moved = delta(port, "all-gather") + delta(port, "reduce-scatter")
    assert 0 < moved <= _factored_bytes(_cfg("arctic-480b"))


@pytest.mark.parametrize("mesh", ["pod16x16", "pod2x16x16"])
def test_full_size_decode_cell_has_every_field(runs, mesh):
    """yi-6b ``decode_32k`` at full size on the production mesh: the three
    fields are there, and a device does at least its share of the global
    FLOPs and at most all of them."""
    res = runs[1][f"yi-6b/decode_32k/{mesh}"]
    chips = 512 if mesh == "pod2x16x16" else 256
    per, glob = res["dot_flops_per_device"], res["global"]
    assert glob / chips <= per <= glob
    assert set(res["collectives"]) >= {"all-gather", "all-reduce"}
    assert res["collective_wire_bytes_per_device"] == pytest.approx(
        sum(v["wire"] for v in res["collectives"].values()))

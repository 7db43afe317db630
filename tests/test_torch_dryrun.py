"""The port's dry run (``repro_torch.launch.dryrun``) against the reference's.

Bytes: for all 64 (arch x shape x mesh) cells on the 16 x 16 and
2 x 16 x 16 production meshes, every argument leaf of the port's cell
(``launch.specs.build_cell`` on ``meta`` tensors) has the per-device block
and dtype of the reference's (``repro.launch.specs.build_cell`` on a
``jax.sharding.AbstractMesh``, each leaf's ``NamedSharding.shard_shape``),
in the same order, so the per-device argument bytes are equal exactly,
group by group.  No device is faked and nothing is lowered.

FLOPs: at smoke configs on one device, the port's step counted on
``meta`` tensors under ``FlopCounterMode`` (``impl='ref'``) against the
reference's step compiled on a 1 x 1 mesh and counted by
``hlo_analysis.loop_aware_flops``.  Prefill and decode are equal exactly.
Training is the reference's count plus the terms of
:func:`port_minus_reference`, each a formula of the config, exactly.
arctic-480b's ``prefill_chunk`` is cut to 32 on both sides so a 64-token
prompt runs two chunks.
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

from repro_torch.configs import (  # noqa: E402
    ALL_ARCH_NAMES, applicable_shapes, get_config, smoke_config)
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import Mesh, make_production_mesh  # noqa: E402
from repro_torch.launch.specs import build_cell  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402
from repro_torch.models.mamba import mamba_dims  # noqa: E402
from repro_torch.models.rwkv6 import HEAD_DIM, rwkv_heads  # noqa: E402
from repro_torch.optim import OptimizerConfig, make_optimizer  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CELLS = [(arch, sh.name, mp) for mp in (False, True)
         for arch in ALL_ARCH_NAMES
         for sh in applicable_shapes(get_config(arch))]
ONE = Mesh(("data", "model"), (1, 1))
#: The smoke shapes of the FLOP check: (kind, seq, batch).  Training's
#: batch of 4 runs in 2 microbatches on one device, as the reference's.
SMOKE_SHAPES = {"smoke_train": ("train", 64, 4),
                "smoke_prefill": ("prefill", 64, 2),
                "smoke_decode": ("decode", 64, 2),
                "variant_train": ("train", 32, 8)}
FLOP_CELLS = [(arch, name) for arch in ALL_ARCH_NAMES
              for name, (kind, _, _) in SMOKE_SHAPES.items()
              if name != "variant_train"
              and (kind != "decode" or get_config(arch).causal)]
#: Another size for the two families with the most terms: 3 layers,
#: d_model 192, b 8 of s 32 in 4 microbatches.
VARIANTS = {"rwkv6-3b": dict(n_layers=3, d_model=192, n_heads=3,
                             n_kv_heads=3, d_ff=80, vocab=320),
            "hymba-1.5b": dict(n_layers=3, d_model=192, n_heads=6,
                               n_kv_heads=2, d_ff=80, vocab=320,
                               ssm_state=8)}


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    from jax.sharding import AbstractMesh, AxisType, NamedSharding

    from repro.configs import smoke_config as jsmoke
    from repro.configs.base import ShapeConfig as JShape
    from repro.launch import hlo_analysis
    from repro.launch import specs as jspecs

    def mesh(multi_pod):
        shape = (2, 16, 16) if multi_pod else (16, 16)
        names = ("pod", "data", "model") if multi_pod else ("data", "model")
        return AbstractMesh(shape, names,
                            axis_types=(AxisType.Auto,) * len(names))

    return types.SimpleNamespace(
        jax=jax, NamedSharding=NamedSharding, specs=jspecs, smoke=jsmoke,
        JShape=JShape, hlo=hlo_analysis, mesh=mesh)


def reference_leaves(jx, cell):
    """[(path, per-device shape, dtype)] of a reference cell's arguments,
    the oracle: ``NamedSharding.shard_shape`` of every leaf."""
    out = []
    for arg, shd in zip(cell.args_sds, cell.in_shardings):
        flat, _ = jx.jax.tree_util.tree_flatten_with_path(arg)
        shds = jx.jax.tree_util.tree_leaves(
            shd, is_leaf=lambda x: isinstance(x, jx.NamedSharding))
        assert len(flat) == len(shds)
        for (path, leaf), s in zip(flat, shds):
            out.append((jx.jax.tree_util.keystr(path),
                        tuple(s.shard_shape(leaf.shape)),
                        np.dtype(leaf.dtype).name))
    return out


@pytest.mark.parametrize("arch,shape,multi_pod", CELLS,
                         ids=[f"{a}-{s}-{'2x16x16' if m else '16x16'}"
                              for a, s, m in CELLS])
def test_per_device_bytes_equal_the_reference(jx, arch, shape, multi_pod):
    want = reference_leaves(
        jx, jx.specs.build_cell(arch, shape, jx.mesh(multi_pod), tp=16))
    cell = build_cell(arch, shape, make_production_mesh(multi_pod=multi_pod),
                      tp=16, device="meta")
    recs = dryrun.leaf_records(cell)
    assert [(r["path"], r["shard_shape"], r["dtype"]) for r in recs] == want
    assert all(t.device.type == "meta" for arg in cell.args
               for t in tree_leaves(arg))
    # the groups: the reference's argument order, leaf counts per group
    sizes = [len(tree_leaves(a)) for a in cell.args]
    ref_sizes = [len(jx.jax.tree_util.tree_leaves(a))
                 for a in jx.specs.build_cell(
                     arch, shape, jx.mesh(multi_pod), tp=16).args_sds]
    assert sizes == ref_sizes
    by = dryrun.argument_bytes(cell)
    total = sum(int(np.prod(s)) * np.dtype(dt).itemsize
                for _, s, dt in want)
    assert by["total"] == total
    start = 0
    for group, n in zip(cell.groups, sizes):
        part = want[start:start + n]
        start += n
        assert by[group] == sum(int(np.prod(s)) * np.dtype(dt).itemsize
                                for _, s, dt in part), group


def test_named_cells_hold_the_bytes_the_reference_reports():
    """Three cells' totals, as ``PERF.md`` quotes them."""
    def total(arch, shape, multi_pod):
        cell = build_cell(arch, shape,
                          make_production_mesh(multi_pod=multi_pod),
                          device="meta")
        return dryrun.argument_bytes(cell)["total"]

    assert total("yi-6b", "train_4k", False) == 4_851_548_164
    assert total("qwen1.5-32b", "decode_32k", False) == 16_175_450_148
    assert total("arctic-480b", "train_4k", False) == 7_776_079_364
    assert total("arctic-480b", "train_4k", True) == 4_021_072_068


def test_arctic_adafactor_and_qwen_w8a16_structs():
    """arctic-480b at full size: Adafactor's factored slots are float32
    rows and columns, its first moment bf16; qwen1.5-32b serves w8a16 MLP
    weights whose scales drop the contracted dim's axis."""
    mesh = make_production_mesh()
    cell = build_cell("arctic-480b", "train_4k", mesh, device="meta")
    recs = {(r["group"], r["path"]): r for r in dryrun.leaf_records(cell)}
    up = "['layers']['moe']['w_up']"
    p = recs[("params", up)]
    vr = recs[("opt_state", up + "['vr']")]
    vc = recs[("opt_state", up + "['vc']")]
    m = recs[("opt_state", up + "['m']")]
    assert vr["shape"] == p["shape"][:-1] and vr["dtype"] == "float32"
    assert vc["shape"] == p["shape"][:-2] + p["shape"][-1:]
    assert m["dtype"] == "bfloat16" and m["shard_shape"] == p["shard_shape"]
    cell = build_cell("qwen1.5-32b", "decode_32k", mesh, device="meta")
    recs = {r["path"]: r for r in dryrun.leaf_records(cell)
            if r["group"] == "params"}
    q = recs["['layers']['mlp']['w_up']['q']"]
    s = recs["['layers']['mlp']['w_up']['scale']"]
    assert q["dtype"] == "int8" and s["dtype"] == "float32"
    assert s["shape"] == q["shape"][:-2] + (1,) + q["shape"][-1:]
    assert s["shard_shape"][-2] == 1 and (
        s["shard_shape"][-1] == q["shard_shape"][-1])


@pytest.mark.parametrize("arch", ["yi-6b", "olmoe-1b-7b", "arctic-480b"])
def test_world_size_one_bytes_equal_the_allocated_trees(arch):
    """On a 1 x 1 mesh the params plus optimizer state of a training cell
    are the ``nbytes`` of the trees ``init_model`` and the optimizer's
    ``init`` allocate (here on the CPU, at the smoke size)."""
    cfg = smoke_config(arch)
    cell = build_cell(arch, "train_4k", ONE, tp=1, device="meta",
                      cfg=cfg)
    by = dryrun.argument_bytes(cell)
    params = lm.init_model(cfg, seed=0, device="cpu")
    opt = make_optimizer(OptimizerConfig(name=cfg.optimizer)).init(params)
    nbytes = lambda tree: sum(t.nbytes for t in tree_leaves(tree))  # noqa
    assert by["params"] == nbytes(params)
    assert by["opt_state"] == nbytes(opt)


def port_minus_reference(cfg, b: int, s: int) -> dict:
    """The port's training dot FLOPs over the reference's, by source, for
    one step of ``b`` sequences of ``s`` tokens (tp = 1); n = b·s.

    * logits: the loss's checkpointed chunk recomputes ``x @ w_out`` in
      the backward (XLA drops the reference's recompute): 2·n·D·V.
    * attention_scores: the flash backward recomputes S = QKᵀ from the
      saved log-sum-exp, as the kernel does: 2·b·s²·H·hd a layer.
    * wkv_chunk_recompute: rwkv6's checkpointed chunk runs its state
      product and bonus again: 2·n·H·hd² + 2·n·H·hd a layer.
    * outer products, which torch runs as a batched product with a
      contracted dim of 1 and counts, where XLA multiplies elementwise:
      rwkv6's gradient of the state read (2·n·H·hd² a layer), the MoE
      combine's gradient of its rows (2·n·D·top_k a layer).
    * hymba: the port's scan backward recomputes C·h and reduces dB over
      d_inner as a product (2·2·n·d_inner·N a layer), while the
      reference's checkpointed chunk recomputes its x and Δ projections
      (2·n·d_inner·(r + 2N) + 2·n·r·d_inner a layer), which the port
      keeps.
    """
    n, d, l = b * s, cfg.d_model, cfg.n_layers
    terms = {"logits": 2 * n * d * cfg.vocab_padded(1)}
    if cfg.ssm == "rwkv6":
        h = rwkv_heads(cfg)
        terms["wkv_chunk_recompute"] = l * (2 * n * h * HEAD_DIM ** 2
                                            + 2 * n * h * HEAD_DIM)
        terms["wkv_state_outer_product"] = l * 2 * n * h * HEAD_DIM ** 2
        return terms
    q_heads, _ = cfg.heads_for_tp(1)
    terms["attention_scores"] = l * 2 * b * s * s * q_heads * cfg.hd
    if cfg.ssm == "hymba":
        di, r, st = mamba_dims(cfg)
        terms["scan_backward"] = l * 2 * (2 * n * di * st)
        terms["reference_chunk_recompute"] = -l * (
            2 * n * di * (r + 2 * st) + 2 * n * r * di)
    if cfg.n_experts:
        terms["moe_combine_outer_product"] = l * 2 * n * d * cfg.top_k
    return terms


def _smoke(smoke_fn, arch):
    cfg = smoke_fn(arch)
    return (dataclasses.replace(cfg, prefill_chunk=32) if cfg.prefill_chunk
            else cfg)


@pytest.fixture(scope="module")
def jflops(jx):
    """The reference's ``loop_aware_flops`` of a smoke cell, compiled on a
    1 x 1 mesh (``specs.get_config`` and ``specs.SHAPES`` patched while
    the cell is built, then restored)."""
    specs = jx.specs
    mesh = jx.jax.make_mesh((1, 1), ("data", "model"))

    def count(arch, name, **repl):
        kind, s, b = SMOKE_SHAPES[name]
        saved = specs.get_config
        specs.get_config = lambda a: dataclasses.replace(
            _smoke(jx.smoke, a), **repl)
        specs.SHAPES[name] = jx.JShape(name, s, b, kind)
        try:
            cell = specs.build_cell(arch, name, mesh, tp=1)
        finally:
            specs.get_config = saved
            specs.SHAPES.pop(name)
        with mesh:
            compiled = jx.jax.jit(
                cell.step_fn, in_shardings=cell.in_shardings,
                donate_argnums=cell.donate).lower(*cell.args_sds).compile()
        return int(jx.hlo.loop_aware_flops(compiled.as_text()))

    return count


@pytest.mark.parametrize("arch,name", FLOP_CELLS,
                         ids=[f"{a}-{n}" for a, n in FLOP_CELLS])
def test_dot_flops_equal_the_reference(jflops, arch, name):
    kind, s, b = SMOKE_SHAPES[name]
    cfg = _smoke(smoke_config, arch)
    cell = build_cell(arch, name, ONE, tp=1, device="meta",
                      cfg=cfg, shape=ShapeConfig(name, s, b, kind))
    got = dryrun.count_flops(cell)
    want = jflops(arch, name)
    if kind == "train":
        assert cell.grad_accum == 2
        want += sum(port_minus_reference(cfg, b, s).values())
    assert got == want


@pytest.mark.parametrize("arch", list(VARIANTS))
def test_training_terms_hold_at_another_size(jflops, arch):
    repl = VARIANTS[arch]
    kind, s, b = SMOKE_SHAPES["variant_train"]
    cfg = dataclasses.replace(_smoke(smoke_config, arch), **repl)
    cell = build_cell(arch, "variant_train", ONE, tp=1, device="meta",
                      cfg=cfg,
                      shape=ShapeConfig("variant_train", s, b, kind))
    assert cell.grad_accum == 4
    want = jflops(arch, "variant_train", **repl)
    assert dryrun.count_flops(cell) == want + sum(
        port_minus_reference(cfg, b, s).values())


def test_yi_smoke_training_gap_is_logits_and_scores():
    """yi-6b at its smoke size (b 4, s 64): the gap of 25,165,824 is one
    logits product and one QKᵀ a layer."""
    terms = port_minus_reference(smoke_config("yi-6b"), 4, 64)
    assert terms == {"logits": 2 * 256 * 128 * 256,
                     "attention_scores": 2 * 4_194_304}
    assert sum(terms.values()) == 25_165_824


def test_dryrun_cli_writes_a_record(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "yi-6b", "--shape", "decode_32k", "--both-meshes", "--out-dir",
         str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "ALL CELLS PASSED" in res.stdout
    assert "flops/dev=" in res.stdout and "coll=" in res.stdout
    recs = {p.name: json.loads(p.read_text())
            for p in sorted(tmp_path.glob("*.json"))}
    assert set(recs) == {"yi-6b__decode_32k__pod16x16.json",
                         "yi-6b__decode_32k__pod2x16x16.json"}
    rec = recs["yi-6b__decode_32k__pod16x16.json"]
    mem = rec["memory"]
    assert mem["argument_bytes"] == 5_103_427_620
    assert sum(mem["by_group"].values()) == mem["argument_bytes"]
    assert set(mem["by_group"]) == {"params", "tokens", "cache", "scalars"}
    assert rec["dot_flops_global"] > 0 and rec["chips"] == 256
    assert rec["temp_bytes"] is None
    per = rec["dot_flops_per_device"]
    assert rec["dot_flops_global"] / 256 <= per <= rec["dot_flops_global"]
    assert {"all-gather", "all-reduce"} <= set(rec["collectives"])
    assert rec["collective_wire_bytes_per_device"] == sum(
        v["wire"] for v in rec["collectives"].values()) > 0
    assert set(rec["not_measured"]) == {"temp_bytes"}
    if not torch.cuda.is_available():
        assert rec["card"] is None and rec["fits"] is None


def test_dryrun_cli_no_hlo_skips_the_flop_count(tmp_path):
    rec = dryrun.run_cell("arctic-480b", "train_4k", multi_pod=True,
                          flops=False, out_dir=tmp_path)
    assert rec["dot_flops_global"] is None
    assert "dot_flops_global" in rec["not_measured"]
    assert rec["memory"]["argument_bytes"] == 4_021_072_068
    assert Path(rec["artifact"]).parent == tmp_path
    # the dry run made no process group
    assert not (torch.distributed.is_available()
                and torch.distributed.is_initialized())


def test_build_cell_defaults_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="GPU"):
        build_cell("yi-6b", "decode_32k", ONE, tp=1,
                   cfg=smoke_config("yi-6b"))

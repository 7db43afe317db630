"""Dry-run cells: every model input of an (arch x shape x mesh) cell as
``meta`` tensors, with its sharding spec (from ``repro.launch.specs``).

A ``meta`` tensor has a shape and a dtype and no storage, so a 480B model
is built in milliseconds on any host; it stands where the reference has a
``ShapeDtypeStruct``, and a spec tuple (one mesh-axis entry per dim) where
it has a ``NamedSharding``.  :func:`build_cell` gives the step function,
its arguments, their specs and the group of each argument (``params``,
``opt_state``, ``batch``/``tokens``, ``cache``, ``scalars``); the dry run
(:mod:`.dryrun`) sums each argument's per-device block and runs the step
once on the meta tensors to count its FLOPs.

Training keeps ``cfg.param_dtype`` and the config's optimizer state,
which mirrors the parameter sharding leaf by leaf (Adafactor's factored
rows and columns keep the axes that still divide); serving casts the
weights to ``cfg.compute_dtype`` and, for ``serve_mlp_int8``, stores the
MLP weights as int8 codes with float32 scales.  The reference's
``REPRO_GRAD_ACCUM`` override of the microbatch count is left out.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..configs import get_config
from ..configs.base import SHAPES, ArchConfig, ShapeConfig
from ..device import resolve_device
from ..models import lm
from ..models.common import map_tree
from ..optim import OptimizerConfig, make_optimizer
from ..parallel.sharding import (ShardingRules, make_rules, mesh_axis_size,
                                 param_specs)
from ..train import make_train_step

__all__ = [
    "Cell",
    "batch_specs",
    "build_cell",
    "cache_structs",
    "dtensor_args",
    "opt_specs",
    "param_structs",
    "rules_for",
]


def rules_for(cfg: ArchConfig, shape: ShapeConfig, mesh) -> ShardingRules:
    """Shape-kind-aware rules, the reference's.

    Training shards kv heads where the config allows and the weights'
    d_model under ``cfg.fsdp``.  Decode and prefill shard the KV cache over
    sequence (``'model'``) and keep kv heads whole; a batch smaller than
    the data axes (``long_500k``) is left whole and the cache sequence
    sharded over every axis.  Serving weights go model-only, but the MLP's
    keep the data-axis shard where model-only bf16 weights would pass 3 GB
    a device (and w8a16 does not apply).
    """
    with_pod = "pod" in mesh.axis_names
    batch_axes: Any = ("pod", "data") if with_pod else ("data",)
    cache_seq: Any = "model"
    cache_batch: Any = ("pod", "data") if with_pod else "data"
    if shape.kind == "train":
        return make_rules(fsdp=cfg.fsdp, shard_kv_heads=cfg.shard_kv_heads,
                          batch_axes=batch_axes, with_pod=with_pod,
                          mesh=mesh)
    if shape.global_batch % mesh_axis_size(mesh, batch_axes):
        batch_axes = None
        cache_batch = None
        cache_seq = ("pod", "data", "model") if with_pod else ("data",
                                                                "model")
    serving_fsdp_mlp = (cfg.fsdp and not cfg.serve_mlp_int8
                        and cfg.param_count() * 2 / 16 > 3e9)
    return make_rules(fsdp=False, fsdp_mlp=serving_fsdp_mlp,
                      shard_kv_heads=False, batch_axes=batch_axes,
                      cache_seq_axes=cache_seq, cache_batch_axes=cache_batch,
                      with_pod=with_pod, mesh=mesh)


def batch_specs(cfg: ArchConfig, shape: ShapeConfig, rules: ShardingRules,
                device) -> Tuple[Dict[str, torch.Tensor], Dict[str, tuple]]:
    """The train or prefill batch on ``device`` and its specs: tokens
    (an audio model has frames instead, a vision model its patches beside
    the text), and for training targets and mask."""
    b, s = shape.global_batch, shape.seq_len
    dev = resolve_device(device)
    bspec = rules.spec(("batch", "seq"))
    tensors: Dict[str, torch.Tensor] = {}
    specs: Dict[str, tuple] = {}

    def add(name, shape_, dtype, spec):
        tensors[name] = torch.empty(shape_, dtype=dtype, device=dev)
        specs[name] = spec

    if cfg.modality == "audio":
        add("frontend", (b, s, cfg.frontend_dim), torch.float32,
            rules.spec(("batch", "seq", None)))
    else:
        s_text = s - (cfg.frontend_len if cfg.modality == "vlm" else 0)
        add("tokens", (b, s_text), torch.int32, bspec)
        if cfg.modality == "vlm":
            add("frontend", (b, cfg.frontend_len, cfg.frontend_dim),
                torch.float32, rules.spec(("batch", None, None)))
    if shape.kind == "train":
        add("targets", (b, s), torch.int32, bspec)
        add("mask", (b, s), torch.float32, bspec)
    return tensors, specs


def param_structs(cfg: ArchConfig, rules: ShardingRules, tp: int, device,
                  serving: bool = False):
    """(tensor tree, spec tree) of the parameters: ``cfg.param_dtype``
    for training, ``cfg.compute_dtype`` for serving (inference weights are
    cast once at load)."""
    dev = resolve_device(device)
    dtype = cfg.compute_dtype if serving else cfg.param_torch_dtype
    defs = lm.model_defs(cfg, tp)
    tensors = map_tree(
        lambda p: torch.empty(p.shape, dtype=dtype, device=dev), defs)
    return tensors, param_specs(defs, rules)


def cache_structs(cfg: ArchConfig, shape: ShapeConfig, rules: ShardingRules,
                  tp: int, device):
    """(tensor tree, spec tree) of the cache of ``shape``'s batch and
    length."""
    cache = lm.init_cache(cfg, shape.global_batch, shape.seq_len,
                          device=device, tp=tp)
    return cache, map_tree(rules.spec, lm.cache_dims_tree(cfg))


def opt_specs(opt_state, p_specs, mesh):
    """The optimizer state's specs, leaf by leaf: a slot of its
    parameter's shape takes the parameter's spec; a factored slot
    (Adafactor's ``vr`` / ``vc``) keeps the prefix of it whose axes still
    divide (the reference's rule, which reads the spec's leading entries
    even where a factored slot dropped a middle dim)."""
    def build(o_sub, p_sub):
        if isinstance(o_sub, dict) and set(o_sub) <= {"m", "v", "vr", "vc"}:
            return {k: (_compatible_spec(v, p_sub, mesh) if torch.is_tensor(v)
                        else build(v, p_sub))
                    for k, v in o_sub.items()}
        if isinstance(o_sub, dict):
            return {k: build(v, p_sub[k] if isinstance(p_sub, dict)
                             else p_sub)
                    for k, v in o_sub.items()}
        return p_sub

    return build(opt_state, p_specs)


def _compatible_spec(slot: torch.Tensor, p_spec, mesh) -> tuple:
    if not isinstance(p_spec, tuple):
        return ()
    nd = slot.dim()
    if len(p_spec) == nd:
        return p_spec
    out = []
    for size, ax in zip(slot.shape, list(p_spec[:nd])
                        + [None] * (nd - len(p_spec[:nd]))):
        out.append(ax if size % max(mesh_axis_size(mesh, ax), 1) == 0
                   else None)
    return tuple(out)


@dataclasses.dataclass
class Cell:
    """One dry-run cell: the step, its arguments, their specs and groups.

    ``step_fn`` takes the arguments in order; a ``scalars`` argument (the
    training step's index, the decode position) is a 0-dim int32 tensor in
    ``args`` for its bytes and a Python int when the step runs.  The step
    runs the plain path (``impl='ref'``), which runs on any device."""

    arch: str
    shape: str
    mesh: Any
    step_fn: Callable
    args: Tuple
    specs: Tuple
    groups: Tuple[str, ...]
    grad_accum: int = 1


def build_cell(arch: str, shape_name: str, mesh, tp: int = 16, *,
               device=None, cfg: Optional[ArchConfig] = None,
               shape: Optional[ShapeConfig] = None) -> Cell:
    """The cell of ``arch`` (or ``cfg``) at ``shape_name`` (or ``shape``)
    on ``mesh``, its tensors on ``device`` (``None``: the GPU; the dry run
    names ``'meta'``).  A training step runs in microbatches such that a
    device holds at most 2 sequences of activations at a time."""
    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    dev = resolve_device(device)
    rules = rules_for(cfg, shape, mesh)
    scalar = torch.empty((), dtype=torch.int32, device=dev)

    if shape.kind == "train":
        p, p_spec = param_structs(cfg, rules, tp, dev)
        opt = make_optimizer(OptimizerConfig(name=cfg.optimizer))
        o = opt.init(p)
        o_spec = opt_specs(o, p_spec, mesh)
        b, b_spec = batch_specs(cfg, shape, rules, dev)
        dp = math.prod(mesh.shape[a] for a in ("pod", "data")
                       if a in mesh.axis_names)
        accum = max(1, max(1, shape.global_batch // dp) // 2)
        step = make_train_step(cfg, opt, grad_accum=accum, impl="ref",
                               rules=rules)
        return Cell(arch, shape_name, mesh, step, (p, o, b, scalar),
                    (p_spec, o_spec, b_spec, ()),
                    ("params", "opt_state", "batch", "scalars"),
                    grad_accum=accum)

    p, p_spec = param_structs(cfg, rules, tp, dev, serving=True)
    if cfg.serve_mlp_int8:
        p, p_spec = lm.quantize_mlp_structs(p, p_spec)
    c, c_spec = cache_structs(cfg, shape, rules, tp, dev)

    if shape.kind == "prefill":
        b, b_spec = batch_specs(cfg, shape, rules, dev)

        def prefill_step(params, batch, cache):
            if cfg.prefill_chunk:
                return lm.prefill_chunked(params, batch, cache, cfg,
                                          cfg.prefill_chunk, impl="ref",
                                          rules=rules)
            return lm.prefill(params, batch, cache, cfg, impl="ref",
                              rules=rules)

        return Cell(arch, shape_name, mesh, prefill_step, (p, b, c),
                    (p_spec, b_spec, c_spec), ("params", "batch", "cache"))

    tokens = torch.empty((shape.global_batch, 1), dtype=torch.int32,
                         device=dev)

    def decode(params, tokens, cache, pos):
        return lm.decode_step(params, tokens, cache, pos, cfg, impl="ref",
                              rules=rules)

    return Cell(arch, shape_name, mesh, decode, (p, tokens, c, scalar),
                (p_spec, rules.spec(("batch", "seq")), c_spec, ()),
                ("params", "tokens", "cache", "scalars"))


def dtensor_args(cell: Cell) -> list:
    """The cell's arguments as ``meta`` DTensors on its bound mesh
    (``launch.mesh.fake_group``), ready for ``cell.step_fn``: each leaf
    its per-device block (``sharding.shard_shape``) under the placements
    of its spec (``sharding.placements``, fsdp's ``_StridedShard``
    included), so each holds the bytes ``dryrun.leaf_records`` gives it;
    a ``scalars`` argument is the Python int 0."""
    from torch.distributed.tensor import DTensor

    from ..parallel.sharding import placements, shard_shape

    mesh = cell.mesh
    if getattr(mesh, "device_mesh", None) is None:
        raise ValueError(f"cell {cell.arch} {cell.shape}: its mesh is not "
                         f"bound to a process group")

    def one(t, spec):
        block = shard_shape(t.shape, spec, mesh)
        local = torch.empty(block, dtype=t.dtype, device="meta")
        return DTensor.from_local(
            local, mesh.device_mesh, placements(spec, mesh),
            run_check=False, shape=t.shape,
            stride=torch.empty(t.shape, device="meta").stride())

    def walk(t, spec):
        if isinstance(t, dict):
            return {k: walk(v, spec[k]) for k, v in t.items()}
        return one(t, spec)

    return [0 if g == "scalars" else walk(a, sp)
            for g, a, sp in zip(cell.groups, cell.args, cell.specs)]

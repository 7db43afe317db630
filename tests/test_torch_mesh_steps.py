"""The dry run's steps run as DTensors on 8 CPU ranks, against the same
steps on plain tensors.

The per-device analysis (``tests/test_torch_step_analysis.py``) runs each
cell's step on ``meta`` DTensors and counts its work; this file checks
the values that the same code computes.  Each smoke cell's step
(``specs.build_cell``: the training step with its optimizer, the chunked
prefill, the decode step) runs on 8 ``gloo`` ranks (``tests/_torch_dist.py``)
bound to a 4 x 2 ``data x model`` and a 2 x 2 x 2 ``pod x data x model``
mesh, its arguments laid out by the cell's specs
(``Sharding.distribute``), and again on plain tensors through the cell
of an unbound mesh, which runs the single-device path.  The two must
agree: the loss, every optimizer-state leaf (at step 0 the learning rate
is 0, so the state carries the gradients: AdamW's ``m`` is 0.1 of the
clipped gradient, Adafactor's its factored moments and clipped update),
the prefill and decode logits and every cache leaf, gathered whole on
every rank.

The cells reach every DTensor path of the models: K/V projections with
the kv heads sharded in the weights only (``attention._KVProj``, with a
bias in qwen1.5-32b), GQA heads and the prefill query rows over the
batch axes (``_local_heads``), the cache written and read over sequence
shards (``_write_local``, ``_decode_local``), the vocab-parallel
cross-entropy (``common._xent_local``), the Mamba and wkv6 scans on local
blocks, expert-parallel MoE on the batch shards' tokens, constraints'
gradient layouts, microbatches split on each rank (``_split_local``, 2
microbatches), fsdp's gathered weights (qwen1.5-32b and arctic-480b
train with fsdp, as their production configs do) and Adafactor's
factored update (arctic-480b).  MoE cells
run at capacity factor 8.0, where no assignment is dropped: the
expert-parallel path sizes capacity by one batch shard's tokens, as the
reference's does, and the single-device path by all of them, so at the
configs' 1.25 the two keep different assignments (``test_torch_ep.py``).
Tolerance: 1e-5, relative where a leaf's values pass 1, the float32
tolerance of the other mesh tests (1e-4 for rwkv6-3b's gradients, whose
own sensitivity to one rounding of the weights is larger: ``RTOL_OF``);
a bfloat16 leaf within one step of its precision.
"""
import dataclasses
import traceback

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_dist  # noqa: E402
from torch.distributed.tensor.experimental import (  # noqa: E402
    implicit_replication)
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.launch.mesh import Mesh, bind_mesh  # noqa: E402
from repro_torch.launch.specs import build_cell, rules_for  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.common import (  # noqa: E402
    init_params, tree_leaves, tree_paths)
from repro_torch.optim.optimizers import (  # noqa: E402
    OptimizerConfig, make_optimizer)
from repro_torch.parallel.sharding import Sharding, is_dtensor  # noqa: E402
from repro_torch.train.train_step import (  # noqa: E402
    grads_with_accum, make_loss_fn)

#: mesh name → (axis names, sizes), 8 ranks each
MESHES = {"4x2": (("data", "model"), (4, 2)),
          "2x2x2": (("pod", "data", "model"), (2, 2, 2))}
#: kind → (seq, batch): training 16 sequences (4 a batch shard, in 2
#: microbatches); prefill in 2 chunks of 16 with the batch of 2 whole
#: (its query rows go over the batch axes); decode at position 24 of 32
#: with the batch sharded
SHAPES = {"train": (32, 16), "prefill": (32, 2), "decode": (32, 8)}
DECODE_POS = 24
CELLS = [(a, k) for a in ("yi-6b", "olmoe-1b-7b", "hymba-1.5b", "rwkv6-3b")
         for k in ("train", "prefill", "decode")] + [
    ("qwen1.5-32b", "train"), ("arctic-480b", "train")]
CASES = [(a, k, m) for m in MESHES for a, k in CELLS]
RTOL = 1e-5
#: rwkv6-3b's smoke gradients move by up to 6.4e-4 of a leaf's largest
#: entry when every weight moves by one float32 rounding (the plain
#: path, this file's inputs), so rounding alone puts the sharded step's
#: gradients 2e-5 from the plain one's: held at 1e-4 there.
RTOL_OF = {("rwkv6-3b", "train"): 1e-4}


#: Cells trained with fsdp, as their production configs are (the smoke
#: configs turn it off): the weights' d_model on the batch axes, out of
#: mesh order on 2 x 2 x 2 (``_StridedShard``), gathered before use.
FSDP = ("qwen1.5-32b", "arctic-480b")


def _cfg(arch):
    cfg = smoke_config(arch)
    if arch in FSDP:
        cfg = dataclasses.replace(cfg, fsdp=True)
    if cfg.prefill_chunk:
        cfg = dataclasses.replace(cfg, prefill_chunk=16)
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    return cfg


def _fill(tree, gen, vocab):
    """Random values in the shapes and dtypes of ``tree``'s leaves, drawn
    in leaf order from ``gen`` (the same on every rank)."""
    def one(path, t):
        if t.dtype in (torch.int32, torch.int64):
            return torch.randint(0, vocab, t.shape, generator=gen,
                                 dtype=t.dtype)
        if t.dtype == torch.int8:
            return torch.randint(-127, 128, t.shape, generator=gen,
                                 dtype=torch.int8)
        if path.endswith("['mask']"):  # a token in 5 masked out
            return (torch.rand(t.shape, generator=gen) > 0.2).to(t.dtype)
        if "scale" in path:
            return torch.rand(t.shape, generator=gen).to(t.dtype)
        return (0.5 * torch.randn(t.shape, generator=gen)).to(t.dtype)

    leaves = [one(p, t) for p, t in tree_paths(tree)]
    return _unflatten(tree, iter(leaves))


def _unflatten(tree, it):
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], it) for k in sorted(tree)}
    return next(it)


def _distribute(tree, spec, mesh):
    if isinstance(tree, dict):
        return {k: _distribute(v, spec[k], mesh) for k, v in tree.items()}
    return Sharding(mesh, spec).distribute(tree.clone())


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def _errors(prefix, got, want, out):
    """``out[prefix + path]`` = (max |got - want|, max |want|, the leaf
    dtype's epsilon) of each leaf (``got`` gathered whole)."""
    for (path, w), g in zip(tree_paths(want), tree_leaves(got)):
        g = g.full_tensor() if is_dtensor(g) else g
        eps = torch.finfo(w.dtype).eps if w.is_floating_point() else 0.0
        g, w = g.detach().double(), w.detach().double()
        assert g.shape == w.shape, (prefix, path, g.shape, w.shape)
        out[prefix + path] = (float((g - w).abs().max()),
                              float(w.abs().max()), eps)


def _case(arch, kind, mesh_name, bound, out):
    names, sizes = MESHES[mesh_name]
    cfg = _cfg(arch)
    seq, batch = SHAPES[kind]
    shape = ShapeConfig(kind, seq, batch, kind)
    sharded = build_cell(arch, kind, bound, tp=1, device="cpu", cfg=cfg,
                         shape=shape)
    plain = build_cell(arch, kind, Mesh(names, sizes), tp=1, device="cpu",
                       cfg=cfg, shape=shape)
    gen = torch.Generator().manual_seed(0)
    # the weights at their initial scales, the rest drawn by _fill
    weights = init_params(lm.model_defs(cfg, 1), gen, torch.device("cpu"))
    # the optimizer's state as the cell made it (zeros)
    args = [a if g in ("scalars", "opt_state") else _fill(a, gen, cfg.vocab)
            for g, a in zip(sharded.groups, sharded.args)]
    args[0] = _unflatten(args[0], iter(
        w.to(a.dtype) for w, a in zip(tree_leaves(weights),
                                      tree_leaves(args[0]))))
    scalar = DECODE_POS if kind == "decode" else 0
    dt = [scalar if g == "scalars" else _distribute(a, s, bound)
          for g, a, s in zip(sharded.groups, args, sharded.specs)]
    pl = [scalar if g == "scalars" else _clone(a)
          for g, a in zip(sharded.groups, args)]
    key = f"{arch}/{kind}/{mesh_name}/"
    if kind == "train":
        _train(cfg, shape, sharded, plain, dt, pl, key, out)
        return
    with implicit_replication():  # as the dry run calls the step
        got = sharded.step_fn(*dt)
    want = plain.step_fn(*pl)
    _errors(key + "logits", got[0], want[0], out)
    _errors(key + "cache", got[1], want[1], out)


def _train(cfg, shape, sharded, plain, dt, pl, key, out):
    """The training step in its two halves: the loss and gradients
    (``grads_with_accum`` in the cell's microbatches), then the optimizer
    fed the plain path's gradients on both sides (at step 0 AdamW's and
    Adafactor's first update divides each gradient by its own magnitude,
    which would turn a rounding of a near-zero gradient into a sign), at
    step 200, past the warmup, so the parameters move."""
    rules = rules_for(cfg, shape, sharded.mesh)
    (p_dt, o_dt, b_dt, _), (p_pl, o_pl, b_pl, _) = dt, pl
    with implicit_replication():
        loss, _, grads = grads_with_accum(make_loss_fn(cfg, "ref", rules),
                                          p_dt, b_dt, sharded.grad_accum)
    loss0, _, grads0 = grads_with_accum(make_loss_fn(cfg, "ref"), p_pl,
                                        b_pl, plain.grad_accum)
    _errors(key + "loss", loss, loss0, out)
    _errors(key + "grads", grads, grads0, out)
    opt = make_optimizer(OptimizerConfig(name=cfg.optimizer))
    g_dt = _distribute(grads0, sharded.specs[0], sharded.mesh)
    with implicit_replication(), torch.no_grad():
        p_new, o_new, _ = opt.update(g_dt, o_dt, p_dt, 200)
    p_new0, o_new0, _ = opt.update(grads0, o_pl, p_pl, 200)
    _errors(key + "opt", o_new, o_new0, out)
    _errors(key + "params", p_new, p_new0, out)


def _worker(rank, world, work):
    out = {}
    for mesh_name, (names, sizes) in MESHES.items():
        bound = bind_mesh(Mesh(names, sizes), "cpu")
        for arch, kind in CELLS:
            try:
                _case(arch, kind, mesh_name, bound, out)
            except Exception:  # every rank fails alike: report the case
                out[f"{arch}/{kind}/{mesh_name}/error"] = \
                    traceback.format_exc()
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("mesh_steps")
    # ~2 minutes alone on 8 cores, longer beside other tests
    _torch_dist.wait_all(_torch_dist.start_ranks(__file__, "w8", 8, work),
                         work, timeout_s=900)
    return [torch.load(work / f"w8_{r}.pt", weights_only=False)
            for r in range(8)]


@pytest.mark.parametrize("arch,kind,mesh", CASES,
                         ids=[f"{a}-{k}-{m}" for a, k, m in CASES])
def test_dtensor_step_matches_the_plain_step(runs, arch, kind, mesh):
    """Every compared leaf of the cell, on every rank, within 1e-5 of the
    plain step's (relative above 1; a bfloat16 leaf, Adafactor's first
    moment, within one step of its own precision, its epsilon)."""
    key = f"{arch}/{kind}/{mesh}/"
    for rank, res in enumerate(runs):
        errs = {k: v for k, v in res.items() if k.startswith(key)}
        assert errs, key
        assert key + "error" not in errs, errs[key + "error"]
        for name, (err, scale, eps) in errs.items():
            tol = max(RTOL_OF.get((arch, kind), RTOL), eps)
            assert err <= tol * max(1.0, scale), (rank, name, err, scale)


if __name__ == "__main__":
    _torch_dist.worker_main({"w8": _worker})

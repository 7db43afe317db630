"""Language-model assembly for all ten families (from ``repro.models.lm``).

Parameter declarations (``layer_defs``, ``model_defs``), their seeded
initialization on the card (:func:`init_model`), the reference's own
weights carried over leaf for leaf (:func:`lm_params_from_numpy`), w8a16
MLP weights (:func:`quantize_mlp_weights`, and their shapes alone,
:func:`quantize_mlp_structs`), the training loss
(:func:`train_loss`, with the MoE load-balance loss summed over layers)
with its embedding, audio/vision front ends and output head, and the
dense inference path over a contiguous cache (:func:`init_cache`,
:func:`prefill`, :func:`decode_step`, :func:`extend_step`,
:func:`prefill_chunked`), which is how the reference serves every
family.  Each family has its block: the transformer (dense or
Mixture-of-Experts), rwkv6 (``models.rwkv6``) and hymba's parallel
attention and Mamba heads (``models.mamba``); the recurrent scans run
their chunked forms here.  Which layers attend globally is
:func:`global_flags`, as in the reference.

Layers are stacked ``(L, ...)`` as in the reference and the forward loop
slices layer ``i``; under ``cfg.remat`` each layer runs inside
``torch.utils.checkpoint`` (non-reentrant), the counterpart of the
reference's ``jax.checkpoint`` on its scan body.  The reference's
``_diff_barrier`` is an XLA scheduling device (it keeps XLA from hoisting
the float32 upcast of the whole residual stack out of the backward loop)
with no counterpart in eager PyTorch, so it is left out.

Parameter trees are nested dicts of tensors under the reference's paths
(``['layers']['attn']['wq']``, ``['embed']``, ...), the form every
training function takes.  The cache is a nested dict of ``(L, B, ...)``
tensors (KV ``(L, B, max_len, KVH, hd)``, recurrent states ``(L, B,
...)``); a layer writes its slice in place, where the reference carries
the stack through its scan and updates it functionally.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..device import resolve_device
from . import attention as attn_mod
from . import mamba as mamba_mod
from . import rwkv6 as rwkv_mod
from ..parallel import collectives
from ..parallel.sharding import constrain, gather_fsdp, is_dtensor
from .common import (Param, cast_tree, chunked_softmax_xent, init_params,
                     map_tree, rms_norm, stack_layer_defs, tree_paths)
from .mlp import MLP_WEIGHT_NAMES, mlp_defs, mlp_fwd, moe_defs, moe_fwd

__all__ = [
    "cache_dims_tree",
    "decode_step",
    "embed_tokens",
    "extend_step",
    "global_flags",
    "init_cache",
    "init_model",
    "layer_defs",
    "lm_params_from_numpy",
    "model_defs",
    "output_weight",
    "prefill",
    "prefill_chunked",
    "quantize_mlp_structs",
    "quantize_mlp_weights",
    "train_loss",
]


# ---------------------------------------------------------------------------
# Parameter definitions
# ---------------------------------------------------------------------------


def layer_defs(cfg: ArchConfig, q_heads: int, kv_heads: int) -> Dict[str, Any]:
    d = cfg.d_model
    norms = {"ln1": Param((d,), ("d_model",), init="zeros"),
             "ln2": Param((d,), ("d_model",), init="zeros")}
    if cfg.ssm == "rwkv6":
        return {**rwkv_mod.rwkv_defs(cfg, q_heads), **norms}
    if cfg.ssm == "hymba":
        return {"hymba": mamba_mod.hymba_defs(cfg, q_heads, kv_heads),
                "mlp": mlp_defs(cfg), **norms}
    block: Dict[str, Any] = {
        "attn": attn_mod.attention_defs(cfg, q_heads, kv_heads)}
    if cfg.n_experts:
        block["moe"] = moe_defs(cfg)
    else:
        block["mlp"] = mlp_defs(cfg)
    return {**block, **norms}


def model_defs(cfg: ArchConfig, tp: int = 1) -> Dict[str, Any]:
    q_heads, kv_heads = cfg.heads_for_tp(tp)
    if cfg.ssm == "rwkv6":
        q_heads = rwkv_mod.rwkv_heads(cfg, padded=tp > 1)
    vp = cfg.vocab_padded(tp)
    defs: Dict[str, Any] = {
        "layers": stack_layer_defs(layer_defs(cfg, q_heads, kv_heads),
                                   cfg.n_layers),
        "final_norm": Param((cfg.d_model,), ("d_model",), init="zeros"),
    }
    if cfg.modality != "audio":
        defs["embed"] = Param((vp, cfg.d_model), ("vocab", "d_model"),
                              init="embed")
    if cfg.modality in ("audio", "vlm"):
        defs["frontend_proj"] = Param((cfg.frontend_dim, cfg.d_model),
                                      ("frontend", "d_model"))
    if not cfg.tie_embeddings:
        defs["head"] = Param((cfg.d_model, vp), ("d_model", "vocab"))
    return defs


def init_model(cfg: ArchConfig, seed: int = 0, tp: int = 1,
               device=None) -> Dict[str, Any]:
    """The parameter tree drawn on ``device`` (``None``: the GPU) from a
    seeded ``torch.Generator`` with the reference's scales (the stacked
    fan-in of ``init_params``), in ``cfg.param_dtype``.  Not the
    reference's numbers: torch and JAX generators differ, so the tests
    carry the reference's own draw over with :func:`lm_params_from_numpy`.
    """
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    tree = init_params(model_defs(cfg, tp), gen, dev)
    return cast_tree(tree, cfg.param_torch_dtype)


def lm_params_from_numpy(tree, cfg: ArchConfig, device=None,
                         tp: int = 1) -> Dict[str, Any]:
    """The reference's ``lm.init_model`` tree (leaves as numpy arrays, any
    float dtype) as the port's tensors on ``device`` (``None``: the GPU),
    leaf for leaf, in ``cfg.param_dtype``.  Raises if the tree's paths or
    shapes differ from :func:`model_defs`."""
    dev = resolve_device(device)
    defs = model_defs(cfg, tp)
    want = [(path, p.shape) for path, p in tree_paths(defs)]
    got = [(path, tuple(np.shape(leaf))) for path, leaf in tree_paths(tree)]
    if want != got:
        raise ValueError(f"{cfg.name}: the tree's leaves {got} are not the "
                         f"model's {want}")
    dtype = cfg.param_torch_dtype

    def carry(leaf):
        arr = np.array(leaf, dtype=np.float32)  # a writable copy
        return torch.from_numpy(arr).to(device=dev, dtype=dtype)

    return map_tree(carry, tree)


def quantize_mlp_weights(params, cfg: ArchConfig):
    """w8a16: every MLP / MoE weight leaf (``w_up``, ``w_gate``,
    ``w_down`` under ``mlp``, ``moe`` or ``dense``) replaced by ``{'q':
    int8, 'scale': float32}``, the reference's serving-side narrow
    elements (qwen1.5-32b's ``serve_mlp_int8``).

    Symmetric per-output-channel scales over axis -2 (the contracted one),
    kept with that axis so dequantization broadcasts: ``amax / 127``
    (1 where a channel is all zeros), codes ``round(w / scale)`` clipped to
    ±127, bitwise the reference's codes and scales.  ``mlp._w`` reads
    either form."""
    def walk(tree, in_mlp=False):
        if not isinstance(tree, dict):
            return tree
        out = {}
        for k, v in tree.items():
            if in_mlp and k in MLP_WEIGHT_NAMES and torch.is_tensor(v):
                v32 = v.float()
                amax = v32.abs().amax(dim=-2, keepdim=True)
                scale = torch.where(amax > 0, amax / 127.0,
                                    torch.ones_like(amax))
                q = torch.clamp(torch.round(v32 / scale), -127, 127)
                out[k] = {"q": q.to(torch.int8), "scale": scale}
            else:
                out[k] = walk(v, in_mlp or k in ("mlp", "moe", "dense"))
        return out

    return walk(params)


def quantize_mlp_structs(tensors, specs):
    """The (tensor tree, spec tree) of :func:`quantize_mlp_weights`'s
    output, without the arithmetic (the dry run's ``meta`` trees): each MLP
    weight becomes int8 codes of its shape, sharded as the weight, and
    float32 scales with the contracted dim (-2) collapsed to 1 and its
    mesh axis dropped."""
    def walk(t, sp, in_mlp=False):
        if not isinstance(t, dict):
            return t, sp
        out_t, out_sp = {}, {}
        for k in t:
            if in_mlp and k in MLP_WEIGHT_NAMES and torch.is_tensor(t[k]):
                w = t[k]
                sshape = w.shape[:-2] + (1,) + w.shape[-1:]
                sspec = list(sp[k]) + [None] * (w.dim() - len(sp[k]))
                sspec[w.dim() - 2] = None
                out_t[k] = {
                    "q": torch.empty(w.shape, dtype=torch.int8,
                                     device=w.device),
                    "scale": torch.empty(sshape, dtype=torch.float32,
                                         device=w.device)}
                out_sp[k] = {"q": sp[k], "scale": tuple(sspec)}
            else:
                out_t[k], out_sp[k] = walk(
                    t[k], sp[k], in_mlp or k in ("mlp", "moe", "dense"))
        return out_t, out_sp

    return walk(tensors, specs)


def global_flags(cfg: ArchConfig) -> np.ndarray:
    """Per-layer is-global-attention flags (float, the reference's).
    hymba attends globally on layers {0, L/2, L-1} only, whatever
    ``global_interval`` says; without an interval every layer is global
    (a windowless model ignores the flag)."""
    n = cfg.n_layers
    if cfg.ssm == "hymba":
        flags = np.zeros(n)
        flags[[0, n // 2, n - 1]] = 1.0
        return flags
    if cfg.global_interval is None:
        return np.ones(n)
    return np.array([float(cfg.layer_is_global(i)) for i in range(n)])


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _ffn(lp, x: torch.Tensor, cfg: ArchConfig, impl: str, rules=None
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The block's MLP or MoE on ``x`` (normed): (output, aux loss)."""
    if cfg.n_experts:
        return moe_fwd(lp["moe"], x, cfg, impl=impl, rules=rules)
    return (mlp_fwd(lp["mlp"], x, cfg, rules),
            x.new_zeros((), dtype=torch.float32))


def _block_train(x: torch.Tensor, lp, cfg: ArchConfig, is_global: bool,
                 positions: torch.Tensor, impl: str, rules=None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (x, aux loss)."""
    if cfg.ssm == "rwkv6":
        x, _ = rwkv_mod.rwkv_block(lp, x, cfg, lp, chunk=rwkv_mod.CHUNK,
                                   rules=rules)
        return x, x.new_zeros((), dtype=torch.float32)
    if cfg.ssm == "hymba":
        x = x + mamba_mod.hymba_block_fwd(lp["hymba"], rms_norm(x, lp["ln1"]),
                                          cfg, is_global, positions, impl,
                                          rules)
    else:
        x = x + attn_mod.attention_fwd(lp["attn"], rms_norm(x, lp["ln1"]),
                                       cfg, is_global, positions, impl=impl,
                                       rules=rules)
    m, aux = _ffn(lp, rms_norm(x, lp["ln2"]), cfg, impl, rules)
    return x + m, aux


def _block_prefill(x: torch.Tensor, lp, cfg: ArchConfig, is_global: bool,
                   cache, impl: str, rules=None):
    """Returns (x, the layer's cache: the same tensors written in place,
    or a recurrent state to be written)."""
    if cfg.ssm == "rwkv6":
        return rwkv_mod.rwkv_block(lp, x, cfg, lp, chunk=rwkv_mod.CHUNK,
                                   rules=rules)
    if cfg.ssm == "hymba":
        a, cache = mamba_mod.hymba_block_prefill(
            lp["hymba"], rms_norm(x, lp["ln1"]), cfg, is_global, cache,
            rules)
    else:
        a, cache = attn_mod.attention_prefill(
            lp["attn"], rms_norm(x, lp["ln1"]), cfg, is_global, cache,
            rules)
    x = x + a
    m, _ = _ffn(lp, rms_norm(x, lp["ln2"]), cfg, impl, rules)
    return x + m, cache


def _block_decode(x: torch.Tensor, lp, cfg: ArchConfig, is_global: bool,
                  cache, pos: int, impl: str, rules=None):
    if cfg.ssm == "rwkv6":
        return rwkv_mod.rwkv_block(lp, x, cfg, lp, state=cache,
                                   chunk=rwkv_mod.CHUNK, rules=rules)
    if cfg.ssm == "hymba":
        a, cache = mamba_mod.hymba_block_decode(
            lp["hymba"], rms_norm(x, lp["ln1"]), cfg, is_global, cache, pos,
            rules)
    else:
        a, cache = attn_mod.attention_decode(
            lp["attn"], rms_norm(x, lp["ln1"]), cfg, is_global, cache, pos,
            rules)
    x = x + a
    m, _ = _ffn(lp, rms_norm(x, lp["ln2"]), cfg, impl, rules)
    return x + m, cache


def _embed_shard_fwd(tbl: torch.Tensor, ids: torch.Tensor, lo: int,
                     dt: torch.dtype) -> torch.Tensor:
    """The rows of ``ids`` that the vocab shard ``tbl`` (its rows start at
    ``lo``) holds, in ``dt``, and zeros for the others."""
    loc = ids.long() - lo
    ok = (loc >= 0) & (loc < tbl.shape[0])
    x = tbl[loc.clamp(0, tbl.shape[0] - 1)].to(dt)
    return torch.where(ok[..., None], x, torch.zeros((), dtype=dt,
                                                     device=x.device))


def _embed_shard_bwd(ids: torch.Tensor, g: torch.Tensor, lo: int, vs: int,
                     dt: torch.dtype) -> torch.Tensor:
    """The gradient (vs, D) in ``dt`` of the shard of rows [lo, lo + vs)
    from the cotangent ``g`` (..., D) of the rows of ``ids``: a local
    scatter-add, by ``index_put_`` with accumulate as the unsharded
    gather's backward, of the entries the shard owns and zeros for the
    others (the reference's masked form): each row sums the same terms in
    the same order, and zeros, so the result is that gradient's rows, bit
    for bit, on the card too."""
    loc = ids.long().reshape(-1) - lo
    ok = (loc >= 0) & (loc < vs)
    gt = torch.zeros((vs, g.shape[-1]), dtype=dt, device=g.device)
    g = g.reshape(-1, g.shape[-1]).to(dt)
    return gt.index_put_((loc.clamp(0, vs - 1),),
                         torch.where(ok[:, None], g, 0.0), accumulate=True)


class _ShardedEmbed(torch.autograd.Function):
    """The vocab-sharded gather: forward, the shard's own rows summed over
    the vocab axis; backward, a local scatter-add of this rank's block of
    the batch, summed over the batch axes only."""

    @staticmethod
    def forward(ctx, tbl, ids, lo, vocab_group, batch_group, n_batch,
                batch_index, psum_dt, dt, rows_only=False):
        ctx.save_for_backward(ids)
        ctx.lo, ctx.vs, ctx.tdtype = lo, tbl.shape[0], tbl.dtype
        ctx.batch_group, ctx.n_batch, ctx.batch_index = (
            batch_group, n_batch, batch_index)
        ctx.psum_dt, ctx.rows_only = psum_dt, rows_only
        x = _embed_shard_fwd(tbl, ids, lo, psum_dt)
        x = collectives.psum(x, vocab_group).to(dt)
        return x[_batch_rows(ctx, ids)] if rows_only else x

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        rows = _batch_rows(ctx, ids)
        gt = _embed_shard_bwd(ids[rows], g if ctx.rows_only else g[rows],
                              ctx.lo, ctx.vs, ctx.psum_dt)
        if ctx.batch_group is not None:
            gt = collectives.psum(gt, ctx.batch_group)
        return (gt.to(ctx.tdtype),) + (None,) * 9


def _batch_rows(ctx, ids: torch.Tensor) -> slice:
    """This rank's block of the batch's rows."""
    b = ids.shape[0] // ctx.n_batch
    return slice(ctx.batch_index * b, (ctx.batch_index + 1) * b)


def _embed_lookup(table, ids: torch.Tensor, rules, dt: torch.dtype
                  ) -> torch.Tensor:
    """``table[ids]`` in ``dt``; with rules on a bound mesh that shard the
    vocab over more than one device, the reference's shard-local gather.

    Every rank holds the ids and the table whole (plain tensors); its
    shard is rows ``[m·V/n, (m+1)·V/n)`` of the table.  The forward
    takes the shard's own rows, zeros the rest, and sums over the vocab
    axis (one nonzero term a row: the sum is exact).  The backward
    scatter-adds this rank's block of the batch (by its index along the
    batch axes) into its rows and sums over the batch axes only.  Sums
    run in float32 on the CPU and in ``dt`` on the card, as the
    reference's ``psum_dt``.

    A DTensor table (``param_shardings``) is laid out with its vocab on
    the vocab axis and every other dim whole (under fsdp d_model is
    gathered), and the shard gathers from its local block.  DTensor ids
    (the batch sharded) are gathered whole, as the reference's forward
    takes them, and the result is this rank's rows of the batch, a
    DTensor laid out as ``act_batch``; plain ids give the plain result.
    """
    ax = rules.axis("vocab") if rules is not None else None
    n = rules.axis_size("vocab") if rules is not None else 1
    if rules is None or not rules.bound or not isinstance(ax, str) \
            or n == 1:
        # The gather's backward is index_put_ with accumulate, which
        # PyTorch runs on CUDA by sorting the indices and summing each
        # row's repeats in order, with no atomics: a step's gradients
        # repeat bit for bit, which the resume check of chip_smoke.py
        # relies on and checks.
        if is_dtensor(table) or is_dtensor(ids):
            # each rank gathers its batch block's rows from the whole
            # table; the table's gradient sums over the batch shards
            from ..parallel.sharding import local_call, partial_on

            rows = rules.spec(("act_batch", "seq"))
            return local_call(lambda t, i: t[i.long()].to(dt), rules.mesh,
                              (table, ids), ((None, None), rows),
                              rules.spec(("act_batch", "seq", "d_model")),
                              (partial_on((None, None), rules.axis("batch"),
                                          rules.mesh), None))
        return table[ids.long()].to(dt)
    mesh = rules.mesh
    vs = table.shape[0] // n
    m = collectives.axis_index(mesh, ax)
    lo = m * vs
    if is_dtensor(table):
        from torch.distributed.tensor import Replicate, Shard

        want = tuple(Shard(0) if a == ax else Replicate()
                     for a in mesh.axis_names)
        if tuple(table.placements) != want:
            table = table.redistribute(mesh.device_mesh, want)
        tbl = table.to_local()
    else:
        tbl = table[lo:lo + vs]
    dtensor_ids = is_dtensor(ids)
    if dtensor_ids:
        from torch.distributed.tensor import Replicate

        rep = (Replicate(),) * len(mesh.axis_names)
        ids = (ids if tuple(ids.placements) == rep
               else ids.redistribute(mesh.device_mesh, rep)).to_local()
    batch_ax = rules.axis("batch")
    if batch_ax is None:
        batch_group, n_batch, batch_index = None, 1, 0
    else:
        batch_group = collectives.axis_group(mesh, batch_ax)
        n_batch = collectives.axis_size(mesh, batch_ax)
        batch_index = collectives.axis_index(mesh, batch_ax)
    psum_dt = torch.float32 if ids.device.type != "cuda" else dt
    out = _ShardedEmbed.apply(tbl, ids, lo, collectives.axis_group(mesh, ax),
                              batch_group, n_batch, batch_index, psum_dt, dt,
                              dtensor_ids)
    if dtensor_ids:
        from torch.distributed.tensor import DTensor

        from ..parallel.sharding import placements

        out = DTensor.from_local(out, mesh.device_mesh, placements(
            rules.spec(("act_batch", "seq", "d_model")), mesh),
            run_check=False)
    return out


def embed_tokens(params, batch, cfg: ArchConfig, rules=None) -> torch.Tensor:
    """The model's input sequence (B, S, d_model) in the compute dtype: an
    audio model's frames (``batch['frontend']`` (B, S, frontend_dim))
    projected; a vision model's patches projected and placed before its
    token embeddings; any other model's token embeddings (scaled by
    sqrt(d_model) for gemma), through :func:`_embed_lookup` with
    ``rules``."""
    dt = cfg.compute_dtype
    parts = []
    if cfg.modality in ("audio", "vlm") and "frontend" in batch:
        parts.append(batch["frontend"].to(dt)
                     @ params["frontend_proj"].to(dt))
    if cfg.modality != "audio":
        x = _embed_lookup(params["embed"], batch["tokens"], rules, dt)
        if cfg.name.startswith("gemma"):
            x = x * torch.tensor(np.sqrt(cfg.d_model), dtype=x.dtype)
        parts.append(x)
    x = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
    return constrain(x, rules, ("act_batch", "seq", "d_model"))


def output_weight(params, cfg: ArchConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["head"]


def train_loss(params, batch, cfg: ArchConfig, impl: str = "cuda",
               rules=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """batch: tokens (B, S), targets (B, S), mask (B, S), and for an audio
    or vision model ``frontend`` (an audio batch has no tokens).  Returns
    ``(loss, {"ce_loss", "aux_loss", "tokens"})``.

    ``impl`` selects the kernels: ``'cuda'`` the flash kernels and, for an
    MoE model, the indirect converters of the dispatch and combine, for
    tensors on the card (their plain versions on the CPU); ``'ref'`` the
    plain versions anywhere.  ``rules`` on a bound mesh takes the
    reference's mesh paths: the vocab-sharded embedding gather
    (:func:`_embed_lookup`) and expert-parallel MoE (``mlp._ep_moe_fwd``);
    ``None`` is the single-device path.
    """
    x = embed_tokens(params, batch, cfg, rules)
    positions = torch.arange(x.shape[1], device=x.device)
    flags = global_flags(cfg)
    remat = cfg.remat and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    layers = gather_fsdp(params["layers"], rules)
    for i in range(cfg.n_layers):
        lp = map_tree(lambda t: t[i], layers)
        args = (x, lp, cfg, bool(flags[i]), positions, impl, rules)
        x, a = (checkpoint(_block_train, *args, use_reentrant=False) if remat
                else _block_train(*args))
        aux = aux + a
    x = rms_norm(x, params["final_norm"])
    w_out = output_weight(params, cfg).to(cfg.compute_dtype)
    tgt = batch["targets"]
    if x.shape[1] != tgt.shape[1]:  # a front-end prefix was prepended
        x = x[:, x.shape[1] - tgt.shape[1]:]
    loss, cnt = chunked_softmax_xent(x, w_out, tgt, batch.get("mask"),
                                     n_valid=cfg.vocab, rules=rules)
    total = loss + cfg.router_aux_coef * aux / cfg.n_layers
    return total, {"ce_loss": loss, "aux_loss": aux, "tokens": cnt}


# ---------------------------------------------------------------------------
# Dense inference: contiguous cache, prefill and decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               device=None, tp: int = 1) -> Dict[str, Any]:
    """The layers' caches stacked on a leading layers axis, zeros on
    ``device`` (``None``: the GPU; ``'meta'`` for shapes alone, as the
    dry run builds them): the KV cache ``(L, B, max_len, KVH, hd)`` (int8
    codes and ``(L, B, max_len, KVH)`` scales for an int8 cache); rwkv6's
    state ``{'s', 'x_tm', 'x_cm'}``; hymba's ``{'kv': <the KV cache>,
    'ssm': {'h', 'conv'}}``.  ``tp`` > 1 pads the heads as
    :func:`model_defs` does."""
    dev = resolve_device(device)
    _, kv_heads = cfg.heads_for_tp(tp)
    if cfg.ssm == "rwkv6":
        one = rwkv_mod.init_rwkv_state(
            cfg, batch, dev, rwkv_mod.rwkv_heads(cfg, padded=tp > 1))
    elif cfg.ssm == "hymba":
        one = {"kv": attn_mod.init_kv_cache(cfg, kv_heads, batch, max_len,
                                            dev),
               "ssm": mamba_mod.init_mamba_state(cfg, batch, dev)}
    else:
        one = attn_mod.init_kv_cache(cfg, kv_heads, batch, max_len, dev)
    return map_tree(
        lambda t: t.unsqueeze(0).repeat((cfg.n_layers,) + (1,) * t.dim()),
        one)


def cache_dims_tree(cfg: ArchConfig):
    """The reference's logical dims of every cache leaf, layers first (the
    dry run's cache specs)."""
    if cfg.ssm == "rwkv6":
        dims = rwkv_mod.rwkv_state_dims(cfg)
    elif cfg.ssm == "hymba":
        dims = {"kv": attn_mod.cache_dims(cfg),
                "ssm": mamba_mod.mamba_state_dims(cfg)}
    else:
        dims = attn_mod.cache_dims(cfg)
    return map_tree(lambda d: ("layers",) + d, dims)


def _write_back(dst, src) -> None:
    """Store a layer's new cache ``src`` into its slice ``dst`` of the
    stack: tensors the block already wrote in place are ``dst``'s own."""
    if isinstance(dst, dict):
        for name in dst:
            _write_back(dst[name], src[name])
    elif src is not dst:
        dst.copy_(src)


def _run_with_cache(params, x: torch.Tensor, cache, cfg: ArchConfig, block,
                    rules=None):
    """The layers in order, each on its slice of the stacked cache
    (``block(x, lp, is_global, layer_cache)``), written in place; under
    ``rules`` DTensor layers' fsdp shards are gathered first."""
    flags = global_flags(cfg)
    layers = gather_fsdp(params["layers"], rules)
    for i in range(cfg.n_layers):
        lp = map_tree(lambda t: t[i], layers)
        lc = map_tree(lambda c: c[i], cache)
        x, new = block(x, lp, bool(flags[i]), lc)
        _write_back(lc, new)
    return x, cache


def _logits(params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"])
    return x @ output_weight(params, cfg).to(cfg.compute_dtype)


def prefill(params, batch, cache, cfg: ArchConfig, impl: str = "cuda",
            rules=None):
    """Fill the cache from a prompt (``batch['tokens']`` (B, S), and a
    vision model's ``frontend``); returns (last-token logits (B, 1, V),
    cache).  ``impl`` selects the MoE dispatch and combine and ``rules``
    the mesh paths (:func:`train_loss`); the attention of the dense path
    is plain tensor code on every device, as in the reference."""
    x = embed_tokens(params, batch, cfg, rules)
    x, cache = _run_with_cache(
        params, x, cache, cfg,
        lambda x_, lp, g, lc: _block_prefill(x_, lp, cfg, g, lc, impl,
                                             rules), rules)
    return _logits(params, x[:, -1:], cfg), cache


def decode_step(params, tokens: torch.Tensor, cache, pos: int,
                cfg: ArchConfig, impl: str = "cuda", rules=None):
    """One decode step: tokens (B, 1) at position ``pos`` → (logits (B, V),
    cache).  ``rules`` as in :func:`prefill`."""
    logits, cache = extend_step(params, tokens, cache, pos, cfg, impl,
                                rules)
    return logits[:, 0], cache


def extend_step(params, tokens: torch.Tensor, cache, pos: int,
                cfg: ArchConfig, impl: str = "cuda", rules=None):
    """A chunk of tokens (B, C) at positions [pos, pos + C) against the
    cache (chunked prefill): the decode attention takes any C.  Returns
    (last-token logits (B, 1, V), cache)."""
    x = embed_tokens(params, {"tokens": tokens}, cfg, rules)
    x, cache = _run_with_cache(
        params, x, cache, cfg,
        lambda x_, lp, g, lc: _block_decode(x_, lp, cfg, g, lc, pos, impl,
                                            rules), rules)
    return _logits(params, x[:, -1:], cfg), cache


def prefill_chunked(params, batch, cache, cfg: ArchConfig, chunk: int,
                    impl: str = "cuda", rules=None):
    """Prefill in fixed-size chunks through :func:`extend_step`: the
    attention scores scale with ``chunk``, and MoE capacity is per chunk,
    as in continuous-batching serving.  Returns (last-token logits
    (B, 1, V), cache)."""
    tokens = batch["tokens"]
    s = tokens.shape[1]
    if s % chunk:
        raise ValueError(f"prompt length {s} is not a multiple of the chunk "
                         f"{chunk}")
    logits: Optional[torch.Tensor] = None
    for i in range(0, s, chunk):
        logits, cache = extend_step(params, tokens[:, i:i + chunk], cache, i,
                                    cfg, impl, rules)
    return logits, cache

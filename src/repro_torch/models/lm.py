"""Language-model assembly (from ``repro.models.lm``).

The transformer family, dense or Mixture-of-Experts: parameter
declarations (``layer_defs``, ``model_defs``), their seeded initialization
on the card (:func:`init_model`), the reference's own weights carried over
leaf for leaf (:func:`lm_params_from_numpy`), the training loss
(:func:`train_loss`, with the MoE load-balance loss summed over layers)
with its embedding and output head, and the dense inference path over a
contiguous KV cache (:func:`init_cache`, :func:`prefill`,
:func:`decode_step`, :func:`extend_step`, :func:`prefill_chunked`), which
is how the reference serves an MoE model.  The recurrent and hybrid
families and the audio/vision front ends raise, naming ROADMAP A7.

Layers are stacked ``(L, ...)`` as in the reference and the forward loop
slices layer ``i``; under ``cfg.remat`` each layer runs inside
``torch.utils.checkpoint`` (non-reentrant), the counterpart of the
reference's ``jax.checkpoint`` on its scan body.  The reference's
``_diff_barrier`` is an XLA scheduling device (it keeps XLA from hoisting
the float32 upcast of the whole residual stack out of the backward loop)
with no counterpart in eager PyTorch, so it is left out.

Parameter trees are nested dicts of tensors under the reference's paths
(``['layers']['attn']['wq']``, ``['embed']``, ...), the form every
training function takes.  The cache is a dict of ``(L, B, max_len, ...)``
tensors; a layer writes its slice in place, where the reference carries
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
from .common import (Param, cast_tree, chunked_softmax_xent, init_params,
                     map_tree, rms_norm, stack_layer_defs, tree_paths)
from .mlp import mlp_defs, mlp_fwd, moe_defs, moe_fwd

__all__ = [
    "decode_step",
    "embed_tokens",
    "extend_step",
    "init_cache",
    "init_model",
    "layer_defs",
    "lm_params_from_numpy",
    "model_defs",
    "output_weight",
    "prefill",
    "prefill_chunked",
    "train_loss",
]


def _check_family(cfg: ArchConfig) -> None:
    """Raise for the families whose model is not ported yet."""
    what = None
    if cfg.ssm is not None:
        what = f"the {cfg.ssm} family"
    elif cfg.modality != "text":
        what = f"the {cfg.modality} front end"
    if what is not None:
        raise NotImplementedError(
            f"{cfg.name}: {what} is not ported yet (ROADMAP A7c); the port "
            f"runs the transformer family, dense or MoE")


# ---------------------------------------------------------------------------
# Parameter definitions
# ---------------------------------------------------------------------------


def layer_defs(cfg: ArchConfig, q_heads: int, kv_heads: int) -> Dict[str, Any]:
    _check_family(cfg)
    d = cfg.d_model
    block: Dict[str, Any] = {
        "attn": attn_mod.attention_defs(cfg, q_heads, kv_heads)}
    if cfg.n_experts:
        block["moe"] = moe_defs(cfg)
    else:
        block["mlp"] = mlp_defs(cfg)
    return {**block, "ln1": Param((d,), init="zeros"),
            "ln2": Param((d,), init="zeros")}


def model_defs(cfg: ArchConfig, tp: int = 1) -> Dict[str, Any]:
    q_heads, kv_heads = cfg.heads_for_tp(tp)
    vp = cfg.vocab_padded(tp)
    defs: Dict[str, Any] = {
        "layers": stack_layer_defs(layer_defs(cfg, q_heads, kv_heads),
                                   cfg.n_layers),
        "final_norm": Param((cfg.d_model,), init="zeros"),
        "embed": Param((vp, cfg.d_model), init="embed"),
    }
    if not cfg.tie_embeddings:
        defs["head"] = Param((cfg.d_model, vp))
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


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _ffn(lp, x: torch.Tensor, cfg: ArchConfig, impl: str
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The block's MLP or MoE on ``x`` (normed): (output, aux loss)."""
    if cfg.n_experts:
        return moe_fwd(lp["moe"], x, cfg, impl=impl)
    return mlp_fwd(lp["mlp"], x, cfg), x.new_zeros((), dtype=torch.float32)


def _block_train(x: torch.Tensor, lp, cfg: ArchConfig, is_global: bool,
                 positions: torch.Tensor, impl: str
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (x, aux loss)."""
    a = attn_mod.attention_fwd(lp["attn"], rms_norm(x, lp["ln1"]), cfg,
                               is_global, positions, impl=impl)
    x = x + a
    m, aux = _ffn(lp, rms_norm(x, lp["ln2"]), cfg, impl)
    return x + m, aux


def _block_prefill(x: torch.Tensor, lp, cfg: ArchConfig, is_global: bool,
                   cache, impl: str):
    a, cache = attn_mod.attention_prefill(lp["attn"], rms_norm(x, lp["ln1"]),
                                          cfg, is_global, cache)
    x = x + a
    m, _ = _ffn(lp, rms_norm(x, lp["ln2"]), cfg, impl)
    return x + m, cache


def _block_decode(x: torch.Tensor, lp, cfg: ArchConfig, is_global: bool,
                  cache, pos: int, impl: str):
    a, cache = attn_mod.attention_decode(lp["attn"], rms_norm(x, lp["ln1"]),
                                         cfg, is_global, cache, pos)
    x = x + a
    m, _ = _ffn(lp, rms_norm(x, lp["ln2"]), cfg, impl)
    return x + m, cache


def embed_tokens(params, batch, cfg: ArchConfig) -> torch.Tensor:
    # The gather's backward is index_put_ with accumulate, which PyTorch
    # runs on CUDA by sorting the indices and summing each row's repeats
    # in order, with no atomics: a step's gradients repeat bit for bit,
    # which the resume check of chip_smoke.py relies on and checks.
    x = params["embed"][batch["tokens"].long()].to(cfg.compute_dtype)
    if cfg.name.startswith("gemma"):
        x = x * torch.tensor(np.sqrt(cfg.d_model), dtype=x.dtype)
    return x


def output_weight(params, cfg: ArchConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["head"]


def train_loss(params, batch, cfg: ArchConfig, impl: str = "cuda"
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """batch: tokens (B, S), targets (B, S), mask (B, S).  Returns
    ``(loss, {"ce_loss", "aux_loss", "tokens"})``.

    ``impl`` selects the kernels: ``'cuda'`` the flash kernels and, for an
    MoE model, the indirect converters of the dispatch and combine, for
    tensors on the card (their plain versions on the CPU); ``'ref'`` the
    plain versions anywhere.
    """
    x = embed_tokens(params, batch, cfg)
    positions = torch.arange(x.shape[1], device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.n_layers):
        lp = map_tree(lambda t: t[i], params["layers"])
        args = (x, lp, cfg, cfg.layer_is_global(i), positions, impl)
        x, a = (checkpoint(_block_train, *args, use_reentrant=False) if remat
                else _block_train(*args))
        aux = aux + a
    x = rms_norm(x, params["final_norm"])
    w_out = output_weight(params, cfg).to(cfg.compute_dtype)
    loss, cnt = chunked_softmax_xent(x, w_out, batch["targets"],
                                     batch.get("mask"), n_valid=cfg.vocab)
    total = loss + cfg.router_aux_coef * aux / cfg.n_layers
    return total, {"ce_loss": loss, "aux_loss": aux, "tokens": cnt}


# ---------------------------------------------------------------------------
# Dense inference: contiguous KV cache, prefill and decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               device=None) -> Dict[str, torch.Tensor]:
    """The layers' KV caches stacked ``(L, B, max_len, KVH, hd)`` (int8
    codes and ``(L, B, max_len, KVH)`` scales for an int8 cache), zeros on
    ``device`` (``None``: the GPU)."""
    _check_family(cfg)
    _, kv_heads = cfg.heads_for_tp(1)
    one = attn_mod.init_kv_cache(cfg, kv_heads, batch, max_len,
                                 resolve_device(device))
    return {name: t.unsqueeze(0).repeat((cfg.n_layers,) + (1,) * t.dim())
            for name, t in one.items()}


def _run_with_cache(params, x: torch.Tensor, cache, cfg: ArchConfig, block):
    """The layers in order, each on its slice of the stacked cache
    (``block(x, lp, is_global, layer_cache)``), written in place."""
    for i in range(cfg.n_layers):
        lp = map_tree(lambda t: t[i], params["layers"])
        x, _ = block(x, lp, cfg.layer_is_global(i),
                     {name: c[i] for name, c in cache.items()})
    return x, cache


def _logits(params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"])
    return x @ output_weight(params, cfg).to(cfg.compute_dtype)


def prefill(params, batch, cache, cfg: ArchConfig, impl: str = "cuda"):
    """Fill the cache from a prompt (``batch['tokens']`` (B, S)); returns
    (last-token logits (B, 1, V), cache).  ``impl`` selects the MoE
    dispatch and combine (:func:`train_loss`); the attention of the dense
    path is plain tensor code on every device, as in the reference."""
    x = embed_tokens(params, batch, cfg)
    x, cache = _run_with_cache(
        params, x, cache, cfg,
        lambda x_, lp, g, lc: _block_prefill(x_, lp, cfg, g, lc, impl))
    return _logits(params, x[:, -1:], cfg), cache


def decode_step(params, tokens: torch.Tensor, cache, pos: int,
                cfg: ArchConfig, impl: str = "cuda"):
    """One decode step: tokens (B, 1) at position ``pos`` → (logits (B, V),
    cache)."""
    logits, cache = extend_step(params, tokens, cache, pos, cfg, impl)
    return logits[:, 0], cache


def extend_step(params, tokens: torch.Tensor, cache, pos: int,
                cfg: ArchConfig, impl: str = "cuda"):
    """A chunk of tokens (B, C) at positions [pos, pos + C) against the
    cache (chunked prefill): the decode attention takes any C.  Returns
    (last-token logits (B, 1, V), cache)."""
    x = embed_tokens(params, {"tokens": tokens}, cfg)
    x, cache = _run_with_cache(
        params, x, cache, cfg,
        lambda x_, lp, g, lc: _block_decode(x_, lp, cfg, g, lc, pos, impl))
    return _logits(params, x[:, -1:], cfg), cache


def prefill_chunked(params, batch, cache, cfg: ArchConfig, chunk: int,
                    impl: str = "cuda"):
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
                                    cfg, impl)
    return logits, cache

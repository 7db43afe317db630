"""Language-model assembly for training (from ``repro.models.lm``).

The dense transformer family: parameter declarations (``layer_defs``,
``model_defs``), their seeded initialization on the card
(:func:`init_model`), the reference's own weights carried over leaf for
leaf (:func:`lm_params_from_numpy`), and the training loss
(:func:`train_loss`) with its embedding and output head.  MoE, the
recurrent and hybrid families and the audio/vision front ends raise,
naming ROADMAP A7.

Layers are stacked ``(L, ...)`` as in the reference and the forward loop
slices layer ``i``; under ``cfg.remat`` each layer runs inside
``torch.utils.checkpoint`` (non-reentrant), the counterpart of the
reference's ``jax.checkpoint`` on its scan body.  The reference's
``_diff_barrier`` is an XLA scheduling device (it keeps XLA from hoisting
the float32 upcast of the whole residual stack out of the backward loop)
with no counterpart in eager PyTorch, so it is left out.

Parameter trees are nested dicts of tensors under the reference's paths
(``['layers']['attn']['wq']``, ``['embed']``, ...), the form every
training function takes.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..device import resolve_device
from .attention import attention_defs, attention_fwd
from .common import (Param, cast_tree, chunked_softmax_xent, init_params,
                     map_tree, rms_norm, stack_layer_defs, tree_paths)
from .mlp import mlp_defs, mlp_fwd

__all__ = [
    "embed_tokens",
    "init_model",
    "layer_defs",
    "lm_params_from_numpy",
    "model_defs",
    "output_weight",
    "train_loss",
]


def _check_family(cfg: ArchConfig) -> None:
    """Raise for the families whose training is not ported yet."""
    what = None
    if cfg.ssm is not None:
        what = f"the {cfg.ssm} family"
    elif cfg.n_experts:
        what = "MoE layers"
    elif cfg.modality != "text":
        what = f"the {cfg.modality} front end"
    if what is not None:
        raise NotImplementedError(
            f"{cfg.name}: training {what} is not ported yet (ROADMAP A7); "
            f"the port trains the dense transformer family")


# ---------------------------------------------------------------------------
# Parameter definitions
# ---------------------------------------------------------------------------


def layer_defs(cfg: ArchConfig, q_heads: int, kv_heads: int) -> Dict[str, Any]:
    _check_family(cfg)
    d = cfg.d_model
    return {
        "attn": attention_defs(cfg, q_heads, kv_heads),
        "mlp": mlp_defs(cfg),
        "ln1": Param((d,), init="zeros"),
        "ln2": Param((d,), init="zeros"),
    }


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


def _block_train(x: torch.Tensor, lp, cfg: ArchConfig, is_global: bool,
                 positions: torch.Tensor, impl: str) -> torch.Tensor:
    a = attention_fwd(lp["attn"], rms_norm(x, lp["ln1"]), cfg, is_global,
                      positions, impl=impl)
    x = x + a
    return x + mlp_fwd(lp["mlp"], rms_norm(x, lp["ln2"]), cfg)


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

    ``impl`` selects the attention: ``'cuda'`` the flash kernels for
    tensors on the card (their plain versions on the CPU), ``'ref'`` the
    plain versions anywhere.
    """
    x = embed_tokens(params, batch, cfg)
    positions = torch.arange(x.shape[1], device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(cfg.n_layers):
        lp = map_tree(lambda t: t[i], params["layers"])
        args = (x, lp, cfg, cfg.layer_is_global(i), positions, impl)
        x = (checkpoint(_block_train, *args, use_reentrant=False) if remat
             else _block_train(*args))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    x = rms_norm(x, params["final_norm"])
    w_out = output_weight(params, cfg).to(cfg.compute_dtype)
    loss, cnt = chunked_softmax_xent(x, w_out, batch["targets"],
                                     batch.get("mask"), n_valid=cfg.vocab)
    total = loss + cfg.router_aux_coef * aux / cfg.n_layers
    return total, {"ce_loss": loss, "aux_loss": aux, "tokens": cnt}

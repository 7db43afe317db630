"""The benchmark's own counts of operations and bytes.

Each count is what the algorithm needs for the work done, from the sizes
the benchmark saw, never from the program's counters: every input byte
read once, every output byte written once, the causal half of attention.
"""
from __future__ import annotations

from typing import Dict, Iterable, Tuple

import numpy as np


# -- paged serving (the attention-only model of reference/paged_lm.py) ------

def serve_token_flops(shape: Dict[str, int]) -> float:
    """Operations of one token's projections in all layers: q, k, v, o."""
    d, hd = shape["d"], shape["head_dim"]
    per_layer = 2 * d * hd * (2 * shape["heads"] + 2 * shape["kv_heads"])
    return float(per_layer * shape["layers"])


def serve_head_flops(shape: Dict[str, int]) -> float:
    """Operations of one row of logits."""
    return 2.0 * shape["d"] * shape["vocab"]


def attn_flops_per_ctx(shape: Dict[str, int]) -> float:
    """Operations of one query row against one context position, all
    layers and heads: q·k and p·v, two each per element."""
    return 4.0 * shape["heads"] * shape["head_dim"] * shape["layers"]


def kv_bytes_per_token(shape: Dict[str, int], elem_bytes: int) -> float:
    """Bytes of one position's K and V rows in all layers."""
    return (2.0 * shape["layers"] * shape["kv_heads"] * shape["head_dim"]
            * elem_bytes)


def q_out_bytes_per_row(shape: Dict[str, int]) -> float:
    """Bytes of one query row read and its output row written (float32),
    all layers."""
    return 2.0 * 4 * shape["heads"] * shape["head_dim"] * shape["layers"]


def decode_attention(shape: Dict[str, int], elem_bytes: int,
                     calls: Iterable[Tuple[int, np.ndarray]]
                     ) -> Tuple[float, float]:
    """(operations, bytes) of the paged decode attention over decode calls
    given as ``(steps, lengths of the active slots before the call)``:
    step ``s`` of a call attends over ``length + s + 1`` positions."""
    ops = byt = 0.0
    kv = kv_bytes_per_token(shape, elem_bytes)
    per_ctx = attn_flops_per_ctx(shape)
    rows = q_out_bytes_per_row(shape)
    for steps, lens in calls:
        lens = np.asarray(lens, np.float64)
        ctx = steps * lens.sum() + len(lens) * steps * (steps + 1) / 2
        ops += per_ctx * ctx
        byt += kv * ctx + rows * len(lens) * steps
    return ops, byt


def prefill_attention(shape: Dict[str, int], elem_bytes: int,
                      calls: Iterable[Tuple[np.ndarray, np.ndarray]]
                      ) -> Tuple[float, float]:
    """(operations, bytes) of the paged prefill attention over prefill
    calls given as ``(counts, starts)`` of their rows: row tokens
    ``start .. start + count - 1`` each attend causally, so the row reads
    ``start + count`` positions of K/V once and needs
    ``count·start + count·(count + 1)/2`` query-context pairs."""
    ops = byt = 0.0
    kv = kv_bytes_per_token(shape, elem_bytes)
    per_ctx = attn_flops_per_ctx(shape)
    rows = q_out_bytes_per_row(shape)
    for counts, starts in calls:
        c = np.asarray(counts, np.float64)
        s = np.asarray(starts, np.float64)
        real = c > 0
        c, s = c[real], s[real]
        ops += per_ctx * float((c * s + c * (c + 1) / 2).sum())
        byt += kv * float((s + c).sum()) + rows * float(c.sum())
    return ops, byt


# -- MoE training (reference/olmoe.py) ---------------------------------------

def moe_dense_params(cfg: Dict) -> float:
    """Parameters every token passes through: attention, the router and
    the output head (the embedding is a lookup)."""
    d = cfg["hidden_size"]
    h, kvh = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = d // h
    attn = d * hd * (2 * h + 2 * kvh)
    router = d * cfg["num_experts"]
    return float(cfg["num_hidden_layers"] * (attn + router)
                 + d * cfg["vocab_size"])


def moe_expert_params(cfg: Dict) -> float:
    """Parameters of one expert assignment in all layers: the expert's
    three matrices."""
    return float(cfg["num_hidden_layers"] * 3 * cfg["hidden_size"]
                 * cfg["intermediate_size"])


def causal_attention_flops(cfg: Dict, batch: int, seq: int,
                           passes: float) -> float:
    """Operations of causal attention over ``batch`` sequences of ``seq``
    in all layers: ``passes`` matrix products of ``seq²/2 · head_dim``
    per head (2 for a forward, 5 for a backward), two operations each."""
    h = cfg["num_attention_heads"]
    hd = cfg["hidden_size"] // h
    per = 2.0 * batch * h * (seq * seq / 2.0) * hd
    return passes * per * cfg["num_hidden_layers"]

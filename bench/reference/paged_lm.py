"""Plain reference of the model that the paged serving path serves.

An attention-only decoder: tied embeddings, no norms, no MLP, no position
encoding, every product in float32.  Per layer ``q = x Wq``, ``k = x Wk``,
``v = x Wv`` (grouped-query: query head ``j`` reads key/value head
``j // (heads / kv_heads)``), causal softmax attention at scale
``1 / sqrt(head_dim)``, ``x = x + attn Wo``; the logits are ``x E^T``.
The configuration keeps K and V in ``kv_dtype``: each row is rounded to
it once and read back widened to float32.  With ``tf32`` every product's
operands are first rounded to TF32 (10 bits of mantissa), as tensor cores
in TF32 mode take them: the serving cells' lower-precision control, the
same on every device.

This runs over a whole token sequence at once, with no pages, no cache and
no batching: the reference the served tokens are judged against.  It
imports nothing of the program.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

KV_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


def shape_of(config: Dict) -> Dict[str, int]:
    """The model's sizes from a configuration file's keys."""
    h = config["num_attention_heads"]
    d = config["hidden_size"]
    return {"layers": config["num_hidden_layers"], "d": d, "heads": h,
            "kv_heads": config["num_key_value_heads"],
            "head_dim": config.get("head_dim") or d // h,
            "vocab": config["vocab_size"]}


def draw_weights(shape: Dict[str, int], seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """The weights of seed ``seed``, drawn on ``device`` in five calls:
    ``embed ~ N(0, 0.02²)`` (vocab, d); each projection ``N(0, 1/fan_in)``,
    stacked over the layers, and the output projection scaled down by
    ``1/sqrt(2 · layers)`` as GPT-2 scales its residual projections
    (Radford et al., 2019).  Without that scale the residual stream of
    this norm-free model grows about ``sqrt(2)`` a layer, attention turns
    sharp, and rounding in the first layers decides the deep layers and
    the tokens.  The same seed and device give the same numbers, so the
    reference draws them again instead of keeping them."""
    L, d, v = shape["layers"], shape["d"], shape["vocab"]
    hq = shape["heads"] * shape["head_dim"]
    hkv = shape["kv_heads"] * shape["head_dim"]
    gen = torch.Generator(device=device).manual_seed(seed)

    def normal(dims, std):
        return torch.randn(dims, generator=gen, dtype=torch.float32,
                           device=device).mul_(std)

    return {"embed": normal((v, d), 0.02),
            "wq": normal((L, d, hq), 1.0 / math.sqrt(d)),
            "wk": normal((L, d, hkv), 1.0 / math.sqrt(d)),
            "wv": normal((L, d, hkv), 1.0 / math.sqrt(d)),
            "wo": normal((L, hq, d), 1.0 / math.sqrt(hq * 2 * L))}


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to the nearest TF32 value, ties away from
    zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm(a: torch.Tensor, b: torch.Tensor, tf32: bool) -> torch.Tensor:
    return to_tf32(a) @ to_tf32(b) if tf32 else a @ b


def forward(w: Dict[str, torch.Tensor], tokens: torch.Tensor,
            shape: Dict[str, int], kv_dtype: str, block: int = 512,
            keep_kv: bool = False, tf32: bool = False
            ) -> Tuple[torch.Tensor, Optional[Tuple[torch.Tensor, ...]]]:
    """The final hidden states ``(S, d)`` of ``tokens`` (S,), and with
    ``keep_kv`` every layer's K and V rows as stored, ``(L, S, kv_heads,
    head_dim)`` in ``kv_dtype`` each.  Attention runs over blocks of
    ``block`` query rows."""
    s = tokens.shape[0]
    h, kvh, hd = shape["heads"], shape["kv_heads"], shape["head_dim"]
    rep = h // kvh
    scale = 1.0 / math.sqrt(hd)
    kdt = KV_DTYPES[kv_dtype]
    x = w["embed"][tokens.long()]
    ks, vs = [], []
    pos = torch.arange(s, device=x.device)
    for layer in range(shape["layers"]):
        q = _mm(x, w["wq"][layer], tf32).view(s, h, hd)
        k = _mm(x, w["wk"][layer], tf32).to(kdt)
        v = _mm(x, w["wv"][layer], tf32).to(kdt)
        if keep_kv:
            ks.append(k.view(s, kvh, hd))
            vs.append(v.view(s, kvh, hd))
        kf = k.float().view(s, kvh, 1, hd).expand(s, kvh, rep, hd)
        vf = v.float().view(s, kvh, 1, hd).expand(s, kvh, rep, hd)
        kf = kf.reshape(s, h, hd).transpose(0, 1)           # (h, S, hd)
        vf = vf.reshape(s, h, hd).transpose(0, 1)
        out = torch.empty((s, h, hd), dtype=torch.float32, device=x.device)
        for a in range(0, s, block):
            b = min(a + block, s)
            qb = q[a:b].transpose(0, 1)                      # (h, nb, hd)
            sc = _mm(qb, kf[:, :b].transpose(1, 2), tf32) * scale
            mask = pos[None, :b] > pos[a:b, None]            # future keys
            sc = sc.masked_fill(mask, float("-inf"))
            p = torch.softmax(sc, dim=-1)
            out[a:b] = _mm(p, vf[:, :b], tf32).transpose(0, 1)
        x = x + _mm(out.reshape(s, h * hd), w["wo"][layer], tf32)
    kv = (torch.stack(ks), torch.stack(vs)) if keep_kv else None
    return x, kv


def logits(w: Dict[str, torch.Tensor], x: torch.Tensor,
           tf32: bool = False) -> torch.Tensor:
    """``x E^T``: the float32 logits of hidden states ``x`` (n, d)."""
    return _mm(x, w["embed"].T, tf32)

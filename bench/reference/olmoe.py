"""Plain reference of the MoE training step that the program trains.

A decoder of ``num_hidden_layers`` blocks, every product in bfloat16 on
float32 parameters cast to bfloat16, as the configuration states:

- ``x = embed[tokens]``; per block ``x = x + attn(norm1(x))`` and
  ``x = x + moe(norm2(x))``; ``norm(x) = x · rsqrt(mean(x²) + eps) · (1 +
  gamma)`` with the squares summed in float32;
- attention: ``q, k, v = x Wq, x Wk, x Wv`` per head, rotary positions on
  q and k (the two halves rotated, float32 angles at ``rope_theta``),
  causal softmax at ``1/sqrt(head_dim)`` computed in float32, ``o Wo``;
- MoE: router logits ``x R`` taken to float32, softmax, the top
  ``num_experts_per_tok`` (of equal probabilities the lower expert
  first), gates renormalised to sum to 1; each expert takes the first
  ``capacity`` of its assignments in the order ``token · k + j`` and drops
  the rest; expert ``e`` computes ``(silu(x U_e) ⊙ x G_e) D_e``; a token's
  output is the gate-weighted sum of its kept assignments' outputs (in
  bfloat16); the load-balance loss is ``E · Σ_e frac_e · mean_prob_e``;
- the loss: mean cross-entropy of ``norm(x) H`` (logits in float32)
  plus ``router_aux_loss_coef`` times the layers' mean load-balance loss;
- the step: the gradient averaged over ``grad_accum`` microbatches,
  clipped to a global norm of ``grad_clip``, then AdamW (bias-corrected
  moments, weight decay on matrices only, a cosine schedule).

It runs block by block under ``torch.utils.checkpoint`` and attention in
blocks of query rows, so that it fits beside nothing else.  It imports
nothing of the program.  ``fp8=True`` rounds every product's operands to
float8 (e4m3) first: the lower-precision control.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

BF16 = torch.bfloat16

def leaf_specs(cfg: Dict
               ) -> List[Tuple[Tuple[str, ...], Tuple[int, ...], float]]:
    """(path, shape, initial standard deviation) of every leaf of the
    parameter tree, in sorted path order, from the configuration's
    sizes."""
    L, d = cfg["num_hidden_layers"], cfg["hidden_size"]
    h, kvh = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd, f = d // h, cfg["intermediate_size"]
    e, v = cfg["num_experts"], cfg["vocab_size"]
    return [
        (("embed",), (v, d), 1.0 / math.sqrt(d)),
        (("final_norm",), (d,), 0.0),
        (("head",), (d, v), 1.0 / math.sqrt(d)),
        (("layers", "attn", "wk"), (L, d, kvh, hd), 1.0 / math.sqrt(d)),
        (("layers", "attn", "wo"), (L, h, hd, d), 1.0 / math.sqrt(h * hd)),
        (("layers", "attn", "wq"), (L, d, h, hd), 1.0 / math.sqrt(d)),
        (("layers", "attn", "wv"), (L, d, kvh, hd), 1.0 / math.sqrt(d)),
        (("layers", "ln1"), (L, d), 0.0),
        (("layers", "ln2"), (L, d), 0.0),
        (("layers", "moe", "router"), (L, d, e), 0.02),
        (("layers", "moe", "w_down"), (L, e, f, d), 1.0 / math.sqrt(f)),
        (("layers", "moe", "w_gate"), (L, e, d, f), 1.0 / math.sqrt(d)),
        (("layers", "moe", "w_up"), (L, e, d, f), 1.0 / math.sqrt(d)),
    ]


def draw_leaf(cfg: Dict, i: int, seed: int, device) -> torch.Tensor:
    """Leaf ``i`` of :func:`leaf_specs` for seed ``seed``: float32, drawn on
    ``device`` from a generator of its own (zeros for a norm's gamma), so
    any leaf can be drawn again alone."""
    _, shape, std = leaf_specs(cfg)[i]
    if std == 0.0:
        return torch.zeros(shape, dtype=torch.float32, device=device)
    gen = torch.Generator(device=device).manual_seed(seed * 64 + i + 1)
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=device).mul_(std)


def draw_params(cfg: Dict, seed: int, device) -> Dict:
    """The nested parameter tree of seed ``seed``."""
    tree: Dict = {}
    for i, (path, _, _) in enumerate(leaf_specs(cfg)):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = draw_leaf(cfg, i, seed, device)
    return tree


def leaves(tree: Dict) -> List[torch.Tensor]:
    """The tree's leaves in sorted key order, which is :func:`leaf_specs`
    order and the program's."""
    if not isinstance(tree, dict):
        return [tree]
    return [leaf for k in sorted(tree) for leaf in leaves(tree[k])]


def draw_batch(cfg: Dict, seed: int, step: int, batch: int, seq: int,
               device) -> Dict[str, torch.Tensor]:
    """Step ``step``'s batch: ``batch`` rows of ``seq + 1`` token ids
    drawn on ``device``; inputs and next-token targets, every position
    counted."""
    gen = torch.Generator(device=device).manual_seed(
        (seed * 1_000_003 + step) % (1 << 62))
    ids = torch.randint(0, cfg["vocab_size"], (batch, seq + 1),
                        generator=gen, device=device, dtype=torch.int32)
    return {"tokens": ids[:, :-1].contiguous(),
            "targets": ids[:, 1:].contiguous(),
            "mask": torch.ones((batch, seq), dtype=torch.float32,
                               device=device)}


def _mm(a: torch.Tensor, b: torch.Tensor, fp8: bool) -> torch.Tensor:
    if fp8:
        a = a.to(torch.float8_e4m3fn).to(BF16)
        b = b.to(torch.float8_e4m3fn).to(BF16)
    return a @ b


def _norm(x, gamma, eps):
    var = torch.sum(x.float() * x.float(), dim=-1, keepdim=True) / x.shape[-1]
    return x * torch.rsqrt(var + eps).to(x.dtype) * (1.0 + gamma.to(x.dtype))


def _rope(x, theta):
    """x (B, S, H, hd): the halves rotated by float32 angles."""
    s, hd = x.shape[1], x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                        device=x.device) / hd))
    ang = torch.arange(s, device=x.device, dtype=torch.float32)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def _attention(x, p, cfg, fp8, block=1024):
    b, s, d = x.shape
    h, kvh = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = d // h
    q = _mm(x, p["wq"].to(BF16).reshape(d, -1), fp8).view(b, s, h, hd)
    k = _mm(x, p["wk"].to(BF16).reshape(d, -1), fp8).view(b, s, kvh, hd)
    v = _mm(x, p["wv"].to(BF16).reshape(d, -1), fp8).view(b, s, kvh, hd)
    q, k = _rope(q, cfg["rope_theta"]), _rope(k, cfg["rope_theta"])
    rep = h // kvh
    qf = q.float().transpose(1, 2)                              # (B, H, S, hd)
    kf = k.float().repeat_interleave(rep, dim=2).transpose(1, 2)
    vf = v.float().repeat_interleave(rep, dim=2).transpose(1, 2)
    pos = torch.arange(s, device=x.device)
    outs = []
    for a in range(0, s, block):
        e = min(a + block, s)
        sc = torch.matmul(qf[:, :, a:e], kf[:, :, :e].transpose(-1, -2))
        sc = sc / math.sqrt(hd)
        sc = sc.masked_fill(pos[None, :e] > pos[a:e, None], float("-inf"))
        outs.append(torch.matmul(torch.softmax(sc, dim=-1), vf[:, :, :e]))
    o = torch.cat(outs, dim=2).transpose(1, 2).to(BF16).reshape(b, s, h * hd)
    return _mm(o, p["wo"].to(BF16).reshape(h * hd, d), fp8)


def _moe(x, p, cfg, fp8):
    """(output (B, S, d), load-balance loss)."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg["num_experts"], cfg["num_experts_per_tok"]
    flat = x.reshape(t, d)
    probs = torch.softmax(_mm(flat, p["router"].to(BF16), fp8).float(), -1)
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = top_p[:, :k], top_i[:, :k]
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    frac = F.one_hot(idx, e).float().sum(1).mean(0) / k
    aux = e * torch.sum(frac * probs.mean(0))
    cap = math.ceil(t * k * cfg["capacity_factor"] / e)
    cap = max(8, -(-cap // 8) * 8)
    flat_e = idx.reshape(-1)                                   # order t·k + j
    out = torch.zeros((t * k, d), dtype=BF16, device=x.device)
    for ex in range(e):
        rows = torch.nonzero(flat_e == ex, as_tuple=True)[0][:cap]
        if rows.numel() == 0:
            continue
        xe = flat[rows // k]
        up = _mm(xe, p["w_up"][ex].to(BF16), fp8)
        gt = _mm(xe, p["w_gate"][ex].to(BF16), fp8)
        out[rows] = _mm(F.silu(up) * gt, p["w_down"][ex].to(BF16), fp8)
    y = torch.einsum("tkd,tk->td", out.view(t, k, d), gate.to(BF16))
    return y.view(b, s, d), aux


def _block(x, lp, cfg, fp8):
    eps = cfg["rms_norm_eps"]
    x = x + _attention(_norm(x, lp["ln1"], eps), lp["attn"], cfg, fp8)
    m, aux = _moe(_norm(x, lp["ln2"], eps), lp["moe"], cfg, fp8)
    return x + m, aux


def loss_fn(params, batch, cfg, fp8: bool = False) -> torch.Tensor:
    x = params["embed"][batch["tokens"].long()].to(BF16)
    n = cfg["num_hidden_layers"]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n):
        lp = {"attn": {k: v[i] for k, v in params["layers"]["attn"].items()},
              "moe": {k: v[i] for k, v in params["layers"]["moe"].items()},
              "ln1": params["layers"]["ln1"][i],
              "ln2": params["layers"]["ln2"][i]}
        x, a = checkpoint(_block, x, lp, cfg, fp8, use_reentrant=False)
        aux = aux + a
    x = _norm(x, params["final_norm"], cfg["rms_norm_eps"])
    head = params["head"].to(BF16)
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    s = x.shape[1]
    for a in range(0, s, 512):

        def chunk(xc, lab):
            lg = _mm(xc, head, fp8).float()
            gold = lg.gather(-1, lab[..., None].long())[..., 0]
            return (torch.logsumexp(lg, -1) - gold).sum()

        tot = tot + checkpoint(chunk, x[:, a:a + 512],
                               batch["targets"][:, a:a + 512],
                               use_reentrant=False)
    ce = tot / batch["mask"].sum()
    return ce + cfg["router_aux_loss_coef"] * aux / n


class AdamW:
    """The configuration's optimizer on a list of float32 leaves."""

    def __init__(self, opt: Dict, leaves_: List[torch.Tensor]):
        self.o = opt
        self.m = [torch.zeros_like(p) for p in leaves_]
        self.v = [torch.zeros_like(p) for p in leaves_]

    def lr(self, step: int) -> float:
        o = self.o
        if step < o["warmup_steps"]:
            return o["lr"] * step / max(o["warmup_steps"], 1)
        prog = min(max((step - o["warmup_steps"])
                       / max(o["total_steps"] - o["warmup_steps"], 1), 0.0),
                   1.0)
        return o["lr"] * 0.5 * (1.0 + math.cos(math.pi * prog))

    @torch.no_grad()
    def update(self, params: List[torch.Tensor], grads: List[torch.Tensor],
               step: int) -> torch.Tensor:
        """Clips ``grads`` in place, updates ``params`` in place; returns
        the global norm before clipping."""
        o = self.o
        norm = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads))
        scale = torch.clamp(o["grad_clip"] / torch.clamp(norm, min=1e-9),
                            max=1.0)
        c1 = 1.0 - o["b1"] ** (step + 1)
        c2 = 1.0 - o["b2"] ** (step + 1)
        lr = self.lr(step)
        for p, g, m, v in zip(params, grads, self.m, self.v):
            g.mul_(scale)
            m.mul_(o["b1"]).add_(g, alpha=1 - o["b1"])
            v.mul_(o["b2"]).addcmul_(g, g, value=1 - o["b2"])
            upd = (m / c1) / (torch.sqrt(v / c2) + o["eps"])
            if p.ndim > 1:
                upd = upd + o["weight_decay"] * p
            p.sub_(lr * upd)
        return norm


def train_steps(cfg: Dict, opt: Dict, seed: int, batches, device,
                grad_accum: int, fp8: bool = False,
                drop_half: bool = False):
    """Runs the steps of ``batches`` (a list of batch dicts) from the
    parameters of ``seed``.  Returns (losses, the first step's clipped
    gradient norm per leaf, the norm of each leaf's change over all the
    steps, the first step's unclipped reference gradient norm per leaf).
    ``drop_half`` leaves out the second half of each microbatch's rows
    (a fault the comparison must catch)."""
    params = draw_params(cfg, seed, device)
    flat = leaves(params)
    for p in flat:
        p.requires_grad_(True)
    opt_state = AdamW(opt, flat)
    losses, first_grad, raw_grad = [], None, None
    for step, batch in enumerate(batches):
        acc = [torch.zeros_like(p) for p in flat]
        total = 0.0
        n = batch["tokens"].shape[0]
        for i in range(grad_accum):
            rows = slice(i * n // grad_accum, (i + 1) * n // grad_accum)
            mb = {key: val[rows] for key, val in batch.items()}
            if drop_half:
                half = max(1, mb["tokens"].shape[0] // 2)
                mb = {key: val[:half] for key, val in mb.items()}
            loss = loss_fn(params, mb, cfg, fp8)
            for a, g in zip(acc, torch.autograd.grad(loss, flat)):
                a.add_(g.float())
            total += float(loss.detach())
        for a in acc:
            a.div_(grad_accum)
        losses.append(total / grad_accum)
        if step == 0:
            raw_grad = [float(a.norm()) for a in acc]
        opt_state.update([p.data for p in flat], acc, step)
        if step == 0:
            first_grad = [float(a.norm()) for a in acc]  # clipped in place
        del acc
    with torch.no_grad():
        change = []
        for i, p in enumerate(flat):
            p0 = draw_leaf(cfg, i, seed, device)
            change.append(float((p.detach() - p0).norm()))
            del p0
    return losses, first_grad, change, raw_grad

"""Training driver: the program's MoE training step, fed batches drawn on
the device from the seed.

Set-up draws the parameters on the device (``reference/olmoe.py``'s
``draw_params``: one generator a leaf), builds the optimizer and the step
with ``make_train_step(cfg, AdamW, grad_accum)``, and runs the first
``check_steps`` steps through that same step object and feed: they warm
every shape up and are what the reference follows.  After the first step
the first gradient is read from AdamW's first moment (``m / (1 - b1)``:
the clipped gradient as the optimizer got it); after the last, each
leaf's change from its drawn value.  The window then runs further steps
until ``--seconds`` have passed, and ends in a device sync.

A traced run profiles ``trace.steps`` steps in the middle of the window
and counts the assignments each MoE dispatch kept (a wrapper around the
dispatch layer's ``moe_dispatch``, summed on the device and read after
the window): over the whole window, for the expert products that
``mfu.train`` counts, and over the profiled steps, for the converters'
bytes.

After the window the program's state is freed and the reference trains
the same steps from the same draw.  A control (``ctx.control``) puts the
reference computed another way in the program's place, judged the same:
``fp8`` rounds every product's operands to float8 e4m3, ``half_batch``
leaves out half of each microbatch's rows.
"""
from __future__ import annotations

import gc
import math
import statistics
import time
from typing import Dict, List

import torch

from harness.common import Check, Ctx, Outcome, peaks
from harness.trace import Tracer, breakdown
from reference import olmoe as ref


def arch_config(c: Dict, opt: Dict):
    from repro_torch.configs.base import ArchConfig

    return ArchConfig(
        name=c["name"], family="moe", n_layers=c["num_hidden_layers"],
        d_model=c["hidden_size"], n_heads=c["num_attention_heads"],
        n_kv_heads=c["num_key_value_heads"], d_ff=c["intermediate_size"],
        vocab=c["vocab_size"], n_experts=c["num_experts"],
        top_k=c["num_experts_per_tok"], capacity_factor=c["capacity_factor"],
        rope_theta=c["rope_theta"], router_aux_coef=c["router_aux_loss_coef"],
        tie_embeddings=c["tie_word_embeddings"], dtype=c["torch_dtype"],
        param_dtype=c["param_dtype"], remat=c["remat"],
        learning_rate=opt["lr"], weight_decay=opt["weight_decay"],
        grad_clip=opt["grad_clip"])


class KeptCounter:
    """Counts the dispatch calls, the assignments they were given and the
    assignments they kept, in the window and, while ``traced`` is set, in
    the profiled steps (device sums, read once)."""

    def __init__(self, ops_module):
        zero = {"calls": 0, "given": 0, "kept": 0}
        self.window, self.profiled = dict(zero), dict(zero)
        self.traced = False
        orig = ops_module.moe_dispatch

        def moe_dispatch(tokens, idx, *args, **kwargs):
            buf, src, keep = orig(tokens, idx, *args, **kwargs)
            k = keep.sum()
            for c in (self.window, self.profiled) if self.traced \
                    else (self.window,):
                c["calls"] += 1
                c["given"] += idx.numel()
                c["kept"] = c["kept"] + k
            return buf, src, keep

        self._ops, self._orig = ops_module, orig
        ops_module.moe_dispatch = moe_dispatch

    def close(self) -> None:
        self._ops.moe_dispatch = self._orig
        for c in (self.window, self.profiled):
            c["kept"] = int(c["kept"])


def _gap(prog: List[float], want: List[float], keep=None) -> float:
    """The worst leaf's gap between two norms, against the larger of the
    reference's norm of that leaf and of the median leaf."""
    idx = [i for i in range(len(want)) if keep is None or keep[i]]
    med = statistics.median(want[i] for i in idx)
    return max(abs(prog[i] - want[i]) / max(want[i], med, 1e-30)
               for i in idx)


#: The controls: the reference's switch that each one turns on.
CONTROLS = {"fp8": "fp8", "half_batch": "drop_half"}


def run(ctx: Ctx) -> Outcome:
    if ctx.control and ctx.control not in CONTROLS:
        raise SystemExit(f"training has the controls {sorted(CONTROLS)}; "
                         f"not {ctx.control!r}")
    from repro_torch.kernels import ops
    from repro_torch.models.common import tree_leaves
    from repro_torch.optim import OptimizerConfig, make_optimizer
    from repro_torch.train import make_train_step

    t_import = time.perf_counter()
    dev = torch.device(ctx.device)
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    c, tr = ctx.config, ctx.traffic
    opt_cfg = tr["optimizer"]
    batch, seq, accum = tr["global_batch"], tr["seq_len"], tr["grad_accum"]
    n_check = tr["check_steps"]
    arch = arch_config(c, opt_cfg)
    if on_card:
        torch.cuda.reset_peak_memory_stats()

    opt = make_optimizer(OptimizerConfig(
        name="adamw", lr=opt_cfg["lr"], warmup_steps=opt_cfg["warmup_steps"],
        total_steps=opt_cfg["total_steps"], b1=opt_cfg["b1"],
        b2=opt_cfg["b2"], eps=opt_cfg["eps"],
        weight_decay=opt_cfg["weight_decay"], grad_clip=opt_cfg["grad_clip"]))
    step_fn = make_train_step(arch, opt, grad_accum=accum)
    state = {"params": ref.draw_params(c, ctx.seed, dev)}
    state["opt"] = opt.init(state["params"])
    sync()
    t_built = time.perf_counter()

    def one(step: int):
        feed = ref.draw_batch(c, ctx.seed, step, batch, seq, dev)
        p, o, metrics = step_fn(state["params"], state["opt"], feed, step)
        state.update(params=p, opt=o)
        return metrics

    losses, first_grad = [], None
    for step in range(n_check):
        losses.append(one(step)["loss"])
        if step == 0:
            first_grad = [float(m.norm()) / (1.0 - opt_cfg["b1"])
                          for m in tree_leaves(state["opt"]["m"])]
            t_first = time.perf_counter()
    with torch.no_grad():
        change = []
        for i, p in enumerate(tree_leaves(state["params"])):
            change.append(float((p - ref.draw_leaf(c, i, ctx.seed, dev))
                                .norm()))
    losses = [float(x) for x in losses]
    sync()

    # -- the window ---------------------------------------------------------
    tracer = Tracer(ctx.trace, sync)
    counter = KeptCounter(ops) if ctx.trace else None
    t_start = time.perf_counter()
    setup_s = t_start - ctx.t0
    t_end = t_start + ctx.seconds
    trace_at = tr.get("trace", {}).get("start_share", 0.4)
    trace_steps = tr.get("trace", {}).get("steps", 2)
    step, done, traced = n_check, 0, []
    while time.perf_counter() < t_end:
        if ctx.trace and not tracer.summary and not tracer.active and \
                time.perf_counter() >= t_start + trace_at * ctx.seconds:
            tracer.start()
            counter.traced = True
        with tracer.span("step"):
            one(step)
        if tracer.active:
            traced.append(step)
            if len(traced) == trace_steps:
                tracer.stop()
                counter.traced = False
        step += 1
        done += 1
    sync()
    t_final = time.perf_counter()
    tracer.stop()
    if counter:
        counter.close()
    window_s = t_final - t_start
    tokens_per_step = batch * seq
    e2e = {"train_tok_s": done * tokens_per_step / window_s,
           "setup_s": setup_s}
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    name = torch.cuda.get_device_name(dev) if on_card else "cpu"
    record = {"config": c, "peaks": peaks(name) if on_card else None,
              "micro_batch": batch // accum, "seq": seq,
              "tokens_per_step": tokens_per_step, "steps": done,
              "window_s": window_s, "trace": tracer.summary,
              "traced_steps": len(traced),
              "dispatch": counter.profiled if counter else None,
              "dispatch_window": counter.window if counter else None,
              "row_bytes": c["hidden_size"] * 2}
    notes = {"steps_in_window": done, "check_losses": losses,
             "setup_s_parts": {"imports": t_import - ctx.t0,
                               "params_and_state": t_built - t_import,
                               "first_step": t_first - t_built,
                               "check_steps": t_start - t_first}}

    # -- the comparison with the reference ----------------------------------
    del state, step_fn, opt
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    feeds = [ref.draw_batch(c, ctx.seed, s, batch, seq, dev)
             for s in range(n_check)]
    want = ref.train_steps(c, opt_cfg, ctx.seed, feeds, dev, accum)
    if ctx.control:
        losses, first_grad, change, _ = ref.train_steps(
            c, opt_cfg, ctx.seed, feeds, dev, accum,
            **{CONTROLS[ctx.control]: True})
    checks, readings = _checks(losses, first_grad, change, want,
                               tr["check"]["limits"])
    notes["reference_losses"] = want[0]
    notes["readings"] = readings
    out = Outcome(attempted=done, failed=0, checks=checks, end_to_end=e2e,
                  record=record, memory_peak_bytes=peak, notes=notes)
    if tracer.summary:
        conv = {name: row for name, row in tracer.summary["kernels"].items()
                if "indirect_" in name}
        notes["traced"] = {"steps": len(traced),
                           "dispatch": record["dispatch"],
                           "dispatch_window": record["dispatch_window"],
                           "converters_s_launches": conv,
                           "reduce_s": tracer.summary["reduce_s"]}
        out.busy_s = tracer.summary["busy_s"]
        out.window_s = tracer.summary["window_s"]
        out.breakdown = breakdown(tracer.summary)
    return out


def _checks(losses, first_grad, change, want, limits):
    """The compared numbers of a run against the reference's ``want``:
    ``loss``, the worst relative gap of the check steps' losses;
    ``first_grad``, the worst leaf's gap of the first clipped gradient's
    norm; ``change``, the worst leaf's gap of the change over the check
    steps, over the leaves whose reference gradient is at least a
    thousandth of the median leaf's."""
    w_loss, w_grad, w_change, w_raw = want
    med = statistics.median(w_raw)
    moved = [g >= 1e-3 * med for g in w_raw]
    readings = {
        "loss": max(abs(a - b) / abs(b) for a, b in zip(losses, w_loss)),
        "first_grad": _gap(first_grad, w_grad),
        "change": _gap(change, w_change, moved),
    }
    checks = [Check(k, v if math.isfinite(v) else math.inf, limits[k])
              for k, v in readings.items() if k in limits]
    return checks, readings

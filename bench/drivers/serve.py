"""Serving driver: paged serving of the attention-only model through the
program's scheduler, with clients generated from the traffic file.

Set-up draws the weights on the device from the seed, builds the bf16 (or
the traffic file's) page pool, binds ``PagedLM(impl="cuda")`` to it and
hands the family to ``Scheduler``.  Each closed-loop client's first
request is submitted and the scheduler stepped until every one has been
prefilled: that warm-up runs every shape the window runs (prefill rows,
decode at the full batch, the fused decode loop) and is set-up time.
Then the window: the scheduler is stepped until ``--seconds`` have
passed; each client sends its next request from the finishing request's
``on_finish`` hook.  Tokens are timed by ``on_token``, where the host
sees them (the end of each fused decode call).

The benchmark's own span sits around the family's ``decode_steps`` and
``prefill_batch`` (wrapped on the family object, not in the program):
wall time, steps, lengths and prompt tokens of every call, and, in a
traced run, the host ranges the profiler attributes kernels to.

After the window: a sample of ``check.requests`` requests finished in it
(the longest, then others drawn from the seed), and the K/V rows of ``check.resident`` requests still decoding,
read from the pool through their page tables.  Then the program's state
is freed and the plain reference (``reference/paged_lm.py``) runs over
each sampled prompt with its served tokens, and over each resident's
tokens, on weights it draws again (:func:`compare`).
"""
from __future__ import annotations

import dataclasses
import gc
import math
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from harness.common import Check, Ctx, Outcome, peaks, percentile
from harness.trace import Tracer, breakdown
from harness.traffic import Spec, Traffic
from reference import paged_lm as ref


@dataclasses.dataclass
class Sent:
    """One request as the client saw it."""

    rid: int
    sent: float
    request: object = None
    first: Optional[float] = None
    last: Optional[float] = None
    finish: Optional[float] = None
    first_window: Optional[float] = None   # its first token in the window
    n_window: int = 0                      # its tokens in the window
    rejected: bool = False


def arch_config(config: Dict, shape: Dict[str, int]):
    """The program's configuration object for the served model."""
    from repro_torch.configs.base import ArchConfig

    return ArchConfig(name=config["name"], family="dense",
                      n_layers=shape["layers"], d_model=shape["d"],
                      n_heads=shape["heads"], n_kv_heads=shape["kv_heads"],
                      head_dim=shape["head_dim"],
                      d_ff=config["intermediate_size"], vocab=shape["vocab"],
                      tie_embeddings=True, dtype="float32")


class Spans:
    """Wall time and sizes of every family call, wrapped on the family
    object."""

    def __init__(self, family, tracer: Tracer):
        self.decode: List[dict] = []
        self.prefill: List[dict] = []
        decode, prefill = family.decode_steps, family.prefill_batch

        def decode_steps(tokens, active, n):
            lens = np.asarray(family.lengths())[np.asarray(active, bool)].copy()
            t0 = time.perf_counter()
            with tracer.span("decode"):
                out = decode(tokens, active, n)  # ends in the host copy
            self.decode.append(dict(t0=t0, t1=time.perf_counter(), n=n,
                                    lens=lens, traced=tracer.active))
            return out

        def prefill_batch(tokens, counts, slots, starts):
            t0 = time.perf_counter()
            with tracer.span("prefill"):
                logits = prefill(tokens, counts, slots, starts)
            self.prefill.append(dict(
                t0=t0, t1=time.perf_counter(),
                counts=np.asarray(counts).copy(),
                starts=np.asarray(starts).copy(), traced=tracer.active))
            return logits

        family.decode_steps = decode_steps
        family.prefill_batch = prefill_batch


def _sample(finished: List[Sent], rng, n: int) -> List[Sent]:
    """The longest finished request, then ``n - 1`` others in a seeded
    order."""
    if not finished:
        return []
    longest = max(finished, key=lambda s: (len(s.request.prompt)
                                           + len(s.request.generated), s.rid))
    rest = [s for s in finished if s is not longest]
    return [longest] + [rest[i] for i in rng.permutation(len(rest))[:n - 1]]


#: The controls: the reference in TF32, the program on int8 pools.
CONTROLS = ("tf32", "int8")


def run(ctx: Ctx) -> Outcome:
    if ctx.control and ctx.control not in CONTROLS:
        raise SystemExit(f"serving has the controls {list(CONTROLS)}; "
                         f"not {ctx.control!r}")
    from repro_torch.serve import PagedKVCache, PagedLM, Request, Scheduler

    t_import = time.perf_counter()
    dev = torch.device(ctx.device)
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    shape = ref.shape_of(ctx.config)
    tr = ctx.traffic
    sv = tr["serve"]
    cfg = arch_config(ctx.config, shape)
    if on_card:
        torch.cuda.reset_peak_memory_stats()

    # The control "int8" runs the program's own lower-precision path, int8
    # pools, against the reference at the configuration's precision.
    kv_prog = "int8" if ctx.control == "int8" else sv["kv_dtype"]
    weights = ref.draw_weights(shape, ctx.seed, dev)
    model = PagedLM(cfg, impl="cuda", kv_dtype=kv_prog, device=dev,
                    params=weights)
    cache = PagedKVCache.create(cfg, batch=sv["slots"], max_len=sv["max_len"],
                                page=sv["page"], pool_pages=sv["pool_pages"],
                                kv_dtype=kv_prog, device=dev)
    family = model.bind(cache)
    t_built = time.perf_counter()
    tracer = Tracer(ctx.trace, sync)
    spans = Spans(family, tracer)
    sched = Scheduler(family, chunk=sv["chunk"])
    traffic = Traffic(tr, ctx.seed, shape["vocab"])

    sent: List[Sent] = []
    clock = {"closed": False}

    def on_token(r, tok):
        s = sent[r.rid]
        now = time.perf_counter()
        if s.first is None:
            s.first = now
        if clock["t_start"] <= now <= clock["t_end"]:
            clock["tokens"] += 1
            if s.n_window == 0:
                s.first_window = now
            s.n_window += 1
            s.last = now

    def submit(spec: Spec, stream, now: float) -> None:
        rid = len(sent)
        s = Sent(rid, now)
        sent.append(s)

        def on_finish(r):
            s.finish = time.perf_counter()
            if stream is not None and not clock["closed"]:
                submit(next(stream), stream, s.finish)

        s.request = Request(rid=rid, prompt=spec.prompt, max_new=spec.max_new,
                            on_token=on_token, on_finish=on_finish)
        if not sched.submit(s.request, strict=False):
            s.rejected = True
            if stream is not None and not clock["closed"]:
                submit(next(stream), stream, now)

    clock.update(t_start=math.inf, t_end=math.inf, tokens=0)
    closed = tr["loop"] == "closed"
    if closed:
        firsts, streams = traffic.first_requests()
        for spec, stream in zip(firsts, streams):
            submit(spec, stream, time.perf_counter())
        arrivals = []
    else:
        arrivals = traffic.arrivals(ctx.seconds)
        # The open loop's warm-up: one request of each prompt-chunk count
        # the mix can send, run to its end.
        for n_chunks in range(1, -(-tr["prompt"]["max"] // sv["chunk"]) + 1):
            spec = Spec(traffic._tokens(n_chunks * sv["chunk"]), 2)
            submit(spec, None, time.perf_counter())
    warm = list(sent)
    while any(s.request.state.value in ("waiting", "prefill") for s in warm):
        sched.step()
    if not closed:
        while sched.queue or sched.resident:
            sched.step()
    sync()

    # -- the window ---------------------------------------------------------
    n_rec0 = len(sched.stats.records)
    n_dec0, n_pre0 = len(spans.decode), len(spans.prefill)
    carried = sum(1 for s in sent if s.finish is None and not s.rejected)
    n_sent0 = len(sent)
    t_start = time.perf_counter()
    t_end = t_start + ctx.seconds
    clock.update(t_start=t_start, t_end=t_end)
    setup_s = t_start - ctx.t0
    trace_cfg = tr.get("trace", {})
    t_trace = t_start + trace_cfg.get("start_share", 0.4) * ctx.seconds
    trace_s = trace_cfg.get("seconds", 2.0)
    lateness: List[float] = []
    nxt = 0
    while True:
        now = time.perf_counter()
        if now >= t_end:
            break
        if ctx.trace:
            if now >= t_trace and not tracer.active and not tracer.summary:
                tracer.start()
            elif tracer.due_to_stop(trace_s):
                tracer.stop()
        while nxt < len(arrivals) and t_start + arrivals[nxt].due_s <= now:
            due = t_start + arrivals[nxt].due_s
            submit(arrivals[nxt], None, due)
            lateness.append(now - due)
            nxt += 1
        if not sched.queue and not sched.resident:
            if nxt < len(arrivals):
                time.sleep(max(0.0, min(t_end, t_start + arrivals[nxt].due_s)
                               - time.perf_counter()))
            continue
        with tracer.span("step"):
            sched.step()
    t_loop_end = time.perf_counter()
    clock["closed"] = True
    tracer.stop()
    sync()

    # -- end-to-end numbers -------------------------------------------------
    window = [s for s in sent[:n_sent0] if s.finish is None
              or s.finish >= t_start] + sent[n_sent0:]
    window = [s for s in window if not s.rejected or s.sent >= t_start]
    failed = sum(1 for s in window if s.rejected)
    ttft = [1e3 * (s.first - s.sent) for s in window
            if s.first is not None and t_start <= s.first <= t_end]
    done = [s for s in window if s.finish is not None
            and t_start <= s.finish <= t_end]
    tpot = [1e3 * (s.last - s.first_window) / (s.n_window - 1) for s in done
            if s.n_window > 1]
    e2e = {"serve_tok_s": clock["tokens"] / ctx.seconds,
           "ttft_p95_ms": percentile(ttft, 95),
           "tpot_p95_ms": percentile(tpot, 95),
           "setup_s": setup_s}

    # -- what the per-layer readers read ------------------------------------
    dec = spans.decode[n_dec0:]
    pre = spans.prefill[n_pre0:]
    records = sched.stats.records[n_rec0:]
    name = torch.cuda.get_device_name(dev) if on_card else "cpu"
    record = {
        "shape": shape, "kv_elem_bytes": 2 if sv["kv_dtype"] == "bf16" else 4,
        "peaks": peaks(name) if on_card else None,
        "window_s": t_loop_end - t_start,
        "decode_calls": dec, "prefill_calls": pre,
        "decode_n_active": [r.n_active for r in records
                            if r.kind == "decode"],
        "trace": tracer.summary,
    }
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    notes = {"requests_in_window": len(window), "finished": len(done),
             "ttft_samples": len(ttft), "tpot_samples": len(tpot),
             "carried_in": carried, "decode_calls": len(dec),
             "prefill_calls": len(pre), "overrun_s": t_loop_end - t_end,
             "setup_s_parts": {"imports": t_import - ctx.t0,
                               "weights_and_pool": t_built - t_import,
                               "warm_up": t_start - t_built}}
    if lateness:
        notes["late_p95_ms"] = 1e3 * percentile(lateness, 95)

    # -- the comparison with the reference ----------------------------------
    rng = np.random.default_rng([ctx.seed, 0xc4ec])
    chk = tr["check"]
    sample = _sample(done, rng, chk["requests"])
    served = [(np.asarray(s.request.prompt),
               np.asarray(s.request.generated, np.int64)) for s in sample]
    def decoding():
        return [r for r in sched.resident if r.state.value == "running"
                and len(r.generated) >= 2]

    residents = decoding()
    while not residents and (sched.queue or sched.resident):
        sched.step()  # after the window: until a request is decoding
        residents = decoding()
    picks = rng.permutation(len(residents))[:chk["resident"]]
    kv_rows = []
    pool = family.cache
    for i in picks:
        r = residents[i]
        n = int(pool.lengths_host[r.slot])
        pages = pool.page_table_host[r.slot][:-(-n // pool.page_size)]
        idx = torch.as_tensor(pages, dtype=torch.long, device=dev)

        def rows_of(p, scale):
            """The slot's first n rows as the attention reads them."""
            x = p[:, idx].float()
            if scale is not None:
                x = x * scale[:, idx][..., None]
            return x.reshape(p.shape[0], -1, *p.shape[3:])[:, :n]

        rows = [rows_of(pool.k_pages, pool.k_scale),
                rows_of(pool.v_pages, pool.v_scale)]  # float32
        seq = np.concatenate([r.prompt, np.asarray(r.generated[:-1])])
        kv_rows.append((seq, n, rows))  # n != len(seq): a fault, counted
    del sched, family, model, cache, pool, weights, spans, residents
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_cmp = time.perf_counter()
    checks, extra = compare(ctx, shape, sv["kv_dtype"], dev, served,
                            kv_rows, chk["limits"])
    notes.update(extra)
    notes.update(served_checked=int(sum(len(g) for _, g in served)),
                 requests_checked=len(served), residents_checked=len(kv_rows),
                 compare_s=time.perf_counter() - t_cmp)
    out = Outcome(attempted=len(window), failed=failed, checks=checks,
                  end_to_end=e2e, record=record, memory_peak_bytes=peak,
                  notes=notes)
    if tracer.summary:
        notes["trace_by_span_s"] = {
            span: sum(v[0] for v in ks.values())
            for span, ks in tracer.summary["by_span"].items()}
        notes["trace_device_ops"] = tracer.summary["n_device_ops"]
        out.busy_s = tracer.summary["busy_s"]
        out.window_s = tracer.summary["window_s"]
        out.breakdown = breakdown(tracer.summary)
    return out


def _logits(w, shape, kv_dtype, seq, tf32: bool):
    """The reference's logits (S, vocab) at every position of ``seq``."""
    tokens = torch.as_tensor(seq.astype(np.int64), device=w["embed"].device)
    x, _ = ref.forward(w, tokens, shape, kv_dtype, tf32=tf32)
    return ref.logits(w, x, tf32=tf32)


def _kv(w, shape, kv_dtype, seq, tf32: bool):
    """The reference's K and V rows of every layer for the tokens ``seq``."""
    tokens = torch.as_tensor(seq.astype(np.int64), device=w["embed"].device)
    return ref.forward(w, tokens, shape, kv_dtype, keep_kv=True,
                       tf32=tf32)[1]


def compare(ctx: Ctx, shape, kv_dtype, dev, served, kv_rows, limits):
    """The readings, and as checks those that ``limits`` names.

    ``token_mismatch``: the share of served tokens that are not the
    reference's greedy choice; ``token_gap``: the widest gap by which a
    served token's reference logit lies below the reference's best at its
    position, over the spread (standard deviation) of that position's
    reference logits.  ``kv_gap``: over the resident sample and every
    layer, the largest ``||rows - ref|| / ||ref||`` of a layer's K or V
    rows, read through the page tables; ``kv_gap_shallow``: the same over
    the first quarter of the layers, where rounding has grown least
    (``extra['kv_gap_by_layer']`` has each layer's).  Rows for tokens a
    request does not have read ``inf``.

    With ``ctx.control == "tf32"`` the reference computed in TF32 stands
    in the program's place and is judged the same way: its first choice
    at each served position, and its K/V rows of the residents' tokens.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tf32 = ctx.control == "tf32"
    w = ref.draw_weights(shape, ctx.seed, dev)
    gap, wrong, n_served = 0.0, 0, 0
    for prompt, gen in served:
        seq = np.concatenate([prompt, gen[:-1]])
        at = len(prompt) - 1
        lg = _logits(w, shape, kv_dtype, seq, tf32=False)[at:]
        g = torch.as_tensor(gen, device=dev)
        if tf32:
            g = _logits(w, shape, kv_dtype, seq, tf32=True)[at:].argmax(-1)
        best, choice = lg.max(dim=-1)
        got = lg.gather(1, g[:, None])[:, 0]
        gap = max(gap, float(((best - got) / lg.std(dim=-1)).max()))
        wrong += int((choice != g).sum())
        n_served += len(gen)
        del lg
    by_layer = torch.zeros(shape["layers"], dtype=torch.float64)
    for seq, n, rows in kv_rows:
        want = _kv(w, shape, kv_dtype, seq, tf32=False)
        if tf32:
            rows = [r.float() for r in _kv(w, shape, kv_dtype, seq, True)]
        if n != len(seq):  # rows for tokens the request does not have
            by_layer[:] = math.inf
            continue
        for p, r in zip(rows, want):
            r = r.float().flatten(1)
            g = ((p.flatten(1) - r).norm(dim=1) / r.norm(dim=1)).double()
            by_layer = torch.maximum(by_layer, g.cpu())
        del want, rows
    readings = {}
    if served:
        readings.update(token_gap=gap, token_mismatch=wrong / n_served)
    if kv_rows:
        readings.update(kv_gap=float(by_layer.max()), kv_gap_shallow=float(
            by_layer[:max(1, shape["layers"] // 4)].max()))
    # The traffic file's limits name the numbers compared; a number it
    # names that the run could not read counts as failed.
    checks = [Check(name, readings.get(name, math.nan), limit)
              for name, limit in limits.items()]
    extra = {"readings": readings,
             "kv_gap_by_layer": [float(x) for x in by_layer]}
    return checks, extra

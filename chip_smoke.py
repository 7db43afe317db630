#!/usr/bin/env python3
"""On-card check of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases, each of which fails the run (nonzero exit) if anything is off:

1. Setup: the card's name and power limit; the five CUDA sources of
   ``src/repro_torch/kernels/csrc`` built with ``nvcc`` in parallel.
2. Kernels: each of the seven serving kernels against its plain PyTorch
   version on the card.  The paged ones at the yi-6b serving shapes (H=32, KVH=4,
   D=128, page 16, batch 8; verify with K=4 queries per sequence), fp32
   and int8 pools; the strided converters at the rwkv6-3b and Mamba
   (yi-6b width) state-pool shapes, fp32 and bf16 rows, plus odd row
   widths.  Data movement must match bitwise, attention within rtol = atol
   = 1e-5 (float32 sums in another order).  A poison check puts NaN in
   every unmapped page: the attention outputs must stay finite.  Kernel,
   plain version and, where one PyTorch call computes the same function,
   that call are timed with CUDA events (median of 25).
3. Paper workloads: first the three workload kernels against their plain
   versions, then the port's workload functions (``repro_torch.workloads``)
   at sizes their users run, with the launch counts reset just before:
   ismt on a 16,384 x 16,384 fp32 matrix and on a ragged 12,345 x 6,789
   matrix in fp32 and bf16 (the tiled transpose, bitwise); spmv on an ELL
   matrix of 2**22 rows and columns, 32 entries a row of which Poisson(24)
   are live, columns uniform and sorted per row, built on the card from a
   seeded generator (the ELL SpMV, within rtol = atol = 1e-5: float32
   sums of a row in another order); pagerank, 20 iterations on the same
   graph with column-normalised weights through the SpMV kernel; sssp, 12
   Bellman-Ford sweeps (plain tensor code, bitwise against the CPU on a
   2**18-node graph); gemv_col and trmv at n = 16,384 (``torch.matmul``);
   then ``python -m repro_torch.workloads``' own run at n = 128, which
   checks all six against numpy and prints the modeled speed-ups of the
   port's bus model and bank simulator.  The panel-streamed SpMV, which no
   workload calls, is checked on 2**20 panel-sorted rows (K = 32, 4 steps,
   panel 512, row blocks of 64, C = 2**22) with a few entries outside
   their panel, which must be masked.  Kernel, plain version and the
   library call (``x.t().contiguous()``, the cuSPARSE CSR matvec) are
   timed with CUDA events.
4. Paged serving: full-width yi-6b (32 layers, d_model 4096, 32/4 heads,
   vocab 64000; random weights from a seeded torch.Generator) through the
   port's ``Scheduler``: 8 requests, prompts of 17-300 tokens, 32 new
   tokens each, batch 8, page 16, max_len 512, chunk 32.  First with fp32
   pools, then int8 pools in a pool tight enough to force evictions.  The
   token streams must equal ``static_batch_generate`` on the plain path
   (``impl='ref'``), and every kernel of the path must have launched.
   Then an isolated prefill and decode run gives tokens/s and launches per
   step.
5. Speculative serving: the same model, prompts and pools with
   ``spec_k = 4`` and an ``NGramDrafter``: the tokens must equal plain
   greedy (phase 4's ``static_batch_generate``), verify must have
   launched, and the int8 run must evict.
6. Recurrent serving: rwkv6-3b at full width (32 layers, d_model 2560,
   40 WKV heads, d_ff 8960, vocab 65536) and the Mamba block at yi-6b
   width, bf16 activations, random weights from a seeded generator,
   through the ``Scheduler`` with batch 8, the same 8 prompts and 32 new
   tokens.  The output must equal ``recurrent_reference_generate``
   bitwise; every admission zeroes its slot through the strided scatter,
   and a live slot read back through ``recurrent_state_read`` (the strided
   gather) must equal the pool's own view of it.

It prints a JSON line with one entry per kernel, the card's name and power
limit, and as its last line ``{"ok": true, "device": {...}}``.  Without a
GPU, or outside a checkout of the repository, it exits nonzero and prints
no result.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch

SEED = 0
SPEC_K = 4
N_TIMED = 25
SLEEP_CYCLES = 4_000_000   # ~2 ms of GPU clock: longer than a kernel call's
STEP_SLEEP_CYCLES = 100_000_000  # ~50 ms: longer than a decode step's
TOL = dict(rtol=1e-5, atol=1e-5)

# Serving shapes of the main path.
BATCH, PAGE, MAX_LEN, CHUNK = 8, 16, 512, 32
N_REQUESTS, MAX_NEW = 8, 32
PROMPT_LENS = (17, 300)

# Published peaks (NVIDIA data sheets, dense, at the full power limit):
# device-memory bytes/s and float32 FLOP/s outside the tensor cores.
PEAKS = {
    "H100 PCIe": (2.0e12, 51e12),
    "H100 NVL": (3.9e12, 60e12),
    "H100": (3.35e12, 67e12),       # SXM, "NVIDIA H100 80GB HBM3"
    "H200": (4.8e12, 67e12),
}

KERNELS = {
    # wrapper name: (source, TPU kernel it replaces)
    "indirect_gather": (
        "src/repro_torch/kernels/csrc/stream_converters.cu",
        "src/repro/kernels/stream_converters.py:126"),
    "indirect_scatter": (
        "src/repro_torch/kernels/csrc/stream_converters.cu",
        "src/repro/kernels/stream_converters.py:170"),
    "paged_decode_attention": (
        "src/repro_torch/kernels/csrc/paged_decode.cu",
        "src/repro/kernels/paged_decode.py:113"),
    "paged_prefill_attention": (
        "src/repro_torch/kernels/csrc/paged_prefill.cu",
        "src/repro/kernels/paged_prefill.py:141"),
    "paged_verify": (
        "src/repro_torch/kernels/csrc/paged_prefill.cu",
        "src/repro/kernels/paged_verify.py:39"),
    "strided_gather": (
        "src/repro_torch/kernels/csrc/stream_converters.cu",
        "src/repro/kernels/stream_converters.py:52"),
    "strided_scatter": (
        "src/repro_torch/kernels/csrc/stream_converters.cu",
        "src/repro/kernels/stream_converters.py:91"),
    "tiled_transpose": (
        "src/repro_torch/kernels/csrc/transpose.cu",
        "src/repro/kernels/transpose.py:22"),
    "spmv_ell": (
        "src/repro_torch/kernels/csrc/spmv.cu",
        "src/repro/kernels/spmv.py:36"),
    "spmv_ell_panel_kernel": (
        "src/repro_torch/kernels/csrc/spmv.cu",
        "src/repro/kernels/spmv.py:82"),
}
#: The record of each kernel that the JSON line reports: the paged ones at
#: fp32, the strided ones at their widest burst (rwkv6-3b's wkv state), the
#: workload ones at the workloads phase's full size.
REPORTED = {name: "fp32" for name in KERNELS}
REPORTED.update(strided_gather="rwkv6-3b s", strided_scatter="rwkv6-3b s",
                tiled_transpose="16384 fp32", spmv_ell="2^22 rows",
                spmv_ell_panel_kernel="2^20 rows")

# Sizes of the paper-workloads phase.
ISMT_N = 16384
RAGGED = (12345, 6789)
SPMV_R, SPMV_K, SPMV_NNZ = 1 << 22, 32, 24      # rows = columns, ELL width
PANEL_R, PANEL_STEPS, PANEL, PANEL_ROWS = 1 << 20, 4, 512, 64
PRANK_ITERS, SSSP_ITERS, SSSP_SUB = 20, 12, 1 << 18
WORKLOAD_KERNELS = ("tiled_transpose", "spmv_ell", "spmv_ell_panel_kernel")


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(*parts) -> None:
    print(*parts, flush=True)


def peaks_for(name: str):
    for key, peak in PEAKS.items():
        if key in name:
            return peak
    raise SmokeFailure(f"no published peaks on file for {name!r}")


def sync_ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def time_ms(fn, n: int = N_TIMED, sleep_cycles: int = SLEEP_CYCLES,
            flush=None) -> float:
    """Median device time of one call of ``fn`` over ``n`` runs.

    CUDA events around each call; before each, ``torch.cuda._sleep`` keeps
    the card busy while the host queues the call, so the events time the
    device's work and not the host's launch overhead.  A function that
    synchronizes inside (the plain scatter's boolean indexing) still pays
    its host time after the sync.  ``flush`` (a tensor larger than the L2
    cache) is overwritten before each call, so the call finds its data in
    device memory, as a caller that touched other data in between would.
    """
    for _ in range(3):
        fn()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(sleep_cycles)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def profile_step(fn, top: int = 6):
    """Device time of one call of ``fn`` by kernel, from ``torch.profiler``:
    the summed kernel time, the number of kernels run, and the ``top``
    kernels by time.  A step of more than ~1,000 launches fills the
    card's launch queue, so the host blocks inside a queued-ahead run and
    event timing (as :func:`throughput` uses for the paged decode step)
    overstates its device time; the profiler's sum does not.
    Returns ``None`` where the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    except Exception as err:  # noqa: BLE001 — a measurement, not a check
        log(f"profiler: not measured ({err})")
        return None
    rows = []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        if us > 0:
            rows.append((us, ev.count, ev.key))
    if not rows:
        return None
    rows.sort(reverse=True)
    return dict(
        busy_ms=sum(r[0] for r in rows) / 1e3,
        kernels=sum(r[1] for r in rows),
        top=[dict(name=k[:60], ms=us / 1e3, count=c)
             for us, c, k in rows[:top]])


# ---------------------------------------------------------------------------
# Phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------


def kernel_inputs(rng, dev, quantized, lens):
    """A yi-6b layer's pools, page table and lengths for 8 sequences."""
    kvh, d, h = 4, 128, 32
    n_pages = MAX_LEN // PAGE
    pool = BATCH * n_pages
    shape = (pool, PAGE, kvh, d)
    if quantized:
        kp = torch.randint(-127, 128, shape, dtype=torch.int8, device=dev)
        vp = torch.randint(-127, 128, shape, dtype=torch.int8, device=dev)
        ks = torch.rand(shape[:3], device=dev) * 0.02 + 0.001
        vs = torch.rand(shape[:3], device=dev) * 0.02 + 0.001
    else:
        kp = torch.randn(shape, device=dev)
        vp = torch.randn(shape, device=dev)
        ks = vs = None
    table = torch.tensor(
        rng.permutation(pool)[: BATCH * n_pages].reshape(BATCH, n_pages),
        dtype=torch.int32, device=dev)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    return h, kvh, d, kp, vp, ks, vs, table, lengths


def poison(kp, vp, ks, vs, table, live_tokens):
    """NaN into every page that no live token maps."""
    live = set()
    for row, n in zip(table.tolist(), live_tokens):
        live.update(row[: -(-int(n) // PAGE)])
    dead = torch.tensor([p for p in range(kp.shape[0]) if p not in live],
                        dtype=torch.long, device=kp.device)
    if ks is not None:
        ks = ks.clone().index_fill_(0, dead, float("nan"))
        vs = vs.clone().index_fill_(0, dead, float("nan"))
    else:
        kp = kp.clone().index_fill_(0, dead, float("nan"))
        vp = vp.clone().index_fill_(0, dead, float("nan"))
    return kp, vp, ks, vs


def check_kernels(ops, dev, lens, bw, flops):
    """Correctness, poison and timing of the four kernels; returns the
    per-kernel records (without launches) keyed by wrapper name."""
    rng = np.random.default_rng(SEED)
    records = {}
    sc = lambda ks, vs: {} if ks is None else dict(k_scale=ks, v_scale=vs)
    for quantized in (False, True):
        tag = "int8" if quantized else "fp32"
        h, kvh, d, kp, vp, ks, vs, table, lengths = kernel_inputs(
            rng, dev, quantized, lens)
        elem = 1 if quantized else 4
        pool = kp.shape[0]

        # -- decode: one query per sequence at the serving lengths.
        q = torch.randn(BATCH, h, d, device=dev)
        args = (q, kp, vp, table, lengths)
        run = lambda: ops.paged_decode_attention(*args, **sc(ks, vs))
        plain = lambda: ops.paged_decode_attention(*args, **sc(ks, vs),
                                                   impl="ref")
        got, want = run(), plain()
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        require(torch.allclose(got, want, **TOL),
                f"paged_decode {tag}: max abs err {err:.3e} over {TOL}")
        pk = poison(kp, vp, ks, vs, table, lens)
        out = ops.paged_decode_attention(q, pk[0], pk[1], table, lengths,
                                         **sc(pk[2], pk[3]))
        require(bool(torch.isfinite(out).all()),
                f"paged_decode {tag}: NaN from an unmapped page")
        live = int(sum(lens))
        nbytes = (live * kvh * (2 * d * elem + (8 if quantized else 0))
                  + 2 * q.numel() * 4
                  + sum(-(-n // PAGE) for n in lens) * 4 + BATCH * 4)
        nops = 4 * h * d * live
        records[("paged_decode_attention", tag)] = dict(
            max_abs_err=err, ms=time_ms(run), plain_ms=time_ms(plain),
            library_ms=None, bytes=nbytes, ops=nops)

        # -- prefill: 8 rows of a 32-token chunk, ragged, one padding row.
        starts = [0, 32, 64, 96, 128, 160, 256, 288]
        counts = [32, 32, 17, 32, 5, 32, 32, 0]
        live_r = [s + c if c else 0 for s, c in zip(starts, counts)]
        ctx = 1
        while ctx * PAGE < max(live_r):
            ctx *= 2
        qp = torch.randn(BATCH, CHUNK, h, d, device=dev)
        st = torch.tensor(starts, dtype=torch.int32, device=dev)
        ct = torch.tensor(counts, dtype=torch.int32, device=dev)
        ctx_rows = table[:, :ctx].contiguous()
        args = (qp, kp, vp, ctx_rows, st, ct)
        run = lambda: ops.paged_prefill_attention(*args, **sc(ks, vs))
        plain = lambda: ops.paged_prefill_attention(*args, **sc(ks, vs),
                                                    impl="ref")
        got, want = run(), plain()
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        require(torch.allclose(got, want, **TOL),
                f"paged_prefill {tag}: max abs err {err:.3e} over {TOL}")
        require(not got[ct == 0].any(), f"paged_prefill {tag}: padding row "
                "not exactly zero")
        pk = poison(kp, vp, ks, vs, table, live_r)
        out = ops.paged_prefill_attention(qp, pk[0], pk[1], ctx_rows, st, ct,
                                          **sc(pk[2], pk[3]))
        require(bool(torch.isfinite(out).all()),
                f"paged_prefill {tag}: NaN from an unmapped page")
        seen = sum(min(s + c + 1, lv) for s, lv in zip(starts, live_r)
                   if lv for c in range(CHUNK))
        nbytes = (sum(live_r) * kvh * (2 * d * elem + (8 if quantized else 0))
                  + 2 * qp.numel() * 4
                  + sum(-(-lv // PAGE) for lv in live_r) * 4 + 2 * BATCH * 4)
        nops = 4 * h * d * seen
        records[("paged_prefill_attention", tag)] = dict(
            max_abs_err=err, ms=time_ms(run), plain_ms=time_ms(plain),
            library_ms=None, bytes=nbytes, ops=nops)

        # -- verify: K queries per sequence at the serving lengths, one row
        #    clamped to 2 scored tokens and one padding row.
        vcounts = [SPEC_K] * (BATCH - 2) + [2, 0]
        vlive = [n + c if c else 0 for n, c in zip(lens, vcounts)]
        ctx = 1
        while ctx * PAGE < max(vlive):
            ctx *= 2
        qv = torch.randn(BATCH, SPEC_K, h, d, device=dev)
        vc = torch.tensor(vcounts, dtype=torch.int32, device=dev)
        ctx_rows = table[:, :ctx].contiguous()
        args = (qv, kp, vp, ctx_rows, lengths, vc)
        run = lambda: ops.paged_verify(*args, **sc(ks, vs))
        plain = lambda: ops.paged_verify(*args, **sc(ks, vs), impl="ref")
        got, want = run(), plain()
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        require(torch.allclose(got, want, **TOL),
                f"paged_verify {tag}: max abs err {err:.3e} over {TOL}")
        require(not got[vc == 0].any(), f"paged_verify {tag}: padding row "
                "not exactly zero")
        pk = poison(kp, vp, ks, vs, table, vlive)
        out = ops.paged_verify(qv, pk[0], pk[1], ctx_rows, lengths, vc,
                               **sc(pk[2], pk[3]))
        require(bool(torch.isfinite(out).all()),
                f"paged_verify {tag}: NaN from an unmapped page")
        seen = sum(n + i + 1 for n, c in zip(lens, vcounts)
                   for i in range(c))
        nbytes = (sum(vlive) * kvh * (2 * d * elem + (8 if quantized else 0))
                  + 2 * qv.numel() * 4
                  + sum(-(-lv // PAGE) for lv in vlive) * 4 + 2 * BATCH * 4)
        records[("paged_verify", tag)] = dict(
            max_abs_err=err, ms=time_ms(run), plain_ms=time_ms(plain),
            library_ms=None, bytes=nbytes, ops=4 * h * d * seen)

        # -- gather: the prefill window read, 3 pages for each of 8 rows.
        flat = kp.view(pool, -1)
        idx = table[:, :3].reshape(-1).contiguous()
        run = lambda: ops.indirect_gather(flat, idx)
        plain = lambda: ops.indirect_gather(flat, idx, impl="ref")
        got, want = run(), plain()
        torch.cuda.synchronize()
        require(torch.equal(got, want), f"indirect_gather {tag}: not bitwise")
        row = flat.shape[1] * flat.element_size()
        idx64 = idx.long()
        records[("indirect_gather", tag)] = dict(
            max_abs_err=0.0, ms=time_ms(run), plain_ms=time_ms(plain),
            library_ms=time_ms(lambda: torch.index_select(flat, 0, idx64)),
            bytes=2 * idx.numel() * row + idx.numel() * 4, ops=0)

        # -- scatter: the decode append, one row per sequence, one dropped.
        dst = kp.view(pool * PAGE, -1)
        packed = (torch.randint(-127, 128, (BATCH, dst.shape[1]),
                                dtype=torch.int8, device=dev) if quantized
                  else torch.randn(BATCH, dst.shape[1], device=dev))
        sidx = torch.tensor(rng.permutation(dst.shape[0])[:BATCH],
                            dtype=torch.int32, device=dev)
        sidx_drop = sidx.clone()
        sidx_drop[-1] = dst.shape[0]
        a, b = dst.clone(), dst.clone()
        ops.indirect_scatter(a, packed, sidx_drop)
        ops.indirect_scatter(b, packed, sidx_drop, impl="ref")
        torch.cuda.synchronize()
        require(torch.equal(a, b), f"indirect_scatter {tag}: not bitwise")
        del a, b
        run = lambda: ops.indirect_scatter(dst, packed, sidx)
        plain = lambda: ops.indirect_scatter(dst, packed, sidx, impl="ref")
        row = dst.shape[1] * dst.element_size()
        sidx64 = sidx.long()
        records[("indirect_scatter", tag)] = dict(
            max_abs_err=0.0, ms=time_ms(run), plain_ms=time_ms(plain),
            library_ms=time_ms(lambda: dst.index_copy_(0, sidx64, packed)),
            bytes=2 * BATCH * row + BATCH * 4, ops=0)

    records.update(check_strided(ops, dev))
    return add_bounds(records, bw, flops)


def add_bounds(records, bw, flops):
    """Each record's least time on the card: its bytes over the memory
    rate or its operations over the fp32 rate, whichever is larger."""
    for rec in records.values():
        t_bytes = rec["bytes"] / bw * 1e3
        t_ops = rec["ops"] / flops * 1e3
        rec["bound_ms"] = max(t_bytes, t_ops)
        rec["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    return records


def state_pools():
    """``{tag: ((L, B, *row), dtype)}``: the recurrent state pools of the
    serving phase, from the port's own state layouts at full width."""
    from repro_torch.configs import get_config
    from repro_torch.models import mamba, rwkv6

    out = {}
    for label, cfg, specs in (
            ("rwkv6-3b", get_config("rwkv6-3b"), rwkv6.rwkv_state_specs),
            ("mamba", get_config("yi-6b"), mamba.mamba_state_specs)):
        for name, (row, dtype) in specs(cfg).items():
            out[f"{label} {name}"] = ((cfg.n_layers, BATCH) + row, dtype)
    return out


def check_strided(ops, dev):
    """The strided converters against their plain versions: bitwise at
    the recurrent state-pool shapes (slot 3 of 8) and at odd row widths
    (16-, 4- and 1-byte copy units), timed at the pool shapes."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for rows, width, dtype in ((64, 37, torch.int8), (64, 3, torch.bfloat16),
                               (64, 5, torch.float32), (40, 384, torch.int8)):
        src = torch.randint(-100, 100, (rows, width), generator=gen,
                            device=dev).to(dtype)
        packed = torch.randint(-100, 100, (rows // 4, width), generator=gen,
                               device=dev).to(dtype)
        for base, stride in ((1, 3), (2, 4), (5, 0)):
            count = rows // 4
            require(torch.equal(
                ops.strided_gather(src, base, stride, count),
                ops.strided_gather(src, base, stride, count, impl="ref")),
                f"strided_gather {tuple(src.shape)} {dtype}: not bitwise")
            if stride:
                a = ops.strided_scatter(src.clone(), packed, base, stride)
                b = ops.strided_scatter(src.clone(), packed, base, stride,
                                        impl="ref")
                require(torch.equal(a, b), f"strided_scatter "
                        f"{tuple(src.shape)} {dtype}: not bitwise")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    records = {}
    slot = 3
    for tag, (shape, dtype) in state_pools().items():
        l, b = shape[:2]
        pool = torch.randn(shape, generator=gen, device=dev).to(dtype)
        flat = pool.view(l * b, -1)
        value = torch.randn((l,) + shape[2:], generator=gen,
                            device=dev).to(dtype)
        packed = value.view(l, -1)
        got = ops.strided_gather(flat, slot, b, l)
        require(torch.equal(got, ops.strided_gather(flat, slot, b, l,
                                                    impl="ref")),
                f"strided_gather {tag}: not bitwise")
        a = ops.strided_scatter(flat.clone(), packed, slot, b)
        want = ops.strided_scatter(flat.clone(), packed, slot, b, impl="ref")
        torch.cuda.synchronize()
        require(torch.equal(a, want), f"strided_scatter {tag}: not bitwise")
        del a, want
        row = flat.shape[1] * flat.element_size()
        nbytes = 2 * l * row
        records[("strided_gather", tag)] = dict(
            max_abs_err=0.0,
            ms=time_ms(lambda: ops.strided_gather(flat, slot, b, l),
                       flush=flush),
            plain_ms=time_ms(lambda: ops.strided_gather(
                flat, slot, b, l, impl="ref"), flush=flush),
            library_ms=time_ms(lambda: pool[:, slot].clone(), flush=flush),
            bytes=nbytes, ops=0)
        records[("strided_scatter", tag)] = dict(
            max_abs_err=0.0,
            ms=time_ms(lambda: ops.strided_scatter(flat, packed, slot, b),
                       flush=flush),
            plain_ms=time_ms(lambda: ops.strided_scatter(
                flat, packed, slot, b, impl="ref"), flush=flush),
            library_ms=time_ms(lambda: pool[:, slot].copy_(value),
                               flush=flush),
            bytes=nbytes, ops=0)
        del pool, flat, value, packed
    return records


# ---------------------------------------------------------------------------
# Phase 3: the paper's workloads
# ---------------------------------------------------------------------------


def ell_graph(dev, gen, rows, k, live_mean, n_cols):
    """A random ELL matrix made on the card: Poisson(live_mean) live entries
    a row, clipped to [1, k], columns uniform in [0, n_cols) and sorted per
    row, values N(0, 1).  Padding entries have value 0 and column 0, as
    ``csr_to_ell`` leaves them.  Returns (vals, cols int32, live mask)."""
    live_n = torch.poisson(torch.full((rows,), float(live_mean), device=dev),
                           generator=gen).clamp_(1, k).to(torch.int32)
    live = torch.arange(k, device=dev, dtype=torch.int32) < live_n[:, None]
    cols = torch.randint(0, n_cols, (rows, k), generator=gen, device=dev,
                         dtype=torch.int32)
    cols = torch.where(live, cols, n_cols).sort(dim=1).values  # live first
    cols = torch.where(live, cols, 0)
    vals = torch.randn((rows, k), generator=gen, device=dev)
    return torch.where(live, vals, 0.0), cols, live


def csr_of(vals, cols, live, n_cols):
    """The live entries of an ELL matrix as an ``(R, n_cols)``
    ``torch.sparse_csr_tensor`` (int32 indices), for the library's
    matvec."""
    crow = torch.zeros(vals.shape[0] + 1, dtype=torch.int32,
                       device=vals.device)
    crow[1:] = live.sum(1).cumsum(0)
    with warnings.catch_warnings():  # "beta state", "invariant checks off"
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(crow, cols[live], vals[live],
                                       (vals.shape[0], n_cols))


def check_workload_kernels(ops, ref, dev, bw, flops, graph):
    """The transpose, ELL SpMV and panel SpMV kernels against their plain
    versions at the workloads phase's sizes, timed; returns the records
    keyed by (wrapper name, tag)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    records = {}

    # -- tiled transpose: bitwise, square fp32 and ragged fp32 / bf16.
    for shape, dtype in (((ISMT_N, ISMT_N), torch.float32),
                         (RAGGED, torch.float32), (RAGGED, torch.bfloat16)):
        x = torch.randn(shape, generator=gen, device=dev).to(dtype)
        got, want = ops.tiled_transpose(x), ref.tiled_transpose(x)
        torch.cuda.synchronize()
        require(torch.equal(got, want),
                f"tiled_transpose {shape} {dtype}: not bitwise")
        del got, want
        if shape[0] == ISMT_N:
            records[("tiled_transpose", REPORTED["tiled_transpose"])] = dict(
                max_abs_err=0.0, ms=time_ms(lambda: ops.tiled_transpose(x)),
                plain_ms=time_ms(lambda: ref.tiled_transpose(x)),
                library_ms=time_ms(lambda: x.t().contiguous()),
                bytes=2 * x.numel() * x.element_size(), ops=0)
        del x
    torch.cuda.empty_cache()

    # -- ELL SpMV at the workload's size, and a ragged K with out-of-range
    #    columns (clipped), both within TOL of the plain version.
    vals, cols, live, x = (graph[k] for k in ("vals", "cols", "live", "x"))
    got = ops.spmv_ell(vals, cols, x)
    want = ref.spmv_ell(vals, cols, x)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    require(torch.allclose(got, want, **TOL),
            f"spmv_ell 2^22: max abs err {err:.3e} over {TOL}")
    graph["y_plain"] = want
    rv = torch.randn((4099, 5), generator=gen, device=dev)
    rc = torch.randint(-9, 1 << 20, (4099, 5), generator=gen, device=dev,
                       dtype=torch.int32)
    rx = torch.randn((1 << 20) - 7, generator=gen, device=dev)
    require(torch.allclose(ops.spmv_ell(rv, rc, rx), ref.spmv_ell(rv, rc, rx),
                           **TOL), "spmv_ell ragged K, clipped columns")
    csr = csr_of(vals, cols, live, x.numel())
    require(torch.allclose(torch.mv(csr, x), want, **TOL),
            "cuSPARSE CSR matvec disagrees with the plain spmv")
    nbytes = vals.numel() * 8 + x.numel() * 4 + vals.shape[0] * 4
    records[("spmv_ell", REPORTED["spmv_ell"])] = dict(
        max_abs_err=err, ms=time_ms(lambda: ops.spmv_ell(vals, cols, x)),
        plain_ms=time_ms(lambda: ref.spmv_ell(vals, cols, x)),
        library_ms=time_ms(lambda: torch.mv(csr, x)),
        bytes=nbytes, ops=2 * int(live.sum()))
    del got, csr
    torch.cuda.empty_cache()

    # -- panel SpMV: panel-sorted columns, plus 1 in 64 entries moved to
    #    another panel, which the kernel must mask.
    row_blocks, kb = PANEL_R // PANEL_ROWS, SPMV_K // PANEL_STEPS
    n_panels = SPMV_R // PANEL
    pids = torch.randint(0, n_panels, (row_blocks, PANEL_STEPS),
                         generator=gen, device=dev, dtype=torch.int32)
    base = (pids.repeat_interleave(PANEL_ROWS, 0)
            .repeat_interleave(kb, 1) * PANEL)
    pc = base + torch.randint(0, PANEL, (PANEL_R, SPMV_K), generator=gen,
                              device=dev, dtype=torch.int32)
    stray = torch.rand((PANEL_R, SPMV_K), generator=gen, device=dev) < 1 / 64
    shift = torch.randint(1, n_panels, (PANEL_R, SPMV_K), generator=gen,
                          device=dev, dtype=torch.int32) * PANEL
    pc = torch.where(stray, (pc + shift) % SPMV_R, pc)
    pv = torch.randn((PANEL_R, SPMV_K), generator=gen, device=dev)
    run = lambda: ops.spmv_ell_panel_kernel(pv, pc, x, pids, panel=PANEL)
    plain = lambda: ref.spmv_ell_panel(pv, pc, x, pids, panel=PANEL)
    got, want = run(), plain()
    torch.cuda.synchronize()
    perr = (got - want).abs().max().item()
    require(torch.allclose(got, want, **TOL),
            f"spmv_ell_panel_kernel: max abs err {perr:.3e} over {TOL}")
    unmasked = ref.spmv_ell(pv, pc, x)
    require(bool(stray.any()) and not torch.allclose(got, unmasked, **TOL),
            "spmv_ell_panel_kernel: the stray entries were not masked")
    inside = ~stray
    csr = csr_of(pv, pc, inside, x.numel())
    require(torch.allclose(torch.mv(csr, x), want, **TOL),
            "cuSPARSE CSR matvec disagrees with the plain panel spmv")
    panel_bytes = row_blocks * PANEL_STEPS * PANEL * 4
    records[("spmv_ell_panel_kernel", REPORTED["spmv_ell_panel_kernel"])] = \
        dict(max_abs_err=perr, ms=time_ms(run), plain_ms=time_ms(plain),
             library_ms=time_ms(lambda: torch.mv(csr, x)),
             bytes=pv.numel() * 8 + x.numel() * 4 + PANEL_R * 4,
             ops=2 * int(inside.sum()), panel_bytes_read=panel_bytes)
    del pv, pc, pids, base, stray, shift, got, want, unmasked, csr
    torch.cuda.empty_cache()
    return add_bounds(records, bw, flops)


def make_graph(dev):
    """The workloads' graph: the spmv matrix, its x, and the PageRank and
    SSSP weights on the same edges."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    vals, cols, live = ell_graph(dev, gen, SPMV_R, SPMV_K, SPMV_NNZ, SPMV_R)
    x = torch.rand(SPMV_R, generator=gen, device=dev) * 2 - 1
    out_deg = torch.bincount(cols[live], minlength=SPMV_R).float()
    pvals = torch.where(live, 1.0 / out_deg[cols.long()].clamp(min=1), 0.0)
    wvals = torch.where(live, vals.abs() + 0.1, 0.0)
    return dict(vals=vals, cols=cols, live=live, x=x, pvals=pvals,
                wvals=wvals)


def run_workloads(W, cli, dev, graph):
    """The main path of the phase: the workload functions as a user calls
    them.  Returns per-workload records (wall ms of one call, the bytes it
    must move, GB/s) and the results to check."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    res, recs = {}, {}

    def timed(name, fn, nbytes, reps=3):
        """Median wall time of ``reps`` calls, each ending in a sync."""
        ms = []
        for _ in range(reps):
            ms.append(sync_ms(lambda: res.__setitem__(name, fn())))
        wall = statistics.median(ms)
        recs[name] = dict(ms=wall, bytes=nbytes, gb_per_s=nbytes / wall / 1e6)

    a = torch.randn((ISMT_N, ISMT_N), generator=gen, device=dev)
    timed("ismt", lambda: W.ismt(a), 2 * a.numel() * 4)
    require(torch.equal(res["ismt"][0], a.t()), "ismt: not bitwise a.T")
    res.pop("ismt")
    for dtype in (torch.float32, torch.bfloat16):
        r = torch.randn(RAGGED, generator=gen, device=dev).to(dtype)
        out, _ = W.ismt(r)
        require(torch.equal(out, r.t()), f"ismt {RAGGED} {dtype}: not bitwise")
        del r, out
    xv = torch.randn(ISMT_N, generator=gen, device=dev)
    for name in ("gemv_col", "trmv"):
        timed(name, lambda: getattr(W, name)(a, xv), a.numel() * 4)
        y = res.pop(name)[0]
        m = torch.triu(a[:64]) if name == "trmv" else a[:64]
        want = m.double() @ xv.double()
        rel = ((y[:64].double() - want).abs().max() / want.abs().max()).item()
        require(bool(torch.isfinite(y).all()) and rel < 1e-5,
                f"{name}: relative error {rel:.3e} against float64")
        recs[name]["rel_err_vs_fp64"] = rel
    del a, xv
    torch.cuda.empty_cache()

    vals, cols, live, x = (graph[k] for k in ("vals", "cols", "live", "x"))
    spmv_bytes = vals.numel() * 8 + x.numel() * 4 + SPMV_R * 4
    timed("spmv", lambda: W.spmv(vals, cols, x), spmv_bytes)
    y, tr = res.pop("spmv")
    require(torch.allclose(y, graph["y_plain"], **TOL),
            "spmv: disagrees with the plain path")
    recs["spmv"].update(tr)
    pv = graph["pvals"]
    timed("pagerank", lambda: W.pagerank(pv, cols, SPMV_R, iters=PRANK_ITERS,
                                         impl="cuda"),
          PRANK_ITERS * spmv_bytes)
    ranks, tr = res.pop("pagerank")
    recs["pagerank"].update(tr, rank_sum=float(ranks.sum()))
    res["ranks"] = ranks
    wv = graph["wvals"]
    sweep_bytes = vals.numel() * 9 + 2 * SPMV_R * 4
    timed("sssp", lambda: W.sssp(wv, cols, live, src=0, n=SPMV_R,
                                 iters=SSSP_ITERS),
          SSSP_ITERS * sweep_bytes)
    dist, tr = res.pop("sssp")
    require(float(dist[0]) == 0.0 and bool((dist <= 1e30).all()),
            "sssp: distances out of range")
    recs["sssp"].update(tr, reachable=int((dist < 1e29).sum()))

    # sparse_ops' own run at n = 128, checked against numpy inside.
    t0 = time.perf_counter()
    rows = cli.run(dev, n=128)
    recs["sparse_ops n=128"] = dict(seconds=time.perf_counter() - t0)
    return recs, res, rows


def check_workload_results(W, graph, res):
    """The main path's results against the plain path: PageRank within
    rtol 1e-5 (positive sums, so the error stays relative), SSSP bitwise
    against the CPU on a 2**18-node graph: the first 2**18 rows with their
    columns folded into [0, 2**18), so each keeps its live entries and
    most nodes are reached."""
    vals, cols, live = graph["vals"], graph["cols"], graph["live"]
    want, _ = W.pagerank(graph["pvals"], cols, SPMV_R, iters=PRANK_ITERS,
                         impl="ref")
    got = res["ranks"]
    err = ((got - want).abs() / want.abs()).max().item()
    require(err < 1e-5, f"pagerank: max relative error {err:.3e} against "
            "the plain path")
    sub = slice(0, SSSP_SUB)
    mask = live[sub]
    sc = cols[sub] % SSSP_SUB
    wv = graph["wvals"][sub]
    d_card, _ = W.sssp(wv, sc, mask, src=0, n=SSSP_SUB, iters=SSSP_ITERS)
    d_cpu, _ = W.sssp(wv.cpu(), sc.cpu(), mask.cpu(), src=0, n=SSSP_SUB,
                      iters=SSSP_ITERS)
    reached = int((d_cpu < 1e29).sum())
    require(reached > SSSP_SUB // 2,
            f"sssp: only {reached} of {SSSP_SUB} nodes reached on the CPU")
    require(torch.equal(d_card.cpu(), d_cpu),
            "sssp: the card's distances differ from the CPU's")
    return dict(pagerank_max_rel_err=err, sssp_subgraph_reachable=reached)


# ---------------------------------------------------------------------------
# Phase 4: full-width serving through the scheduler
# ---------------------------------------------------------------------------


def make_prompts(vocab: int):
    rng = np.random.default_rng(SEED)
    lens = rng.integers(PROMPT_LENS[0], PROMPT_LENS[1] + 1, N_REQUESTS)
    return [rng.integers(0, vocab, int(n)).astype(np.int32) for n in lens]


def tight_pool(prompts) -> int:
    """A third of the pages all requests would need at once (and room for
    the longest): the scheduler must evict and replay to serve them.  With
    the seeded prompts this pool forces 5 evictions; the run checks >= 1."""
    need = [-(-(len(p) + MAX_NEW - 1) // PAGE) for p in prompts]
    return max(max(need) + 1, sum(need) // 3)


def serve(serve_mod, cfg, dev, params, kv_dtype, prompts, pool_pages=None):
    """Scheduler on the kernels vs static batch on the plain path.

    Returns (scheduler outputs, static outputs, scheduler, launch counts
    of the scheduler run, seconds)."""
    from repro_torch.kernels import ops

    model = serve_mod.PagedLM(cfg, kv_dtype=kv_dtype, device=dev,
                              params=params)
    cache = serve_mod.PagedKVCache.create(
        cfg, batch=BATCH, max_len=MAX_LEN, page=PAGE, pool_pages=pool_pages,
        kv_dtype=kv_dtype, device=dev)
    sched = serve_mod.Scheduler(model, cache, chunk=CHUNK)
    for i, p in enumerate(prompts):
        sched.submit(serve_mod.Request(rid=i, prompt=p, max_new=MAX_NEW))
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = sched.run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = ops.launch_counts()
    plain = serve_mod.PagedLM(cfg, impl="ref", kv_dtype=kv_dtype, device=dev,
                              params=params)
    static = serve_mod.static_batch_generate(
        plain, serve_mod.PagedKVCache.create(
            cfg, batch=BATCH, max_len=MAX_LEN, page=PAGE, kv_dtype=kv_dtype,
            device=dev),
        prompts, MAX_NEW, chunk=CHUNK)
    return out, static, sched, launches, seconds


def first_divergence(out, static):
    for rid in sorted(static):
        a, b = out.get(rid, []), static[rid]
        for i in range(max(len(a), len(b))):
            if i >= len(a) or i >= len(b) or a[i] != b[i]:
                return (f"request {rid} token {i}: scheduler "
                        f"{a[i] if i < len(a) else None} vs plain "
                        f"{b[i] if i < len(b) else None}")
    return None


def throughput(serve_mod, cfg, dev, params, prompts):
    """Isolated prefill of all prompts (rows of 8) and 32 decode steps at
    batch 8, fp32 pools; tokens/s and kernel launches per step."""
    from repro_torch.kernels import ops
    from repro_torch.serve.scheduler import build_prefill_rows

    model = serve_mod.PagedLM(cfg, kv_dtype="fp32", device=dev, params=params)
    cache = serve_mod.PagedKVCache.create(
        cfg, batch=BATCH, max_len=MAX_LEN, page=PAGE, kv_dtype="fp32",
        device=dev)
    for i, p in enumerate(prompts):
        cache = cache.allocate(i, cache.pages_for(len(p) + MAX_NEW))
    pos = [0] * len(prompts)
    steps = []
    while any(pos[i] < len(p) for i, p in enumerate(prompts)):
        items = [(p, pos[i], i) for i, p in enumerate(prompts)
                 if pos[i] < len(p)]
        steps.append(build_prefill_rows(items, CHUNK, BATCH))
        for p, s, i in items:
            pos[i] = min(len(p), s + CHUNK)
    box = {"cache": cache}

    def prefill_all():
        c = box["cache"]
        for toks, counts, slots, starts in steps:
            logits, c = model.prefill_batch(toks, counts, slots, starts, c)
        box["cache"] = c

    ops.reset_launch_counts()
    t_prefill = sync_ms(prefill_all) / 1e3
    prefill_launches = ops.launch_counts()
    n_chunks = len(steps)
    tokens = np.zeros((BATCH,), np.int32)
    active = np.ones((BATCH,), bool)
    ops.reset_launch_counts()

    def decode():
        toks, box["cache"] = model.decode_steps(tokens, box["cache"], active,
                                                MAX_NEW)

    t_decode = sync_ms(decode) / 1e3
    decode_launches = ops.launch_counts()
    # Device time of one decode step with the whole step queued ahead of
    # the card: what the step costs the GPU.  The rest of the wall-clock
    # step is the card idle, waiting on the host to launch.
    feed = torch.zeros((BATCH,), dtype=torch.int32, device=dev)
    act = torch.ones((BATCH,), dtype=torch.bool, device=dev)
    c = box["cache"]
    step_device_ms = time_ms(lambda: model._step(feed, c, c.lengths, act),
                             n=5, sleep_cycles=STEP_SLEEP_CYCLES)
    step_wall_ms = t_decode * 1e3 / MAX_NEW
    n_prompt = sum(len(p) for p in prompts)
    return dict(
        prefill_tokens=n_prompt, prefill_s=t_prefill,
        prefill_tokens_per_s=n_prompt / t_prefill,
        prefill_chunk_steps=n_chunks,
        launches_per_prefill_step={k: v / n_chunks
                                   for k, v in prefill_launches.items()},
        decode_tokens=BATCH * MAX_NEW, decode_s=t_decode,
        decode_tokens_per_s=BATCH * MAX_NEW / t_decode,
        launches_per_decode_step={k: v / MAX_NEW
                                  for k, v in decode_launches.items()},
        decode_step_wall_ms=step_wall_ms,
        decode_step_device_ms=step_device_ms,
        decode_device_idle_share=1.0 - step_device_ms / step_wall_ms,
    )


# ---------------------------------------------------------------------------
# Phase 5: speculative serving
# ---------------------------------------------------------------------------


def serve_spec(serve_mod, cfg, dev, params, kv_dtype, prompts,
               pool_pages=None):
    """The scheduler with ``spec_k = SPEC_K`` and an n-gram drafter on the
    kernels.  Returns (outputs, scheduler, launch counts, seconds)."""
    from repro_torch.kernels import ops

    model = serve_mod.PagedLM(cfg, kv_dtype=kv_dtype, device=dev,
                              params=params, spec_k=SPEC_K,
                              drafter=serve_mod.NGramDrafter(cfg.vocab))
    cache = serve_mod.PagedKVCache.create(
        cfg, batch=BATCH, max_len=MAX_LEN, page=PAGE, pool_pages=pool_pages,
        kv_dtype=kv_dtype, device=dev)
    sched = serve_mod.Scheduler(model, cache, chunk=CHUNK)
    for i, p in enumerate(prompts):
        sched.submit(serve_mod.Request(rid=i, prompt=p, max_new=MAX_NEW))
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = sched.run()
    torch.cuda.synchronize()
    return out, sched, ops.launch_counts(), time.perf_counter() - t0


# ---------------------------------------------------------------------------
# Phase 6: recurrent serving
# ---------------------------------------------------------------------------


def serve_recurrent(serve_mod, cfg, arch, dev, prompts):
    """Scheduler vs ``recurrent_reference_generate`` on one recurrent model.

    The scheduler is stepped by hand so that, at the first step where a
    request is decoding, its live slot is read back through
    ``recurrent_state_read`` and held against the pool's own view.
    Then one batch-8 decode step of the model is timed on the host clock
    and by the profiler's kernel times (see :func:`profile_step`).
    Returns (outputs, reference outputs, scheduler, launch counts of the
    served run, seconds, whether the read-back matched, step timing)."""
    from repro_torch.kernels import ops

    gen = torch.Generator(device=dev).manual_seed(SEED)
    model = serve_mod.RecurrentLM(cfg, generator=gen, arch=arch, device=dev)
    sched = serve_mod.Scheduler(model, model.init_pool(BATCH), chunk=CHUNK)
    for i, p in enumerate(prompts):
        sched.submit(serve_mod.Request(rid=i, prompt=p, max_new=MAX_NEW))
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    read_ok = None
    while sched.queue or sched.resident:
        sched.step()
        live = [r for r in sched.resident if r.generated and not r.done]
        if read_ok is None and live:
            slot = live[0].slot
            pool = sched.family.pool.tensors
            read_ok = all(
                torch.equal(ops.recurrent_state_read(t, slot), t[:, slot])
                for t in pool.values())
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = ops.launch_counts()
    out = {rid: r.generated for rid, r in sorted(sched.finished.items())}
    pool = model.init_pool(BATCH)
    want = serve_mod.recurrent_reference_generate(
        model, pool, prompts, MAX_NEW, chunk=CHUNK)
    cur = torch.zeros((BATCH,), dtype=torch.int32, device=dev)
    act = torch.ones((BATCH,), dtype=torch.bool, device=dev)
    step = lambda: model._step(pool.tensors, cur, None, act)
    wall_ms = statistics.median(sync_ms(step) for _ in range(5))
    timing = dict(step_wall_ms=wall_ms, device_busy_ms="not measured")
    prof = profile_step(step)
    if prof is not None:
        timing.update(device_busy_ms=prof["busy_ms"],
                      device_idle_share=1.0 - prof["busy_ms"] / wall_ms,
                      kernels_per_step=prof["kernels"], top=prof["top"])
    return (out, dict(enumerate(want)), sched, launches, seconds, read_ok,
            timing)


# ---------------------------------------------------------------------------


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on an NVIDIA GPU",
              file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parent
    if not (root / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {root} is not a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(root / "src"))
    from repro_torch import resolve_device
    from repro_torch import serve as serve_mod
    from repro_torch.configs import get_config
    from repro_torch.kernels import build, ops

    # -- phase 1: setup -------------------------------------------------------
    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    dev = resolve_device("cuda")
    name = torch.cuda.get_device_name(0)
    bw, flops = peaks_for(name)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {name}; "
        f"peaks {bw / 1e12} TB/s, {flops / 1e12} fp32 TFLOP/s")
    t0 = time.perf_counter()
    libs = build.build_all()
    log(f"built {len(libs)} kernel libraries in "
        f"{time.perf_counter() - t0:.1f} s")
    for lib in libs.values():
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {lib.stem}: {line.strip()}")

    phase_s = {"setup": time.perf_counter() - t_start}
    cfg = get_config("yi-6b")
    prompts = make_prompts(cfg.vocab)
    lens = [len(p) + MAX_NEW // 2 for p in prompts]

    # -- phase 2: kernels vs plain versions -----------------------------------
    t0 = time.perf_counter()
    records = check_kernels(ops, dev, lens, bw, flops)
    for (kname, tag), rec in sorted(records.items()):
        log(f"kernel {kname} [{tag}]: " + json.dumps(rec))
    phase_s["kernels"] = time.perf_counter() - t0

    # -- phase 3: the paper's workloads ---------------------------------------
    t0 = time.perf_counter()
    import repro_torch.workloads.__main__ as cli
    from repro_torch.kernels import ref
    from repro_torch.workloads import impls as W

    graph = make_graph(dev)
    records.update(check_workload_kernels(ops, ref, dev, bw, flops, graph))
    for key in [k for k in records if k[0] in WORKLOAD_KERNELS]:
        log(f"kernel {key[0]} [{key[1]}]: " + json.dumps(records[key]))
    launches = {k: 0 for k in ops.launch_counts()}
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    recs, res, rows = run_workloads(W, cli, dev, graph)
    counts = ops.launch_counts()
    for k, v in counts.items():
        launches[k] += v
    log(f"workloads ({smi}): " + json.dumps(recs))
    log("workloads check: " + json.dumps(check_workload_results(W, graph,
                                                                 res)))
    for r in rows:
        m = r["model"]
        log(f"sparse_ops n=128 {r['name']}: traffic eff base "
            f"{r['base_eff']:.4f} -> pack {r['pack_eff']:.4f}; modeled "
            f"speedup PACK {m.speedup_pack:.4f}x, IDEAL "
            f"{m.speedup_ideal:.4f}x, PACK bus util {m.util_pack:.4f}")
    log(f"workloads launches {counts}")
    require(counts["tiled_transpose"] >= 1 and counts["spmv_ell"] >= 21,
            f"workloads: a kernel of the path never launched: {counts}")
    del graph, res
    torch.cuda.empty_cache()
    phase_s["paper workloads"] = time.perf_counter() - t0

    # -- phase 4: paged serving, full-width yi-6b -----------------------------
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = serve_mod.PagedLM(cfg, generator=gen, kv_dtype="fp32",
                               device=dev).params
    weight_gb = sum(t.numel() * 4 for t in params.values()) / 1e9
    log(f"yi-6b: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads, vocab {cfg.vocab}; "
        f"{weight_gb:.2f} GB of fp32 weights; prompts "
        f"{[len(p) for p in prompts]}")
    statics = {}
    paged_kernels = ("indirect_gather", "indirect_scatter",
                     "paged_decode_attention", "paged_prefill_attention")
    for kv_dtype in ("fp32", "int8"):
        pool = tight_pool(prompts) if kv_dtype == "int8" else None
        out, static, sched, counts, secs = serve(
            serve_mod, cfg, dev, params, kv_dtype, prompts, pool)
        statics[kv_dtype] = static
        for k, v in counts.items():
            launches[k] += v
        div = first_divergence(out, static)
        st = sched.stats
        log(f"serve {kv_dtype}: pool {sched.cache.total_pages} pages, "
            f"{st.tokens} tokens in {secs:.3f} s "
            f"({st.tokens / secs:.1f} tokens/s), {st.n_evictions} evictions, "
            f"{st.prefill_steps} prefill steps, {st.decode_steps} decode "
            f"steps; launches {counts}; streams equal to plain path: "
            f"{div is None}")
        require(div is None, f"serve {kv_dtype}: first divergence at {div}")
        require(sorted(out) == list(range(N_REQUESTS))
                and all(len(t) == MAX_NEW for t in out.values()),
                f"serve {kv_dtype}: not every request finished")
        require(all(counts[k] > 0 for k in paged_kernels),
                f"serve {kv_dtype}: a kernel never launched: {counts}")
        if kv_dtype == "int8":
            require(st.n_evictions >= 1,
                    "serve int8: the tight pool forced no eviction")
    tp = throughput(serve_mod, cfg, dev, params, prompts)
    log(f"throughput fp32 ({smi}): " + json.dumps(tp))
    phase_s["paged serving"] = time.perf_counter() - t0

    # -- phase 5: speculative serving, full-width yi-6b -----------------------
    t0 = time.perf_counter()
    for kv_dtype in ("fp32", "int8"):
        pool = tight_pool(prompts) if kv_dtype == "int8" else None
        out, sched, counts, secs = serve_spec(
            serve_mod, cfg, dev, params, kv_dtype, prompts, pool)
        for k, v in counts.items():
            launches[k] += v
        div = first_divergence(out, statics[kv_dtype])
        st = sched.stats
        log(f"serve spec_k={SPEC_K} {kv_dtype} ({smi}): pool "
            f"{sched.cache.total_pages} pages, {st.tokens} tokens in "
            f"{secs:.3f} s ({st.tokens / secs:.1f} tokens/s), "
            f"{st.spec_steps} verify steps, acceptance rate "
            f"{st.acceptance_rate:.4f} ({st.n_accepted}/{st.n_drafted} "
            f"drafts), {st.n_evictions} evictions; launches {counts}; "
            f"streams equal to plain greedy: {div is None}")
        require(div is None,
                f"serve spec {kv_dtype}: first divergence at {div}")
        require(sorted(out) == list(range(N_REQUESTS))
                and all(len(t) == MAX_NEW for t in out.values()),
                f"serve spec {kv_dtype}: not every request finished")
        require(st.spec_steps > 0 and counts["paged_verify"] > 0
                and counts["indirect_scatter"] > 0
                and counts["indirect_gather"] > 0,
                f"serve spec {kv_dtype}: verify never launched: {counts}")
        if kv_dtype == "int8":
            require(st.n_evictions >= 1,
                    "serve spec int8: the tight pool forced no eviction")
    del params, sched
    torch.cuda.empty_cache()
    phase_s["speculative serving"] = time.perf_counter() - t0

    # -- phase 6: recurrent serving, rwkv6-3b and Mamba at yi-6b width --------
    for label, rcfg, arch in (("rwkv6-3b", get_config("rwkv6-3b"), "rwkv6"),
                              ("mamba", cfg, "mamba")):
        t0 = time.perf_counter()
        out, want, sched, counts, secs, read_ok, timing = serve_recurrent(
            serve_mod, rcfg, arch, dev, prompts)
        for k, v in counts.items():
            launches[k] += v
        div = first_divergence(out, want)
        st = sched.stats
        fam = sched.family
        log(f"serve {label} ({rcfg.n_layers} layers, d_model "
            f"{rcfg.d_model}, {rcfg.dtype} activations; {smi}): state pool "
            f"{fam.pool_bytes / 1e6:.1f} MB, {st.tokens} tokens in "
            f"{secs:.3f} s ({st.tokens / secs:.1f} tokens/s), "
            f"{st.prefill_steps} prefill steps, {st.decode_steps} decode "
            f"steps; launches {counts}; equal to the reference generator: "
            f"{div is None}; live-slot read-back equal: {read_ok}; decode "
            f"step at batch 8: " + json.dumps(timing))
        require(div is None, f"serve {label}: first divergence at {div}")
        require(sorted(out) == list(range(N_REQUESTS))
                and all(len(t) == MAX_NEW for t in out.values()),
                f"serve {label}: not every request finished")
        require(counts["strided_scatter"] >= 1,
                f"serve {label}: no strided scatter launched: {counts}")
        require(read_ok is True and counts["strided_gather"] >= 1,
                f"serve {label}: the live-slot read-back failed: {read_ok}")
        del out, want, sched, fam
        torch.cuda.empty_cache()
        phase_s[f"{label} serving"] = time.perf_counter() - t0
    phase_s["total"] = time.perf_counter() - t_start
    log("phase seconds: " + json.dumps(phase_s))

    kernels = []
    for kname, (source, replaces) in KERNELS.items():
        tag = REPORTED[kname]
        rec = records[(kname, tag)]
        err = max(r["max_abs_err"] for (k, _), r in records.items()
                  if k == kname)
        kernels.append(dict(
            name=kname, route="cuda", source=source, replaces=replaces,
            launches=launches[kname], max_abs_err=err, ms=rec["ms"],
            plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
            bound_by=rec["bound_by"], library_ms=rec["library_ms"],
            max_err=err, kernel_ms=rec["ms"],  # the same, under other names
        ))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

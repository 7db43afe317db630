#!/usr/bin/env python3
"""On-card check of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases, each of which fails the run (nonzero exit) if anything is off:

1. Setup: the card's name and power limit; the six CUDA sources of
   ``src/repro_torch/kernels/csrc`` built with ``nvcc`` in parallel.
2. Kernels: each of the eight serving kernels against its plain PyTorch
   version on the card.  The paged ones at the yi-6b serving shapes (H=32, KVH=4,
   D=128, page 16, batch 8; verify with K=4 queries per sequence), fp32,
   int8 and bf16 pools (attention and the paged K/V write; the converters
   are not on the bf16 path), the bf16 attention also bitwise equal to the
   same kernel on the pools widened to fp32; the strided converters at the rwkv6-3b and Mamba
   (yi-6b width) state-pool shapes, fp32 and bf16 rows, plus odd row
   widths.  The indirect gather also on each copy unit of its plan
   (16 bytes: fp32 32 KB pages, int8 8 KB pages and their 256 B scale
   rows, 256 B fp32 rows; 4 bytes: 32 KB and 4108 B fp32 rows 4 bytes off
   alignment; 1 byte: 4099 B int8 rows 3 bytes off), with indices below
   and past the rows (clipped), each case printing its route.  The paged
   K/V write (one launch a layer on the serving path) as the decode
   append (8 rows, one inactive) and the prefill chunk write (8 rows of 32
   tokens, ragged, one padding row), fp32 and int8 pools, against both
   the kernel's plain version and the full-pool oracle.  Data movement
   must match bitwise, attention within rtol = atol = 1e-5 (float32 sums
   in another order).  A poison check puts NaN in every unmapped page:
   the attention outputs must stay finite.  The three split-KV attention
   kernels must
   also be bitwise equal across two calls, and each row computed alone
   (one row, its table cut to the pages it needs) bitwise equal to the
   same row of the batch of 8; each logs its plan, and their rows of the
   JSON line carry it as ``kernel_route`` beside the profiler's
   ``device_ms``.  Kernel, plain version and, where one PyTorch
   call computes the same function, that call are timed with CUDA events
   (median of 25); the gather, ``index_select``, the paged K/V write and
   the launch floor (a one-row gather of 16 bytes) also by the profiler's
   device time, since an event-timed call of a few µs sits on the floor.
   The indirect scatter and gather also at the MoE training microbatch's
   shape (olmoe-1b-7b, 2 x 4096 tokens, top-8 of 64: 65,536 bf16 rows of
   4 KB into and out of 81,920 slots, the dropped assignments' sentinel
   included), bitwise against their plain versions, beside
   ``index_copy_`` / ``index_select`` (events and profiler); then
   ``ops.moe_dispatch`` / ``moe_combine``, forward and backward, against
   the oracles (``impl='ref'``): buffers, ``src``, ``keep``, the combine
   and its gradient bitwise, the token gradient (K bf16 rows summed)
   within a bf16 step; each timed.  Their rows of the JSON line report
   this shape, with the paged shapes under ``shapes``.
3. Paper workloads: first the three workload kernels against their plain
   versions, then the port's workload functions (``repro_torch.workloads``)
   at sizes their users run, with the launch counts reset just before:
   ismt on a 16,384 x 16,384 fp32 matrix and on a ragged 12,345 x 6,789
   matrix in fp32 and bf16 (the tiled transpose, bitwise); spmv on an ELL
   matrix of 2**22 rows and columns, 32 entries a row of which Poisson(24)
   are live, columns uniform and sorted per row, built on the card from a
   seeded generator (the ELL SpMV, within rtol = atol = 1e-5: float32
   sums of a row in another order; also timed with its columns cut to
   2**18, 2**20 and 2**22 distinct x entries, and on a row-local matrix
   whose columns lie within 2,048 of the row, beside cuSPARSE);
   pagerank, 20 iterations on the same graph with column-normalised
   weights through the SpMV kernel; sssp, 12
   Bellman-Ford sweeps (plain tensor code, bitwise against the CPU on a
   2**18-node graph); gemv_col and trmv at n = 16,384 (``torch.matmul``);
   then ``python -m repro_torch.workloads``' own run at n = 128, which
   checks all six against numpy and prints the modeled speed-ups of the
   port's bus model and bank simulator.  The panel-streamed SpMV, which no
   workload calls, is checked on 2**20 panel-sorted rows (K = 32, 4 steps,
   panel 512, row blocks of 64, C = 2**22) with a few entries outside
   their panel, which must be masked, on each route of its plan: bulk by
   default, cp.async with x 4 bytes off alignment, and row blocks of 300
   and 100 rows with K/steps of 3 and 1; each case prints its route.
   Kernel, plain version and the library call (``x.t().contiguous()``,
   the cuSPARSE CSR matvec) are timed with CUDA events; the ELL SpMV, the
   panel kernel on both routes and cuSPARSE also by the profiler.
4. Paged serving: full-width yi-6b (32 layers, d_model 4096, 32/4 heads,
   vocab 64000; random weights from a seeded torch.Generator) through the
   port's ``Scheduler``: 8 requests, prompts of 17-300 tokens, 32 new
   tokens each, batch 8, page 16, max_len 512, chunk 32.  First with fp32
   pools, then int8, bf16 and ``kv_dtype=None`` (the config's bf16, as the
   reference serves yi-6b) in a pool tight enough to force evictions.  The
   token streams must equal ``static_batch_generate`` on the plain path
   (``impl='ref'``), and every kernel of the path must have launched:
   the paged K/V write, never the indirect converters.  The None run must
   serve from bf16 pools the bf16 run's stream; how many bf16 tokens
   differ from the fp32 stream is logged (a different result, not a
   fault).
   On a flip, the top two logits at that token on both paths (a chunked
   prefill of the prompt and the plain tokens before it) are logged.
   Then an isolated prefill and decode run, on fp32 and on bf16 pools,
   gives tokens/s, launches per step (one paged K/V write a layer) and the
   profiler's kernel count of one decode step and one prefill chunk.
5. Speculative serving: the same model, prompts and pools with
   ``spec_k = 4`` and an ``NGramDrafter``, fp32, int8 and bf16: the tokens
   must equal plain greedy (phase 4's ``static_batch_generate``), verify
   must have launched, and the int8 and bf16 runs must evict.
6. Recurrent serving: rwkv6-3b at full width (32 layers, d_model 2560,
   40 WKV heads, d_ff 8960, vocab 65536) and the Mamba block at yi-6b
   width, bf16 activations, random weights from a seeded generator,
   through the ``Scheduler`` with batch 8, the same 8 prompts and 32 new
   tokens.  The output must equal ``recurrent_reference_generate``
   bitwise; every admission zeroes its slot through the strided scatter,
   and a live slot read back through ``recurrent_state_read`` (the strided
   gather) must equal the pool's own view of it.
7. Training: first the flash-attention kernels (forward, forward with
   lse, two-pass backward) against their plain versions, on both routes:
   the SIMT kernels (fp32) at S=1024 within rtol = atol = 2e-5 (forward)
   and 1e-4 (backward), and on a ragged non-causal S=1000 and a causal
   window of 256, also against ``ref.mha``; the tensor-core kernels
   (bf16, ``wgmma`` with TMA loads) at the training paths' shapes (B=2,
   S=4096, D=128, causal, as (B, S, H, D) views, with yi-6b's 32/4 heads
   and olmoe-1b-7b's 16/16), on a ragged
   non-causal S=1000 and a causal window of 256 (also against ``ref.mha``
   in fp32), on Sq=512 over Skv=256 with fully masked rows (o = 0 and
   lse = -1e30 checked), at D=64, and at D=80 (causal, ragged non-causal
   and windowed, both routes; the bf16 route runs D=80 in D=128 tiles),
   within the same tolerances plus 2 bf16 steps of each plain value (each
   side rounds once); then at the families' shapes (bf16, B 2, S 4096):
   hymba-1.5b's 25/5 heads of 64 with its window of 1024 and causal for
   its global layers, gemma3-27b's 32/16 of 128 with its window,
   qwen2.5-14b's 40/8 of 128, internvl2-1b's 14/2 of 64, hubert-xlarge's
   non-causal 16/16 of 80; each case prints its route; kernel, plain
   version and ``scaled_dot_product_attention`` (forward, backward; an
   explicit mask for a window) timed with CUDA events at the paths' and
   the families' shapes.  Then yi-6b at full width cut to 4 layers
   (random weights from a seeded generator, fp32 params, bf16 compute,
   remat), sequences of 4096 from the synthetic corpus, global batch 4
   in 2 microbatches: the plain path's first step and a forward-only loss
   against the kernels' (losses within 1e-5 relative, the gradient norm
   within 1e-3); the kernel path's gradients of one batch, twice, equal
   leaf by leaf; 6 AdamW steps under ``TrainController`` with a
   checkpoint every 3 steps (every loss finite, the flash kernels
   launched); one more step timed and profiled (idle share); then a
   fresh controller resumes from the step-3 checkpoint, as after a kill
   at step 4, and runs until a simulated kill at step 5: its losses must
   equal the straight run's bit for bit.
8. MoE serving: olmoe-1b-7b at full size (16 layers, d_model 2048, 16/16
   heads of 128, 64 experts top-8, d_ff 1024, vocab 50,304; 27.7 GB of
   fp32 weights from a seeded generator, bf16 compute) through
   ``launch.serve.dense_generate``: batch 8, prompts of 256 tokens, 32 new
   tokens, on the kernels and on the plain path (``impl='ref'``).  The
   greedy streams must be equal and the prefill logits bitwise equal; the
   kernel run must launch one scatter (dispatch) and one gather (combine)
   a layer a step and nothing else.  Prefill and decode tokens/s, the
   profiler's kernels a decode step and the device's idle share of it.
9. MoE training: olmoe-1b-7b at full width cut to ``MOE_TRAIN_LAYERS``
   layers, train_4k's sequences, batch 4 in 2 microbatches, AdamW, remat,
   4 steps, no checkpoints: the plain path's first-batch loss and
   gradient norm against the kernels' step 0 (1e-5 and 1e-3 relative);
   the kernel path's gradients of one batch, twice, equal leaf by leaf,
   with 3 scatters and 3 gathers a layer a microbatch (forward, recompute,
   backward); every loss finite; step time, tokens/s, peak memory and
   the idle share of a profiled step.
10. hymba-1.5b training at full size, no cut (32 layers, d_model 1600,
    25/5 heads of 64, window 1024 with layers 0, 16 and 31 global,
    Mamba heads of d_inner 3200 and state 16, vocab 32,001; 1.66 B fp32
    parameters from a seeded generator, bf16 compute, remat): train_4k's
    sequences, batch 4 in 2 microbatches, AdamW, 3 steps, no checkpoints.
    The plain path's first-batch loss and gradient norm against the
    kernels' step 0 (1e-5 and 1e-3 relative); the kernel path's gradients
    of that batch, twice, equal leaf by leaf, with 128 forward-with-lse
    and 64 backward flash launches (two and one a layer a microbatch); step
    0 is their update; every loss finite; step time, tokens/s, peak
    memory and a profiled step's idle share.
11. hubert-xlarge training at full size, no cut (48 layers, d_model
    1280, 16/16 heads of 80, non-causal, plain GELU MLP, 512-wide audio
    frames from a seeded numpy generator, vocab 504; 0.95 B parameters),
    as phase 10: 192 / 96 flash launches a step at D = 80.
12. hymba-1.5b dense generation at full size through ``dense_generate``
    (batch 8, prompts of 256, 32 new tokens, bf16): ids in the vocab,
    prefill and decode tokens/s, the profiler's kernels and idle share of
    a decode step; then ``tests/test_arch_smoke.py``'s contract at full
    size: prefill plus one decode step a token against one full forward
    (the flash kernel, one launch a layer) over 2 x (1100 + 32) tokens,
    so that the window of 1024 binds, within 2e-4, at float32 activations
    (the contract's tolerance is set for them).
13. Dry run (``repro_torch.launch.dryrun``, host only, no kernel): all 64
    (arch x shape x mesh) cells on the 16 x 16 and 2 x 16 x 16 production
    meshes built on ``meta`` tensors, one line a cell with its argument
    GiB a device (by group) and whether they fit this card's memory,
    beside the card's name and power limit; the total seconds.  Then
    world size 1: on a 1 x 1 host mesh, the dry run's parameter and
    optimizer-state bytes of each training phase's config (yi-6b at 4
    layers, olmoe-1b-7b at 6, hymba-1.5b and hubert-xlarge at full size)
    must equal, leaf by leaf and in total, the ``nbytes`` of the trees
    that phase allocated on the card (``torch.cuda.memory_allocated()``
    printed beside); and olmoe-1b-7b's full-size serving weights, bf16 in
    the dry run, beside the fp32 tree ``dense_generate`` held in phase 8,
    with their factor.  Last, the per-device analysis (ROADMAP A9c) of
    yi-6b and arctic-480b ``train_4k`` and qwen1.5-32b ``decode_32k`` on
    both meshes: each step run once as ``meta`` DTensors over a fake
    256- or 512-rank group in a subprocess of its own (all six at once,
    beside the phase's other checks, as phase 14 owns this process's
    group), with its per-device dot FLOPs, collectives by kind and wire
    bytes, and seconds; a failed analysis or a null field fails the run.
14. Mesh-parallel (ROADMAP A9b), world size 1: a ``torch.distributed``
    group on ``nccl`` from a file store (a failure to init fails the
    run) and the ``data`` mesh bound to it.  ``optim.compression.
    int8_psum`` over 1,216,385,024 float32 values (the 4-layer yi-6b
    tree), timed; on a slice of 2**24 values its int8 codes, scales, sums
    and residuals bitwise against the same call on CPU copies over a gloo
    group.  ``make_compressed_train_step`` on phase 7's params, batches
    and AdamW for 3 steps (4 x 4096 in 2 microbatches, the flash
    kernels): step 0's loss bitwise phase 7's first, the next within 1e-2
    relative of phase 7's, a nonzero residual; step time, peak memory and
    flash launches a step.  Expert-parallel MoE at olmoe-1b-7b full width
    (one layer, fp32, tokens 8 x 256): 8 expert shards computed in turn
    (``mlp._ep_shard``, dispatch and combine on the converter kernels)
    and summed in shard order, against ``moe_fwd``: output and
    gradients within 1e-4, aux bitwise, each shard bitwise against the
    plain dispatch and combine, 16 scatters and 16 gathers, at capacity
    factor 8.0 and at the config's 1.25 (the shards' kept masks making up
    the portable path's).  The vocab-sharded embedding at yi-6b's 64,000
    x 4,096 table over 16 shards in turn on 4 x 4,096 ids: forward
    bitwise ``table[ids]``, gradient bitwise the unsharded gather's.
    Then DTensors on a bound 1 x 1 ``data x model`` mesh (A9c): phase 7's
    yi-6b step with ``param_shardings`` parameters, a DTensor batch and
    the training rules' ``constrain`` calls, on the flash kernels: step
    0's loss bitwise phase 7's first, the gradients of batch 0 bitwise
    the plain tensors' (else the first differing leaf named and held
    within 1e-5 relative), what ``CommDebugMode`` counted; EP MoE at
    olmoe-1b-7b width with DTensor parameters, each of the 8 shards
    bitwise the plain tensors', forward and backward, fsdp off and on,
    on the converter kernels; the launches these runs add.

It prints a JSON line with one entry per kernel, the card's name and power
limit, and as its last line ``{"ok": true, "device": {...}}``.  The rows
of the flash kernels carry the other timed shapes (olmoe-1b-7b's and the
families') under ``shapes``.  The rows
of the indirect converters report the MoE shape and add ``rows``,
``kept_rows``, ``function_ms`` (the dispatch and combine Functions and
their oracles, forward and backward) and ``device_ms`` /
``library_device_ms``.  The rows
of the paged attention kernels add ``kernel_route`` (the plan's route) and
``device_ms``, and under ``shapes`` the int8 and bf16 pools' times,
bounds (at 1 and 2 bytes an element), plain times and, for bf16, the
launches of the bf16 serving runs; those of the gather, the paged K/V write and the two SpMVs
add ``kernel_route``, ``device_ms`` / ``library_device_ms`` (profiler),
for the gather ``slab_bytes``, ``launch_floor_ms`` /
``launch_floor_device_ms``, the routes checked and under ``shapes`` the
same times for the int8 codes and scale rows, for the paged K/V write
under ``shapes`` the append and the int8 and bf16 pools' times, for the ELL SpMV
``x_sector_bytes`` (live entries times 32 bytes), for the panel SpMV ``ms_cp_async`` /
``device_ms_cp_async``.  Without a
GPU, or outside a checkout of the repository, it exits nonzero and prints
no result.
"""
from __future__ import annotations

import json
import os
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
# The paged serving runs' kv_dtype: None is the config's compute dtype
# (bf16 for yi-6b), and must serve what "bf16" serves.
SERVE_DTYPES = ("fp32", "int8", "bf16", None)
SPEC_DTYPES = ("fp32", "int8", "bf16")
BF16_DTYPES = ("bf16", None)
N_TIMED = 25
SLEEP_CYCLES = 4_000_000   # ~2 ms of GPU clock: longer than a kernel call's
STEP_SLEEP_CYCLES = 100_000_000  # ~50 ms: longer than a decode step's
TOL = dict(rtol=1e-5, atol=1e-5)

# Serving shapes of the main path.
BATCH, PAGE, MAX_LEN, CHUNK = 8, 16, 512, 32
N_REQUESTS, MAX_NEW = 8, 32
PROMPT_LENS = (17, 300)

# Published peaks (NVIDIA data sheets, dense, at the full power limit):
# device-memory bytes/s, float32 FLOP/s outside the tensor cores, and
# bf16 tensor-core FLOP/s (the rate for work on bf16 inputs).
PEAKS = {
    "H100 PCIe": (2.0e12, 51e12, 756e12),
    "H100 NVL": (3.9e12, 60e12, 835e12),
    "H100": (3.35e12, 67e12, 989e12),       # SXM, "NVIDIA H100 80GB HBM3"
    "H200": (4.8e12, 67e12, 989e12),
}

KERNELS = {
    # wrapper name: (source, TPU kernel it replaces)
    "indirect_gather": (
        "src/repro_torch/kernels/csrc/stream_converters.cu",
        "src/repro/kernels/stream_converters.py:126"),
    "indirect_scatter": (
        "src/repro_torch/kernels/csrc/stream_converters.cu",
        "src/repro/kernels/stream_converters.py:170"),
    "paged_kv_write": (
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
    "flash_attention": (
        "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:110"),
    "flash_attention_fwd": (
        "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:160"),
    "flash_attention_bwd": (
        "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:312"),
}
#: The record of each kernel that the JSON line reports: the paged ones at
#: fp32 (the K/V write at the prefill chunk's shape), the strided ones at
#: their widest burst (rwkv6-3b's wkv state), the workload ones at the
#: workloads phase's full size.
REPORTED = {name: "fp32" for name in KERNELS}
REPORTED.update(indirect_gather="moe", indirect_scatter="moe",
                paged_kv_write="fp32 chunk", strided_gather="rwkv6-3b s",
                strided_scatter="rwkv6-3b s",
                tiled_transpose="16384 fp32", spmv_ell="2^22 rows",
                spmv_ell_panel_kernel="2^20 rows", flash_attention="path bf16",
                flash_attention_fwd="path bf16",
                flash_attention_bwd="path bf16")

#: Extra keys of the redesigned kernels' rows (the gather, the paged K/V
#: write, the two SpMVs): the route their plan took, profiler device times
#: beside the event times, the gather's launch floor (one 16-byte row), the
#: routes it was checked on, its slab and its other path shapes, the
#: write's other shapes, the ELL SpMV's x-sector bytes, and the panel
#: SpMV's cp.async route (x off alignment).
REDESIGN_KEYS = ("kernel_route", "device_ms", "library_device_ms",
                 "launch_floor_ms", "launch_floor_device_ms", "ms_cp_async",
                 "device_ms_cp_async", "routes", "slab_bytes", "shapes",
                 "x_sector_bytes", "rows", "kept_rows", "function_ms")
#: The keys of a kernel's other path shapes under ``shapes`` in its row
#: (the gather's int8 codes and scale rows; the write's append and int8).
SHAPE_KEYS = ("kernel_route", "slab_bytes", "ms", "device_ms", "library_ms",
              "library_device_ms", "bound_ms")

# Sizes of the paper-workloads phase.
ISMT_N = 16384
RAGGED = (12345, 6789)
SPMV_R, SPMV_K, SPMV_NNZ = 1 << 22, 32, 24      # rows = columns, ELL width
PANEL_R, PANEL_STEPS, PANEL, PANEL_ROWS = 1 << 20, 4, 512, 64
PRANK_ITERS, SSSP_ITERS, SSSP_SUB = 20, 12, 1 << 18
WORKLOAD_KERNELS = ("tiled_transpose", "spmv_ell", "spmv_ell_panel_kernel")
#: The paged attention wrappers: each serving step launches one of them
#: and one paged K/V write a layer.
ATTENTION_KERNELS = ("paged_decode_attention", "paged_prefill_attention",
                     "paged_verify")
#: The pool elements the kernels phase checks the serving kernels on; the
#: first is the one the JSON line reports, the others go under ``shapes``.
POOL_TAGS = ("fp32", "int8", "bf16")
#: The keys of the paged attention kernels' int8 and bf16 cases under
#: ``shapes`` (``bitwise_widened``: bf16 equal to the kernel on the pools
#: widened to fp32).
ATTN_SHAPE_KEYS = ("kernel_route", "ms", "device_ms", "plain_ms", "bound_ms",
                   "bound_by", "max_abs_err", "bitwise_widened")

# The training phase: yi-6b at full width cut to 4 layers, sequences of
# train_4k's length, global batch 4 in 2 microbatches, AdamW; checkpoints
# every 3 steps, and a resume from step 3 as after a preemption at step 4.
TRAIN_LAYERS = 4
TRAIN_BATCH, TRAIN_ACCUM, TRAIN_STEPS = 4, 2, 6
TRAIN_CKPT_EVERY, TRAIN_PREEMPT = 3, 4
FLASH_KERNELS = ("flash_attention", "flash_attention_fwd",
                 "flash_attention_bwd")
# Flash kernels against their plain versions: float32 outputs within these;
# bf16 outputs within the same plus 2 bf16 steps (ulps) of the plain value,
# since each side rounds its float32 result to bf16 once.
FP32_FWD_TOL = dict(rtol=2e-5, atol=2e-5)
FP32_BWD_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_ULPS = 2
# Kernel path against plain path: the losses (forward-only and step 0),
# then the step-0 gradient norm.
LOSS_RTOL = 1e-5
GRAD_NORM_RTOL = 1e-3
# The families' flash shapes (bf16, B 2, S 4096), each timed over
# FAMILY_TIMED_N runs beside SDPA: (tag, arch, whether the layer is
# windowed); heads, head dim and mask come from the configuration.
FAMILY_FLASH = (
    ("hymba-1.5b window 1024", "hymba-1.5b", True),
    ("hymba-1.5b global", "hymba-1.5b", False),
    ("gemma3-27b window 1024", "gemma3-27b", True),
    ("qwen2.5-14b", "qwen2.5-14b", False),
    ("internvl2-1b", "internvl2-1b", False),
    ("hubert-xlarge", "hubert-xlarge", False),
)
FAMILY_TIMED_N = 5
#: The keys of the flash rows' other shapes under ``shapes``.
FLASH_SHAPE_KEYS = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                    "max_abs_err", "library_fwd_bwd_ms")

# The MoE phases: olmoe-1b-7b (64 experts, top-8, d_model 2048), whose
# dispatch and combine are the indirect scatter and gather.  Serving at
# full size through dense_generate (batch 8, prompts of 256, 32 new
# tokens); training at full width cut to MOE_TRAIN_LAYERS layers, train_4k's
# sequences, batch 4 in 2 microbatches, AdamW, no checkpoints.  All 16
# layers' fp32 params, grads and AdamW state are ~111 GB; 8 layers went
# out of memory on an 80 GB H100 (params, AdamW m and v, the gradient
# accumulator and a microbatch's gradients alone are 5 x 14.2 GB), so the
# cell takes 6 (2.72 B parameters).  The
# converters are timed at the training microbatch's shape: 2 x 4096
# tokens, top-8, 65,536 rows of 4 KB (bf16) into 64 x 1280 slots.
MOE_ARCH = "olmoe-1b-7b"
MOE_BATCH, MOE_PROMPT, MOE_NEW = 8, 256, 32
MOE_TRAIN_LAYERS = 6
MOE_TRAIN_STEPS = 4
MOE_CONVERTERS = ("indirect_scatter", "indirect_gather")

# The families at full size, no cut: hymba-1.5b and hubert-xlarge train
# on train_4k's sequences, batch 4 in 2 microbatches, AdamW, remat,
# FAMILY_STEPS steps (the first is the update of the gradients checked
# twice), no checkpoints.  hymba-1.5b also generates through
# dense_generate (batch 8, prompts of 256, 32 new tokens), and holds
# prefill plus decode against one full forward (test_arch_smoke.py's
# contract, 2e-4) at float32 activations over 2 x (1100 + 32) tokens, so
# that its window of 1024 binds.
FAMILY_TRAIN = ("hymba-1.5b", "hubert-xlarge")
FAMILY_STEPS = 3
HYMBA = "hymba-1.5b"
HYMBA_BATCH, HYMBA_PROMPT, HYMBA_NEW = 8, 256, 32
CONTRACT_BATCH, CONTRACT_PROMPT, CONTRACT_NEW = 2, 1100, 32
CONTRACT_TOL = 2e-4
#: What the training phases allocated: label → (config, leaf layouts and
#: bytes of the parameter and optimizer trees, ``memory_allocated``),
#: held against the dry run in phase 13.  ``SERVED`` the same for
#: phase 8's fp32 serving weights.
ALLOCATED = {}
SERVED = {}
DRYRUN_CELLS = 64
#: Phase 13's per-device analyses (each in a subprocess of its own, all at
#: once): (arch, shape, multi-pod), and the seconds each may take.
PER_DEVICE_CELLS = [(a, s, mp) for mp in (False, True) for a, s in (
    ("yi-6b", "train_4k"), ("arctic-480b", "train_4k"),
    ("qwen1.5-32b", "decode_32k"))]
PER_DEVICE_TIMEOUT_S = 420

# The mesh-parallel phase (world size 1, an nccl group from a file store):
# int8_psum over the 4-layer yi-6b tree's length, held bitwise against the
# same call on CPU copies of a slice; the compressed data-parallel step on
# the training phase's params and batches; expert-parallel MoE at
# olmoe-1b-7b full width (one layer, fp32, tokens 8 x 256, 8 expert shards
# in turn, capacity factor 8.0 so nothing drops, then the config's own);
# the vocab-sharded embedding at yi-6b's 64,000 x 4,096 table over 16
# shards in turn.
MESH_SLICE = 1 << 24
MESH_TIMED = 3
COMPRESSED_STEPS = 3
COMPRESSED_RTOL = 1e-2
EP_SHARDS, EP_BATCH, EP_SEQ, EP_CF, EP_TOL = 8, 8, 256, 8.0, 1e-4
EMB_SHARDS = 16


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


def profile_step(fn, top: int = 6, warm: bool = True):
    """Device time of one call of ``fn`` by kernel, from ``torch.profiler``:
    the summed kernel time, the number of kernels run, and the ``top``
    kernels by time.  A step of more than ~1,000 launches fills the
    card's launch queue, so the host blocks inside a queued-ahead run and
    event timing (as :func:`throughput` uses for the paged decode step)
    overstates its device time; the profiler's sum does not.
    Returns ``None`` where the profiler records no device time.  ``warm``
    False profiles the first call (a step that follows others is warm
    already)."""
    from torch.profiler import ProfilerActivity, profile

    if warm:
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


PROFILER_MISSES: list[float] = []  # device_ms values taken by events


def profile_ms(fn, n: int = N_TIMED, tries: int = 5):
    """Device time of one call of ``fn`` from ``torch.profiler``: the
    kernels' summed time over ``n`` back-to-back calls, over ``n``.  For a
    call of a few µs, event timing (:func:`time_ms`) stays on the launch
    floor (~5 µs), while this counts only the kernels' own time.  A session
    now and then records no device time at all; it is taken again, up to
    ``tries`` sessions.  If none records any, the time comes from CUDA
    events around the ``n`` back-to-back calls instead (launch gaps
    included), is logged as such and listed in :data:`PROFILER_MISSES`:
    the number is a measurement, not a check, so the run goes on."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for attempt in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        us = sum(getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
                 for ev in prof.key_averages())
        if us > 0:
            return us / 1e3 / n
        log(f"profiler: session {attempt + 1} of {tries} recorded no "
            f"device time")
        time.sleep(0.2)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / n
    PROFILER_MISSES.append(ms)
    log(f"profiler: no device time in {tries} sessions; device_ms {ms!r} "
        f"taken by CUDA events over {n} back-to-back calls instead")
    return ms


# ---------------------------------------------------------------------------
# Phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------


def kernel_inputs(rng, dev, tag, lens):
    """A yi-6b layer's pools (``tag``: fp32, int8 codes with scales, or
    bf16), page table and lengths for 8 sequences."""
    kvh, d, h = 4, 128, 32
    n_pages = MAX_LEN // PAGE
    pool = BATCH * n_pages
    shape = (pool, PAGE, kvh, d)
    ks = vs = None
    if tag == "int8":
        kp = torch.randint(-127, 128, shape, dtype=torch.int8, device=dev)
        vp = torch.randint(-127, 128, shape, dtype=torch.int8, device=dev)
        ks = torch.rand(shape[:3], device=dev) * 0.02 + 0.001
        vs = torch.rand(shape[:3], device=dev) * 0.02 + 0.001
    else:
        dt = torch.bfloat16 if tag == "bf16" else torch.float32
        kp = torch.randn(shape, device=dev).to(dt)
        vp = torch.randn(shape, device=dev).to(dt)
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


def check_split(name, fn, args, kwargs, got, widths):
    """The bits of a split-KV attention call (``fn`` on ``args``, whose
    result was ``got``): equal across two calls, and each row computed
    alone (R = 1, its table cut to ``widths[i]`` pages) equal to the same
    row of the batch.  Returns the plan's route and logs the plan."""
    again = fn(*args, **kwargs)
    torch.cuda.synchronize()
    require(torch.equal(again, got), f"{name}: not bitwise across calls")
    plan = fn.plan
    for i, width in enumerate(widths):
        q, table = args[0], args[3]
        alone = fn(q[i:i + 1], args[1], args[2],
                   table[i:i + 1, :max(1, width)].contiguous(),
                   *[a[i:i + 1] for a in args[4:]], **kwargs)
        torch.cuda.synchronize()
        require(torch.equal(alone[0], got[i]),
                f"{name}: row {i} alone differs from the row in the batch")
    log(f"{name}: bitwise across calls and alone vs batch of "
        f"{len(widths)}; plan {plan}")
    return plan.route


def check_widened(name, fn, args, got, kp, vp):
    """bf16 pools: ``fn`` on ``args`` gave ``got``; the same kernel on the
    pools widened to fp32 (exact) must give the same bits."""
    wide = fn(args[0], kp.float(), vp.float(), *args[3:])
    torch.cuda.synchronize()
    require(torch.equal(wide, got),
            f"{name}: not bitwise equal to the kernel on the widened fp32 "
            f"pools (max abs diff {(wide - got).abs().max().item():.3e})")
    log(f"{name}: bitwise equal to the kernel on the widened fp32 pools")
    return True


def check_kernels(ops, dev, lens, bw, flops):
    """Correctness, poison and timing of the serving kernels on fp32, int8
    and bf16 pools; returns the per-kernel records (without launches)
    keyed by (wrapper name, tag)."""
    rng = np.random.default_rng(SEED)
    records = {}
    sc = lambda ks, vs: {} if ks is None else dict(k_scale=ks, v_scale=vs)
    for tag in POOL_TAGS:
        quantized = tag == "int8"
        h, kvh, d, kp, vp, ks, vs, table, lengths = kernel_inputs(
            rng, dev, tag, lens)
        elem = kp.element_size()
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
        route = check_split(f"paged_decode {tag}", ops.paged_decode_attention,
                            args, sc(ks, vs), got,
                            [-(-n // PAGE) for n in lens])
        widened = (check_widened(f"paged_decode {tag}",
                                 ops.paged_decode_attention, args, got, kp,
                                 vp) if tag == "bf16" else None)
        live = int(sum(lens))
        nbytes = (live * kvh * (2 * d * elem + (8 if quantized else 0))
                  + 2 * q.numel() * 4
                  + sum(-(-n // PAGE) for n in lens) * 4 + BATCH * 4)
        nops = 4 * h * d * live
        records[("paged_decode_attention", tag)] = dict(
            max_abs_err=err, ms=time_ms(run), plain_ms=time_ms(plain),
            library_ms=None, bytes=nbytes, ops=nops, kernel_route=route,
            device_ms=profile_ms(run), bitwise_widened=widened)

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
        route = check_split(f"paged_prefill {tag}",
                            ops.paged_prefill_attention, args, sc(ks, vs),
                            got, [-(-lv // PAGE) for lv in live_r])
        widened = (check_widened(f"paged_prefill {tag}",
                                 ops.paged_prefill_attention, args, got, kp,
                                 vp) if tag == "bf16" else None)
        seen = sum(min(s + c + 1, lv) for s, lv in zip(starts, live_r)
                   if lv for c in range(CHUNK))
        nbytes = (sum(live_r) * kvh * (2 * d * elem + (8 if quantized else 0))
                  + 2 * qp.numel() * 4
                  + sum(-(-lv // PAGE) for lv in live_r) * 4 + 2 * BATCH * 4)
        nops = 4 * h * d * seen
        records[("paged_prefill_attention", tag)] = dict(
            max_abs_err=err, ms=time_ms(run), plain_ms=time_ms(plain),
            library_ms=None, bytes=nbytes, ops=nops, kernel_route=route,
            device_ms=profile_ms(run), bitwise_widened=widened)

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
        route = check_split(f"paged_verify {tag}", ops.paged_verify, args,
                            sc(ks, vs), got, [-(-lv // PAGE) for lv in vlive])
        widened = (check_widened(f"paged_verify {tag}", ops.paged_verify,
                                 args, got, kp, vp) if tag == "bf16"
                   else None)
        seen = sum(n + i + 1 for n, c in zip(lens, vcounts)
                   for i in range(c))
        nbytes = (sum(vlive) * kvh * (2 * d * elem + (8 if quantized else 0))
                  + 2 * qv.numel() * 4
                  + sum(-(-lv // PAGE) for lv in vlive) * 4 + 2 * BATCH * 4)
        records[("paged_verify", tag)] = dict(
            max_abs_err=err, ms=time_ms(run), plain_ms=time_ms(plain),
            library_ms=None, bytes=nbytes, ops=4 * h * d * seen,
            kernel_route=route, device_ms=profile_ms(run),
            bitwise_widened=widened)
        if tag == "bf16":  # the converters are not on the bf16 path
            records.update(check_paged_write(ops, dev, tag, kp, vp, ks, vs,
                                             table, lengths))
            continue

        # -- gather: the prefill window read, 3 pages for each of 8 rows
        #    (int8: the codes, then the scale rows).
        idx = table[:, :3].reshape(-1).contiguous()
        shapes = [(tag, f"{tag} pages", kp.view(pool, -1))]
        if quantized:
            shapes.append((f"{tag} scale rows",) * 2 + (ks.view(pool, -1),))
        for stag, what, flat in shapes:
            check_gather(ops, flat, idx, what)
            row = flat.shape[1] * flat.element_size()
            records[("indirect_gather", stag)] = dict(
                max_abs_err=0.0,
                plain_ms=time_ms(lambda: ops.indirect_gather(flat, idx,
                                                             impl="ref")),
                bytes=2 * idx.numel() * row + idx.numel() * 4, ops=0,
                **gather_times(ops, flat, idx))

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
        records.update(check_paged_write(ops, dev, tag, kp, vp, ks, vs,
                                         table, lengths))

    records.update(check_strided(ops, dev))
    records.update(check_moe_converters(ops, dev))
    records = add_bounds(records, bw, flops)
    rec = records[("indirect_gather", REPORTED["indirect_gather"])]
    rec.update(check_gather_routes(ops, dev))
    rec["shapes"] = {
        stag: {key: records[("indirect_gather", stag)].get(key)
               for key in SHAPE_KEYS}
        for stag in ("fp32", "int8", "int8 scale rows")}
    records[("indirect_scatter", REPORTED["indirect_scatter"])]["shapes"] = {
        stag: {key: records[("indirect_scatter", stag)].get(key)
               for key in SHAPE_KEYS}
        for stag in ("fp32", "int8")}
    records[("paged_kv_write", REPORTED["paged_kv_write"])]["shapes"] = {
        stag: {key: records[("paged_kv_write", stag)].get(key)
               for key in SHAPE_KEYS + ("plain_ms", "bound_by")}
        for stag in ("fp32 append", "int8 append", "int8 chunk",
                     "bf16 append", "bf16 chunk")}
    for kname in ATTENTION_KERNELS:
        records[(kname, REPORTED[kname])]["shapes"] = {
            stag: {key: records[(kname, stag)].get(key)
                   for key in ATTN_SHAPE_KEYS}
            for stag in POOL_TAGS[1:]}
    return records


def check_paged_write(ops, dev, tag, kp, vp, ks, vs, table, lengths):
    """The paged K/V write at a yi-6b layer's serving shapes, bitwise
    against its plain version and the full-pool oracle, one launch a call:
    the decode append (8 rows, the last one inactive; a chunk of one token,
    as the decode step launches it) and the prefill chunk write (8 rows of
    a 32-token chunk, ragged, one padding row), K and V (codes and scales
    for int8, rows rounded to nearest even for bf16).  Timed by events and
    the profiler (no
    single PyTorch call computes the write).  Returns the records keyed
    (name, "<tag> append" / "<tag> chunk")."""
    records = {}
    kvh, d = kp.shape[2], kp.shape[3]
    elem = kp.element_size()
    starts = torch.tensor([0, 32, 64, 96, 128, 160, 256, 288],
                          dtype=torch.int32, device=dev)
    counts = torch.tensor([32, 32, 17, 32, 5, 32, 32, 0], dtype=torch.int32,
                          device=dev)
    active = torch.tensor([1] * (BATCH - 1) + [0], dtype=torch.int32,
                          device=dev)
    cases = {  # the kernel's call, the oracle's, the rows' shape, st, ct
        "append": (lambda k, v, **kw: ops.paged_kv_write(
            *k, v[0][:, None], v[1][:, None], table, lengths, active, **kw),
            lambda k, v, **kw: ops.paged_kv_append(
                *k, *v, table, lengths, active, impl="ref", **kw),
            (BATCH, kvh, d), lengths, active),
        "chunk": (lambda k, v, **kw: ops.paged_kv_write_chunk(
            *k, *v, table, starts, counts, **kw),
            lambda k, v, **kw: ops.paged_kv_write_chunk(
                *k, *v, table, starts, counts, impl="ref", **kw),
            (BATCH, CHUNK, kvh, d), starts, counts),
    }
    for what, (call, oracle, shape, st, ct) in cases.items():
        new = [torch.randn(shape, device=dev) for _ in range(2)]
        new[0][0, ..., 0, :] = 0.0  # an all-zero row: int8 scale 1
        pools = lambda: [t.clone() for t in (kp, vp)] + (
            [] if ks is None else [ks.clone(), vs.clone()])

        def run_on(p, fn=call):
            kw = {} if ks is None else dict(k_scale=p[2], v_scale=p[3])
            return fn(p[:2], new, **kw)

        before = ops.paged_kv_write.launches
        got = pools()
        run_on(got)
        torch.cuda.synchronize()
        require(ops.paged_kv_write.launches == before + 1,
                f"paged_kv_write {tag} {what}: not one launch")
        want = pools()
        run_on(want, oracle)
        plain = pools()
        shaped = [t.view((shape[0], -1) + shape[-2:]) for t in new]
        ops.paged_kv_write(*plain[:2], *shaped, table, st, ct,
                           *plain[2:], impl="ref")
        for g, w, pl in zip(got, want, plain):
            require(torch.equal(g, w) and torch.equal(g, pl),
                    f"paged_kv_write {tag} {what}: not bitwise")
        dest = ops.ref.paged_kv_destinations(
            table, st, ct, shaped[0].shape[1], PAGE, kp.shape[0])
        n_valid = int((dest >= 0).sum())
        if ks is not None:
            count_int8_scales(f"{tag} {what}", kvh, d, dest, shaped, got[2:])
        nbytes = (2 * n_valid * kvh * d * (4 + elem)
                  + (2 * n_valid * kvh * 4 if ks is not None else 0)
                  + table.numel() * 4 + 2 * BATCH * 4)
        p = pools()
        records[("paged_kv_write", f"{tag} {what}")] = dict(
            max_abs_err=0.0, ms=time_ms(lambda: run_on(p)),
            device_ms=profile_ms(lambda: run_on(p)),
            plain_ms=time_ms(lambda: run_on(p, oracle)),
            library_ms=None, tokens=n_valid,
            kernel_route="one launch: a warp a (token, K|V, kv head) row",
            bytes=nbytes, ops=0)
    return records


def count_int8_scales(tag, kvh, d, dest, new, scales):
    """Hold the scales the write kernel stored against the reference's
    formula taken on the host in float32 numpy, amax * (1.0f / 127.0f)
    (``amax / 127.0`` under ``jax.jit``; 1 for a zero row), and print how
    many of them an unjitted division, amax / 127, would round otherwise."""
    keep = dest.reshape(-1) >= 0
    flat = dest.reshape(-1)[keep]
    inv = np.float32(1.0) / np.float32(127.0)
    n = unlike_ref = unlike_div = 0
    for rows, pool in zip(new, scales):
        amax = np.abs(rows.reshape(-1, kvh, d)[keep].cpu().numpy()).max(-1)
        stored = pool.view(-1, kvh)[flat].cpu().numpy()
        one = np.float32(1.0)
        n += stored.size
        unlike_ref += int((stored != np.where(amax > 0, amax * inv, one)).sum())
        unlike_div += int((stored != np.where(
            amax > 0, amax / np.float32(127.0), one)).sum())
    require(unlike_ref == 0, f"paged_kv_write {tag}: {unlike_ref} of {n} "
            f"int8 scales unlike the reference's amax * (1 / 127)")
    log(f"paged_kv_write {tag}: {n} int8 scales, {unlike_ref} unlike the "
        f"reference's amax * (1 / 127), {unlike_div} unlike amax / 127")


def gather_times(ops, src, idx):
    """The gather's event and profiler times at one shape, beside
    ``index_select``'s, and the route and slab its plan took."""
    run = lambda: ops.indirect_gather(src, idx)
    idx64 = idx.long()
    library = lambda: torch.index_select(src, 0, idx64)
    run()
    plan = ops.indirect_gather.plan
    return dict(
        kernel_route=plan.route, slab_bytes=plan.slab_bytes, ms=time_ms(run),
        library_ms=time_ms(library), device_ms=profile_ms(run),
        library_device_ms=profile_ms(library))


def check_gather(ops, src, idx, what):
    """``ops.indirect_gather`` against its plain version, bitwise, with one
    launch; logs and returns the route its plan took."""
    before = ops.indirect_gather.launches
    got = ops.indirect_gather(src, idx)
    want = ops.indirect_gather(src, idx, impl="ref")
    torch.cuda.synchronize()
    require(torch.equal(got, want), f"indirect_gather {what}: not bitwise")
    require(ops.indirect_gather.launches == before + 1,
            f"indirect_gather {what}: not one launch")
    plan = ops.indirect_gather.plan
    log(f"indirect_gather {what}, {idx.numel()} rows of "
        f"{src[0].numel() * src.element_size()} B, indices "
        f"{int(idx.min())}..{int(idx.max())} of {src.shape[0]} rows: "
        f"bitwise, route {plan.route}, plan {plan}")
    return plan.route


def offset_copy(t, offset):
    """A contiguous copy of ``t`` whose data starts ``offset`` bytes past a
    256-byte boundary."""
    flat = t.reshape(-1).view(torch.int8)
    buf = torch.empty(flat.numel() + 256, dtype=torch.int8, device=t.device)
    view = buf[offset:offset + flat.numel()]
    view.copy_(flat)
    return view.view(t.dtype).view(t.shape)


def check_gather_routes(ops, dev):
    """Every copy unit of the gather, bitwise against the plain version
    with indices below and past the rows: 16-byte units on aligned rows,
    4- and 1-byte units on rows off 16-byte alignment; then the launch
    floor, one 16-byte row, by events and by the profiler.  Returns the
    routes (units) taken and the floor's times."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    idx = torch.randint(-249, 452, (24,), generator=gen, device=dev,
                        dtype=torch.int32)
    pages = torch.randn((256, 8192), generator=gen, device=dev)
    codes = torch.randint(-128, 128, (256, 4099), generator=gen, device=dev,
                          dtype=torch.int32).to(torch.int8)
    cases = {
        "fp32 32 KB rows": (pages, 16),
        "fp32 32 KB rows at +4 B": (offset_copy(pages, 4), 4),
        "int8 4099 B rows at +3 B": (offset_copy(codes, 3), 1),
        "fp32 4108 B rows at +4 B": (
            offset_copy(pages[:, :1027].contiguous(), 4), 4),
        "fp32 256 B rows": (pages[:, :64].contiguous(), 16),
    }
    routes = {}
    for what, (src, unit) in cases.items():
        routes[what] = check_gather(ops, src, idx, what)
        require(ops.indirect_gather.plan.unit == unit,
                f"indirect_gather {what}: {routes[what]}, not {unit}-byte")
    one_src = torch.zeros((1, 4), device=dev)
    one_idx = torch.zeros(1, dtype=torch.int32, device=dev)
    floor = lambda: ops.indirect_gather(one_src, one_idx)
    return dict(routes=routes, launch_floor_ms=time_ms(floor),
                launch_floor_device_ms=profile_ms(floor))


def moe_routing(dev, gen, t, e, k):
    """Each of ``t`` tokens' ``k`` distinct experts of ``e``, drawn without
    replacement with weights falling 2.7x from expert 0 to expert e - 1
    (Gumbel top-k), so the popular experts overflow their capacity."""
    logits = torch.linspace(0.5, -0.5, e, device=dev)
    u = torch.rand((t, e), generator=gen, device=dev).clamp_min(1e-20)
    return torch.topk(logits - torch.log(-torch.log(u)), k, dim=1).indices


def check_moe_converters(ops, dev):
    """The indirect scatter and gather at the MoE training microbatch's
    shape (olmoe-1b-7b, 2 x 4096 tokens, top-8: 65,536 bf16 rows of 4 KB
    into and out of a 64 x 1280-slot buffer, the dropped assignments'
    sentinel row 81,920 included), each bitwise against its plain version
    and timed beside ``index_copy_`` / ``index_select`` (by events and the
    profiler); then ``ops.moe_dispatch`` / ``moe_combine``, forward and
    backward, against the oracles (``impl='ref'``), timed the same way.
    Returns the records keyed (name, "moe")."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.kernels import ref
    from repro_torch.models.mlp import moe_capacity

    cfg = get_config(MOE_ARCH)
    t = TRAIN_BATCH // TRAIN_ACCUM * SHAPES["train_4k"].seq_len
    e, k, d = cfg.n_experts, cfg.top_k, cfg.d_model
    c = moe_capacity(cfg, t)
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    idx = moe_routing(dev, gen, t, e, k)
    slot, keep, _ = ref.moe_slots(idx, e, c)
    slot32 = slot.to(torch.int32)
    n_rows, n_slots = t * k, e * c
    kept = int(keep.sum())
    row = d * 2
    rows = torch.randn((n_rows, d), generator=gen, device=dev).to(
        torch.bfloat16)
    expert_out = torch.randn((n_slots, d), generator=gen, device=dev).to(
        torch.bfloat16)
    records = {}

    # -- the scatter (dispatch forward, combine backward).
    got = ops.indirect_scatter(rows.new_zeros((n_slots, d)), rows, slot32)
    want = ops.indirect_scatter(rows.new_zeros((n_slots, d)), rows, slot32,
                                impl="ref")
    torch.cuda.synchronize()
    require(torch.equal(got, want), "indirect_scatter moe: not bitwise")
    dst = rows.new_zeros((n_slots, d))
    spare = rows.new_zeros((n_slots + 1, d))  # index_copy_ needs the sentinel
    run = lambda: ops.indirect_scatter(dst, rows, slot32)  # noqa: E731
    lib = lambda: spare.index_copy_(0, slot, rows)  # noqa: E731
    records[("indirect_scatter", "moe")] = dict(
        max_abs_err=0.0, ms=time_ms(run), device_ms=profile_ms(run),
        plain_ms=time_ms(lambda: ops.indirect_scatter(dst, rows, slot32,
                                                      impl="ref")),
        library_ms=time_ms(lib), library_device_ms=profile_ms(lib),
        rows=n_rows, kept_rows=kept,
        # A dropped row is neither read nor written: each kept row is read
        # once and written once, and every index is read.
        bytes=2 * kept * row + n_rows * 4, ops=0)
    del got, want, dst, spare

    # -- the gather (combine forward, dispatch backward), the sentinel
    #    clipped to the last row.
    check_gather(ops, expert_out, slot32, "moe")
    clipped = slot.clamp(max=n_slots - 1)
    run = lambda: ops.indirect_gather(expert_out, slot32)  # noqa: E731
    lib = lambda: torch.index_select(expert_out, 0, clipped)  # noqa: E731
    run()
    plan = ops.indirect_gather.plan
    records[("indirect_gather", "moe")] = dict(
        max_abs_err=0.0, ms=time_ms(run), device_ms=profile_ms(run),
        plain_ms=time_ms(lambda: ops.indirect_gather(expert_out, slot32,
                                                     impl="ref")),
        library_ms=time_ms(lib), library_device_ms=profile_ms(lib),
        kernel_route=plan.route, slab_bytes=plan.slab_bytes, rows=n_rows,
        kept_rows=kept, bytes=2 * n_rows * row + n_rows * 4, ops=0)
    require(plan.unit == 16, f"indirect_gather moe: plan {plan}, not "
            f"16-byte units on 4 KB rows")

    # -- through the dispatch and combine Functions, forward and backward.
    tokens = torch.randn((t, d), generator=gen, device=dev).to(
        torch.bfloat16).requires_grad_(True)
    outputs = expert_out.view(e, c, d).clone().requires_grad_(True)
    gates = torch.rand((t, k), generator=gen, device=dev)
    g_buf = torch.randn((e, c, d), generator=gen, device=dev).to(
        torch.bfloat16)
    g_out = torch.randn((t, d), generator=gen, device=dev).to(torch.bfloat16)
    times, res = {}, {}
    for impl in ("cuda", "ref"):
        buf, src, kp = ops.moe_dispatch(tokens, idx, e, c, impl=impl)
        out = ops.moe_combine(outputs, src, gates * kp, t, impl=impl)
        d_tok = torch.autograd.grad(buf, tokens, g_buf, retain_graph=True)[0]
        d_out = torch.autograd.grad(out, outputs, g_out,
                                    retain_graph=True)[0]
        res[impl] = (buf, src, kp, out, d_tok, d_out)
        tag = "" if impl == "cuda" else "plain_"
        times.update({
            f"{tag}dispatch": time_ms(lambda: ops.moe_dispatch(
                tokens, idx, e, c, impl=impl)),
            f"{tag}dispatch_backward": time_ms(lambda: torch.autograd.grad(
                buf, tokens, g_buf, retain_graph=True)),
            f"{tag}combine": time_ms(lambda: ops.moe_combine(
                outputs, src, gates * kp, t, impl=impl)),
            f"{tag}combine_backward": time_ms(lambda: torch.autograd.grad(
                out, outputs, g_out, retain_graph=True)),
        })
    torch.cuda.synchronize()
    names = ("buffers", "src", "keep", "combine", "d_tokens", "d_outputs")
    same = {n: torch.equal(a, b)
            for n, a, b in zip(names, res["cuda"], res["ref"])}
    # The token gradient sums K bf16 rows: the oracle's repeat_interleave
    # backward may sum them in another order.
    err_tok = (res["cuda"][4].float() - res["ref"][4].float()).abs().max()
    log(f"moe dispatch/combine at {t} tokens, top-{k} of {e}, capacity {c}: "
        f"{kept} of {n_rows} assignments kept; bitwise vs the oracles: "
        + json.dumps(same) + f"; d_tokens max abs err {float(err_tok):.3e}; "
        "times (ms): " + json.dumps(times))
    require(all(same[n] for n in names if n != "d_tokens"),
            f"moe dispatch/combine: not bitwise vs the oracles: {same}")
    require(bool(torch.allclose(res["cuda"][4].float(), res["ref"][4].float(),
                                rtol=2.0 ** -7, atol=2.0 ** -7)),
            f"moe dispatch backward: max abs err {float(err_tok):.3e}")
    for name in MOE_CONVERTERS:
        records[(name, "moe")]["function_ms"] = times
    del res, tokens, outputs, g_buf, g_out, rows, expert_out
    torch.cuda.empty_cache()
    return records


def add_bounds(records, bw, flops, rate="fp32"):
    """Each record's least time on the card: its bytes over the memory
    rate or its operations over ``flops`` (the peak for the inputs' type,
    named by ``rate``), whichever is larger."""
    for rec in records.values():
        t_bytes = rec["bytes"] / bw * 1e3
        t_ops = rec["ops"] / flops * 1e3
        rec["bound_ms"] = max(t_bytes, t_ops)
        rec["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        rec["bound_rate"] = rate
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
    run = lambda: ops.spmv_ell(vals, cols, x)
    library = lambda: torch.mv(csr, x)
    records[("spmv_ell", REPORTED["spmv_ell"])] = dict(
        max_abs_err=err, ms=time_ms(run),
        plain_ms=time_ms(lambda: ref.spmv_ell(vals, cols, x)),
        library_ms=time_ms(library), device_ms=profile_ms(run),
        library_device_ms=profile_ms(library),
        kernel_route=ops.spmv_ell.plan.route,
        x_sector_bytes=32 * int(live.sum()),
        bytes=nbytes, ops=2 * int(live.sum()))
    del got, csr
    torch.cuda.empty_cache()

    # -- panel SpMV: panel-sorted columns, plus 1 in 64 entries moved to
    #    another panel, which the kernel must mask.
    row_blocks = PANEL_R // PANEL_ROWS
    pv, pc, pids, stray = panel_matrix(dev, gen, row_blocks, PANEL_ROWS,
                                       SPMV_K, PANEL_STEPS, SPMV_R, PANEL)
    run = lambda: ops.spmv_ell_panel_kernel(pv, pc, x, pids, panel=PANEL)
    plain = lambda: ref.spmv_ell_panel(pv, pc, x, pids, panel=PANEL)
    perr, route, want = check_panel(ops, ref, pv, pc, x, pids, stray,
                                    "2^20 rows", expect="bulk")
    inside = ~stray
    csr = csr_of(pv, pc, inside, x.numel())
    require(torch.allclose(torch.mv(csr, x), want, **TOL),
            "cuSPARSE CSR matvec disagrees with the plain panel spmv")
    # x 4 bytes off a 16-byte boundary: the cp.async route.
    x_off = offset_copy(x, 4)
    errs = [check_panel(ops, ref, pv, pc, x_off, pids, stray,
                        "2^20 rows, x at +4 B", expect="cp.async")[0]]
    cp_async = lambda: ops.spmv_ell_panel_kernel(pv, pc, x_off, pids,
                                                 panel=PANEL)
    library = lambda: torch.mv(csr, x)
    panel_bytes = row_blocks * PANEL_STEPS * PANEL * 4
    records[("spmv_ell_panel_kernel", REPORTED["spmv_ell_panel_kernel"])] = \
        dict(max_abs_err=perr, ms=time_ms(run), plain_ms=time_ms(plain),
             library_ms=time_ms(library),
             bytes=pv.numel() * 8 + x.numel() * 4 + PANEL_R * 4,
             ops=2 * int(inside.sum()), panel_bytes_read=panel_bytes,
             kernel_route=route, ms_cp_async=time_ms(cp_async),
             device_ms=profile_ms(run),
             device_ms_cp_async=profile_ms(cp_async),
             library_device_ms=profile_ms(library))
    del pv, pc, pids, stray, want, x_off, csr
    # Row blocks that are not a multiple of 64 rows, K / steps of 3 and 1.
    for rb, k, steps, panel in ((300, 9, 3, 1024), (100, 4, 4, 512)):
        m = panel_matrix(dev, gen, 512, rb, k, steps, SPMV_R, panel)
        errs.append(check_panel(ops, ref, *m[:2], x, *m[2:],
                                f"row_block {rb}, K/steps {k // steps}",
                                panel=panel)[0])
    rec = records[("spmv_ell_panel_kernel", REPORTED["spmv_ell_panel_kernel"])]
    rec["max_abs_err"] = max(rec["max_abs_err"], *errs)  # over every route
    torch.cuda.empty_cache()
    return add_bounds(records, bw, flops)


def panel_matrix(dev, gen, row_blocks, row_block, k, steps, n_cols, panel):
    """A panel-sorted ELL matrix for ``spmv_ell_panel_kernel``: step s of
    row block b draws its columns from panel ``panel_ids[b, s]``, then 1 in
    64 entries moves to another panel (``stray``), where it must be
    masked.  Returns (vals, cols, panel_ids, stray)."""
    r, kb, n_panels = row_blocks * row_block, k // steps, n_cols // panel
    pids = torch.randint(0, n_panels, (row_blocks, steps), generator=gen,
                         device=dev, dtype=torch.int32)
    base = (pids.repeat_interleave(row_block, 0)
            .repeat_interleave(kb, 1) * panel)
    cols = base + torch.randint(0, panel, (r, k), generator=gen, device=dev,
                                dtype=torch.int32)
    stray = torch.rand((r, k), generator=gen, device=dev) < 1 / 64
    shift = torch.randint(1, n_panels, (r, k), generator=gen, device=dev,
                          dtype=torch.int32) * panel
    cols = torch.where(stray, (cols + shift) % n_cols, cols)
    vals = torch.randn((r, k), generator=gen, device=dev)
    return vals, cols, pids, stray


def check_panel(ops, ref, vals, cols, x, pids, stray, what, panel=PANEL,
                expect=None):
    """``ops.spmv_ell_panel_kernel`` within TOL of its plain version, with
    one launch and the stray entries masked; logs the route.  Returns
    (max abs err, route, the plain result)."""
    before = ops.spmv_ell_panel_kernel.launches
    got = ops.spmv_ell_panel_kernel(vals, cols, x, pids, panel=panel)
    want = ref.spmv_ell_panel(vals, cols, x, pids, panel=panel)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    plan = ops.spmv_ell_panel_kernel.plan
    log(f"spmv_ell_panel_kernel {what}: route {plan.route}, max abs err "
        f"{err:.3e}, plan {plan}")
    require(torch.allclose(got, want, **TOL),
            f"spmv_ell_panel_kernel {what}: max abs err {err:.3e} over {TOL}")
    require(ops.spmv_ell_panel_kernel.launches == before + 1,
            f"spmv_ell_panel_kernel {what}: not one launch")
    require(expect is None or plan.route == expect,
            f"spmv_ell_panel_kernel {what}: route {plan.route}, not {expect}")
    unmasked = ref.spmv_ell(vals, cols, x)
    require(bool(stray.any()) and not torch.allclose(got, unmasked, **TOL),
            f"spmv_ell_panel_kernel {what}: the stray entries were not "
            "masked")
    return err, plan.route, want


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


def stream_diff(a, b):
    """How many tokens of streams ``a`` differ from ``b`` (same requests,
    same lengths), and in how many requests; the first such token."""
    n = first = 0
    reqs = set()
    for rid in sorted(a):
        for i, (x, y) in enumerate(zip(a[rid], b[rid])):
            if x != y:
                n += 1
                reqs.add(rid)
                first = first or (rid, i)
    total = sum(len(t) for t in a.values())
    return dict(tokens_differing=n, tokens=total, requests=len(reqs),
                first=first or None)


def first_divergence(out, static):
    for rid in sorted(static):
        a, b = out.get(rid, []), static[rid]
        for i in range(max(len(a), len(b))):
            if i >= len(a) or i >= len(b) or a[i] != b[i]:
                return (f"request {rid} token {i}: scheduler "
                        f"{a[i] if i < len(a) else None} vs plain "
                        f"{b[i] if i < len(b) else None}")
    return None


def flip_gap(serve_mod, cfg, dev, params, kv_dtype, prompts, out, static):
    """At the first token where ``out`` leaves ``static``: the top two
    logits of that position on the kernels and on the plain path, from a
    chunked prefill of the prompt and the plain tokens before it (one
    row).  A flip within every call's tolerance shows as a gap near 0."""
    from repro_torch.serve.scheduler import build_prefill_rows

    for rid in sorted(static):
        a, b = out.get(rid, []), static[rid]
        flips = [i for i in range(min(len(a), len(b))) if a[i] != b[i]]
        if flips:
            break
    else:
        return None
    i = flips[0]
    seq = np.concatenate([prompts[rid], np.asarray(b[:i], np.int32)])
    res = dict(request=rid, token=i)
    for impl in ("cuda", "ref"):
        model = serve_mod.PagedLM(cfg, impl=impl, kv_dtype=kv_dtype,
                                  device=dev, params=params)
        cache = serve_mod.PagedKVCache.create(
            cfg, batch=1, max_len=MAX_LEN, page=PAGE, kv_dtype=kv_dtype,
            device=dev)
        cache = cache.allocate(0, cache.pages_for(len(seq)))
        for start in range(0, len(seq), CHUNK):
            toks, counts, slots, starts = build_prefill_rows(
                [(seq, start, 0)], CHUNK, 1)
            logits, cache = model.prefill_batch(toks, counts, slots, starts,
                                                cache)
        top = torch.topk(logits[0].float(), 2)
        res[impl] = dict(top2=top.indices.tolist(),
                         logits=top.values.tolist(),
                         gap=float(top.values[0] - top.values[1]))
    return res


def throughput(serve_mod, cfg, dev, params, prompts, kv_dtype="fp32"):
    """Isolated prefill of all prompts (rows of 8) and 32 decode steps at
    batch 8 on ``kv_dtype`` pools; tokens/s and kernel launches per
    step."""
    from repro_torch.kernels import ops
    from repro_torch.serve.scheduler import build_prefill_rows

    model = serve_mod.PagedLM(cfg, kv_dtype=kv_dtype, device=dev,
                              params=params)
    cache = serve_mod.PagedKVCache.create(
        cfg, batch=BATCH, max_len=MAX_LEN, page=PAGE, kv_dtype=kv_dtype,
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
    # The profiler's kernel count of one decode step and one prefill chunk
    # (the first chunk's rows): every launch, the library's included.
    kernels = {}
    for name, fn in (("decode_step", lambda: model._step(feed, c, c.lengths,
                                                         act)),
                     ("prefill_chunk", lambda: model.prefill_batch(
                         *steps[0], box["cache"]))):
        prof = profile_step(fn)
        kernels[f"{name}_kernels"] = None if prof is None else prof["kernels"]
        kernels[f"{name}_busy_ms"] = None if prof is None else prof["busy_ms"]
    return dict(**kernels,
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


def serve_paged_dtypes(serve_mod, cfg, dev, params, prompts):
    """Phase 4's scheduler runs, one for each of :data:`SERVE_DTYPES`:
    fp32 in a roomy pool; int8, bf16 and the config's own dtype (None: bf16
    for yi-6b, as the reference serves it) in the tight pool.  Each stream
    must equal the plain path's, every kernel of the path launch (one
    paged K/V write a layer a step) and no converter; the None run must
    serve from bf16 pools the bf16 run's stream.  Returns the static
    (plain) streams and the launch counts, by kv_dtype."""
    statics, outs, launch_counts = {}, {}, {}
    paged_kernels = ("paged_kv_write", "paged_decode_attention",
                     "paged_prefill_attention")
    converters = ("indirect_gather", "indirect_scatter")
    for kv_dtype in SERVE_DTYPES:
        pool = tight_pool(prompts) if kv_dtype != "fp32" else None
        out, static, sched, counts, secs = serve(
            serve_mod, cfg, dev, params, kv_dtype, prompts, pool)
        statics[kv_dtype], outs[kv_dtype] = static, out
        launch_counts[kv_dtype] = counts
        div = first_divergence(out, static)
        st = sched.stats
        pools = sched.cache
        log(f"serve {kv_dtype}: pool {pools.total_pages} pages of "
            f"{pools.k_pages.dtype}, {pools.pool_bytes} bytes "
            f"({pools.pool_bytes / (8 * pools.k_pages.numel()):.4f} of fp32 "
            f"pools of that size), "
            f"{st.tokens} tokens in {secs:.3f} s "
            f"({st.tokens / secs:.1f} tokens/s), {st.n_evictions} evictions, "
            f"{st.prefill_steps} prefill steps, {st.decode_steps} decode "
            f"steps; launches {counts}; streams equal to plain path: "
            f"{div is None}")
        if div is not None:
            gap = flip_gap(serve_mod, cfg, dev, params, kv_dtype, prompts,
                           out, static)
            log(f"serve {kv_dtype}: top-2 logit gap at the flip: "
                + json.dumps(gap))
        require(div is None, f"serve {kv_dtype}: first divergence at {div}")
        require(sorted(out) == list(range(N_REQUESTS))
                and all(len(t) == MAX_NEW for t in out.values()),
                f"serve {kv_dtype}: not every request finished")
        require(all(counts[k] > 0 for k in paged_kernels),
                f"serve {kv_dtype}: a kernel never launched: {counts}")
        require(all(counts[k] == 0 for k in converters),
                f"serve {kv_dtype}: a converter launched: {counts}")
        require(counts["paged_kv_write"] == sum(
            counts[k] for k in ATTENTION_KERNELS),
            f"serve {kv_dtype}: not one K/V write a layer a step: {counts}")
        if pool is not None:
            require(st.n_evictions >= 1,
                    f"serve {kv_dtype}: the tight pool forced no eviction")
        if kv_dtype in BF16_DTYPES:
            require(pools.k_pages.dtype == torch.bfloat16
                    and pools.k_scale is None,
                    f"serve {kv_dtype}: pools of {pools.k_pages.dtype}, "
                    f"not bf16 without scales")
    require(outs[None] == outs["bf16"],
            "serve: kv_dtype=None on the bf16 config does not give the "
            "bf16 pools' stream")
    log(f"serve bf16 vs fp32 (a different result, not a fault): "
        f"{stream_diff(outs['bf16'], outs['fp32'])}")
    return statics, launch_counts


def serve_spec_dtypes(serve_mod, cfg, dev, params, prompts, statics, smi):
    """Phase 5's speculative runs, one for each of :data:`SPEC_DTYPES`
    (the tight pool for all but fp32): each stream must equal plain greedy
    (phase 4's static streams), verify launch, no converter.  Returns the
    launch counts by kv_dtype."""
    launch_counts = {}
    converters = ("indirect_gather", "indirect_scatter")
    for kv_dtype in SPEC_DTYPES:
        pool = tight_pool(prompts) if kv_dtype != "fp32" else None
        out, sched, counts, secs = serve_spec(
            serve_mod, cfg, dev, params, kv_dtype, prompts, pool)
        launch_counts[kv_dtype] = counts
        div = first_divergence(out, statics[kv_dtype])
        st = sched.stats
        log(f"serve spec_k={SPEC_K} {kv_dtype} ({smi}): pool "
            f"{sched.cache.total_pages} pages, {st.tokens} tokens in "
            f"{secs:.3f} s ({st.tokens / secs:.1f} tokens/s), "
            f"{st.spec_steps} verify steps, acceptance rate "
            f"{st.acceptance_rate:.4f} ({st.n_accepted}/{st.n_drafted} "
            f"drafts), {st.n_evictions} evictions; launches {counts}; "
            f"streams equal to plain greedy: {div is None}")
        if div is not None:
            log(f"serve spec {kv_dtype}: top-2 logit gap at the flip: "
                + json.dumps(flip_gap(serve_mod, cfg, dev, params, kv_dtype,
                                      prompts, out, statics[kv_dtype])))
        require(div is None,
                f"serve spec {kv_dtype}: first divergence at {div}")
        require(sorted(out) == list(range(N_REQUESTS))
                and all(len(t) == MAX_NEW for t in out.values()),
                f"serve spec {kv_dtype}: not every request finished")
        require(st.spec_steps > 0 and counts["paged_verify"] > 0
                and counts["paged_kv_write"] > 0,
                f"serve spec {kv_dtype}: verify never launched: {counts}")
        require(all(counts[k] == 0 for k in converters),
                f"serve spec {kv_dtype}: a converter launched: {counts}")
        require(counts["paged_kv_write"] == sum(
            counts[k] for k in ATTENTION_KERNELS),
            f"serve spec {kv_dtype}: not one K/V write a layer a step: "
            f"{counts}")
        if pool is not None:
            require(st.n_evictions >= 1,
                    f"serve spec {kv_dtype}: the tight pool forced no "
                    f"eviction")
    return launch_counts


def add_launches(launches, bf16_launches, counts):
    """Add each run's launch counts (``{kv_dtype: counts}``) to the
    totals, and the bf16 pools' runs also to ``bf16_launches``."""
    for kv_dtype, run in counts.items():
        for k, v in run.items():
            launches[k] += v
            if kv_dtype in BF16_DTYPES:
                bf16_launches[k] += v


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
# Phase 7: training, yi-6b width
# ---------------------------------------------------------------------------


def tree_digest(leaves) -> str:
    """A short digest of ``[(path, tensor)]``'s bits: two runs that print
    the same one computed the same tensors, bit for bit (up to a sum's
    collisions).  Each leaf's weighted sum of its 32-bit words (int64,
    wrapping) is taken in slices of 2**26 words, so a leaf of billions of
    elements needs no int64 copy of itself."""
    import hashlib

    sums = []
    for path, t in leaves:
        words = t.detach().contiguous().view(torch.int32).flatten()
        total = 0
        for lo in range(0, words.numel(), 1 << 26):
            bits = words[lo:lo + (1 << 26)].to(torch.int64)
            weight = torch.arange(lo, lo + bits.numel(),
                                  device=t.device) % 65521 + 1
            total += int((bits * weight).sum())
        sums.append([path, (total + (1 << 63)) % (1 << 64) - (1 << 63)])
    return hashlib.sha256(json.dumps(sums).encode()).hexdigest()[:16]


def tree_layout(tree):
    """[(path, shape, dtype)] of a tree's leaves and their total bytes."""
    from repro_torch.models.common import tree_paths

    leaves = tree_paths(tree)
    return ([(path, tuple(t.shape), str(t.dtype).replace("torch.", ""))
             for path, t in leaves], sum(t.nbytes for _, t in leaves))


def record_allocated(label, cfg, params, opt_state):
    """Keep a training phase's tree layouts for phase 13."""
    p_leaves, p_bytes = tree_layout(params)
    o_leaves, o_bytes = tree_layout(opt_state)
    ALLOCATED[label] = dict(cfg=cfg, params=p_leaves, param_bytes=p_bytes,
                            opt_state=o_leaves, opt_bytes=o_bytes,
                            memory_allocated=torch.cuda.memory_allocated())


def visible_keys(i, skv, causal, window):
    """How many keys query row i sees through the attention mask."""
    hi = min(skv, i + 1) if causal else skv
    lo = max(0, i - window + 1) if window is not None else 0
    return max(0, hi - lo)


def visible_pairs(sq, skv, causal, window):
    """The (query, key) pairs the attention mask lets through: the work
    this input needs, which the bound counts."""
    return sum(visible_keys(i, skv, causal, window) for i in range(sq))


def flash_inputs(dev, gen, b, h, kvh, sq, d, dtype, skv=None):
    """q, k, v, do as the training path hands them to the kernels:
    (B, heads, S, D) views of (B, S, heads, D) tensors."""
    skv = sq if skv is None else skv

    def draw(s, heads):
        return torch.randn((b, s, heads, d), generator=gen,
                           device=dev).to(dtype).transpose(1, 2)

    return draw(sq, h), draw(skv, kvh), draw(skv, kvh), draw(sq, h)


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 numbers at each |x| (8 significant bits)."""
    _, exp = torch.frexp(x.float().abs().clamp_min(1e-30))
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), exp - 8)


def flash_case(ops, ref, inputs, causal, window, fwd_tol, bwd_tol, tag,
               oracle):
    """Kernels 8, 9 and 10 against their plain versions on one input (and
    against ``ref.mha`` where ``oracle``): float32 outputs within the
    float32 tolerance, bf16 outputs within it plus ``BF16_ULPS`` bf16
    steps of the plain value.  Returns the max abs errors and each
    output's largest share of its tolerance."""
    q, k, v, do = inputs
    kw = dict(causal=causal, window=window)
    with torch.no_grad():
        o8 = ops.flash_attention(q, k, v, **kw)
    o, lse = ops.flash_attention_fwd(q, k, v, **kw)
    po, plse = ops.flash_attention_fwd(q, k, v, impl="ref", **kw)
    grads = ops.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    pgrads = ops.flash_attention_bwd(q, k, v, o, lse, do, impl="ref", **kw)
    torch.cuda.synchronize()
    require(torch.equal(o8, o), f"flash {tag}: kernels 8 and 9 differ in o")
    errs, shares = {}, {}

    def close(name, got, want, tol):
        bf16 = got.dtype == torch.bfloat16
        got, want = got.float(), want.float()
        diff = (got - want).abs()
        allowed = tol["atol"] + tol["rtol"] * want.abs()
        if bf16:
            allowed = allowed + BF16_ULPS * bf16_ulp(want)
        err = diff.max().item()
        share = (diff / allowed).max().item()
        require(share <= 1.0,
                f"flash {tag} {name}: max abs err {err:.3e}, "
                f"{share:.3f} of the tolerance ({tol}"
                f"{f' + {BF16_ULPS} bf16 ulps' if bf16 else ''})")
        errs[name] = err
        shares[name] = share

    close("o", o, po, fwd_tol)
    close("lse", lse, plse, fwd_tol)
    if oracle:  # in float32 on the same inputs: bf16 ones are exact there
        close("o vs mha", o, ref.mha(q.float(), k.float(), v.float(), **kw),
              fwd_tol)
    for name, g, pg in zip(("dq", "dk", "dv"), grads, pgrads):
        close(name, g, pg, bwd_tol)
    return errs, shares


def family_flash_cases():
    """The families' flash shapes (bf16, B 2, S 4096): (tag, heads, kv
    heads, head dim, causal, window) from each configuration."""
    from repro_torch.configs import get_config

    out = []
    for tag, arch, windowed in FAMILY_FLASH:
        cfg = get_config(arch)
        out.append((tag, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.causal,
                    cfg.window if windowed else None))
    return out


def sdpa_mask(sq, causal, window, dev):
    """The (Sq, Sq) boolean mask SDPA needs for a window (None otherwise:
    ``is_causal`` or nothing)."""
    if window is None:
        return None
    i = torch.arange(sq, device=dev)[:, None]
    j = torch.arange(sq, device=dev)[None, :]
    ok = (i - j) < window
    return ok & (j <= i) if causal else ok


def check_flash_kernels(ops, ref, dev, bw, flops, bf16_flops):
    """Kernels 8-10 against their plain versions on both routes: bf16
    (tensor cores) at the training paths' shapes (yi-6b's 32/4 heads and
    olmoe-1b-7b's 16/16, each timed, with SDPA as the library call) and
    the families' (``FAMILY_FLASH``: hymba-1.5b's window of 1024 and its
    global layers, gemma3-27b's window, qwen2.5-14b's 40/8, internvl2-1b's
    14/2, hubert-xlarge's non-causal 16/16 at D = 80; each timed over
    ``FAMILY_TIMED_N`` runs), a ragged non-causal S = 1000, a causal
    window of 256 (both also against ``ref.mha``), Sq = 512 over Skv = 256
    with fully masked rows (o = 0, lse = -1e30 checked), D = 64, and D =
    80 causal, ragged non-causal and windowed; fp32 (SIMT) at S = 1024, a
    ragged non-causal S = 1000 and a causal window of 256 (the last two
    also against ``ref.mha``), and at D = 80 ragged non-causal and
    windowed.  The bound of the path's bf16 work is taken at the bf16
    tensor-core rate ``bf16_flops``; ``bound_fp32_ms`` is the same work at
    the float32 rate ``flops``.  The rows of the path's shape carry the
    others' numbers under ``shapes``."""
    import torch.nn.functional as F

    from repro_torch.configs import SHAPES, get_config

    cfg, moe = get_config("yi-6b"), get_config(MOE_ARCH)
    b, h, kvh, d = TRAIN_BATCH // TRAIN_ACCUM, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    seq = SHAPES["train_4k"].seq_len
    gen = torch.Generator(device=dev).manual_seed(SEED)
    records = {}
    bf16, fp32 = torch.bfloat16, torch.float32
    cases = [  # tag, shape, causal, window, oracle
        ("path bf16", dict(sq=seq, dtype=bf16), True, None, False),
        ("olmoe path bf16", dict(sq=seq, dtype=bf16, h=moe.n_heads,
                                 kvh=moe.n_kv_heads, d=moe.hd), True, None,
         False),
        ("fp32 1024", dict(sq=1024, dtype=fp32), True, None, False),
        ("fp32 ragged 1000 non-causal", dict(sq=1000, dtype=fp32), False,
         None, True),
        ("fp32 1024 window 256", dict(sq=1024, dtype=fp32), True, 256, True),
        ("bf16 ragged 1000 non-causal", dict(sq=1000, dtype=bf16), False,
         None, True),
        ("bf16 1024 window 256", dict(sq=1024, dtype=bf16), True, 256, True),
        # Sq != Skv, and rows 256 + 63 .. see no key: o = 0, lse = -1e30.
        ("bf16 Sq 512 Skv 256 window 64", dict(sq=512, skv=256, dtype=bf16),
         True, 64, False),
        ("bf16 1024 D 64", dict(sq=1024, dtype=bf16, d=64), True, None,
         False),
        # D = 80 (hubert-xlarge): the bf16 route runs it in D = 128 tiles.
        ("bf16 1024 D 80", dict(sq=1024, dtype=bf16, d=80), True, None,
         False),
        ("bf16 ragged 1000 non-causal D 80", dict(sq=1000, dtype=bf16, d=80),
         False, None, True),
        ("bf16 1024 window 256 D 80", dict(sq=1024, dtype=bf16, d=80), True,
         256, True),
        ("fp32 ragged 1000 non-causal D 80", dict(sq=1000, dtype=fp32, d=80),
         False, None, True),
        ("fp32 1024 window 256 D 80", dict(sq=1024, dtype=fp32, d=80), True,
         256, True),
    ]
    timed = {"path bf16": N_TIMED, "olmoe path bf16": N_TIMED}
    for tag, fh, fkvh, fd, causal, window in family_flash_cases():
        cases.append((tag, dict(sq=seq, dtype=bf16, h=fh, kvh=fkvh, d=fd),
                      causal, window, False))
        timed[tag] = FAMILY_TIMED_N
    for tag, shape, causal, window, oracle in cases:
        inputs = flash_inputs(dev, gen, **{"b": b, "h": h, "kvh": kvh,
                                           "d": d, **shape})
        errs, shares = flash_case(ops, ref, inputs, causal, window,
                                  FP32_FWD_TOL, FP32_BWD_TOL, tag, oracle)
        route = "wgmma" if shape["dtype"] == bf16 else "simt"
        log(f"flash {tag} (route {route}): max abs errors "
            + json.dumps(errs) + "; largest share of the tolerance "
            + json.dumps(shares))
        sq, skv = inputs[0].shape[2], inputs[1].shape[2]
        dead = torch.tensor([visible_keys(i, skv, causal, window) == 0
                             for i in range(sq)], device=dev)
        if dead.any():
            o, lse = ops.flash_attention_fwd(*inputs[:3], causal=causal,
                                             window=window)
            require(bool((o[:, :, dead] == 0).all())
                    and bool((lse[:, :, dead] == -1e30).all()),
                    f"flash {tag}: fully masked rows must give o = 0 and "
                    f"lse = -1e30")
            log(f"flash {tag}: {int(dead.sum())} fully masked rows give "
                f"o = 0, lse = -1e30")
        fwd_err = max(v for k_, v in errs.items() if k_.startswith("o"))
        bwd_err = max(errs[k_] for k_ in ("dq", "dk", "dv"))
        for kname, err in (("flash_attention", fwd_err),
                           ("flash_attention_fwd", max(fwd_err, errs["lse"])),
                           ("flash_attention_bwd", bwd_err)):
            records[(kname, tag)] = dict(max_abs_err=err, ms=None,
                                         plain_ms=None, library_ms=None,
                                         bytes=0, ops=0)
        if tag not in timed:
            continue
        n = timed[tag]
        q, k, v, do = inputs
        kw = dict(causal=causal, window=window)
        d_ = q.shape[3]
        o, lse = ops.flash_attention_fwd(q, k, v, **kw)
        pairs = q.shape[0] * q.shape[1] * visible_pairs(sq, sq, causal,
                                                        window)
        qo_bytes = q.numel() * q.element_size()
        kv_bytes = k.numel() * k.element_size()
        lse_bytes = lse.numel() * 4
        fwd_bytes = 2 * qo_bytes + 2 * kv_bytes
        mask = sdpa_mask(sq, causal, window, dev)
        sdpa = lambda *t: F.scaled_dot_product_attention(  # noqa: E731
            *t, attn_mask=mask, is_causal=causal and mask is None,
            enable_gqa=True)
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = sdpa(*leaves)
        sdpa_bwd = lambda: torch.autograd.grad(  # noqa: E731
            out, leaves, do, retain_graph=True)
        sdpa_fwd_ms = time_ms(lambda: sdpa(q, k, v), n=n)
        plain_fwd_ms = time_ms(
            lambda: ops.flash_attention_fwd(q, k, v, impl="ref", **kw), n=n)
        records[("flash_attention", tag)].update(
            ms=time_ms(lambda: ops.flash_attention(q, k, v, **kw), n=n),
            plain_ms=plain_fwd_ms, library_ms=sdpa_fwd_ms, bytes=fwd_bytes,
            ops=4 * d_ * pairs)
        records[("flash_attention_fwd", tag)].update(
            ms=time_ms(lambda: ops.flash_attention_fwd(q, k, v, **kw), n=n),
            plain_ms=plain_fwd_ms, library_ms=sdpa_fwd_ms,
            bytes=fwd_bytes + lse_bytes, ops=4 * d_ * pairs)
        records[("flash_attention_bwd", tag)].update(
            ms=time_ms(lambda: ops.flash_attention_bwd(q, k, v, o, lse, do,
                                                       **kw), n=n),
            plain_ms=time_ms(lambda: ops.flash_attention_bwd(
                q, k, v, o, lse, do, impl="ref", **kw), n=n),
            library_ms=time_ms(sdpa_bwd, n=n),
            library_fwd_bwd_ms=time_ms(lambda: torch.autograd.grad(
                sdpa(*leaves), leaves, do), n=n),
            bytes=4 * qo_bytes + 4 * kv_bytes + lse_bytes,
            ops=10 * d_ * pairs)
        del out, leaves, inputs, q, k, v, do, o, lse
        torch.cuda.empty_cache()
    add_bounds(records, bw, bf16_flops,
               rate=f"bf16 tensor core {bf16_flops / 1e12:g} TFLOP/s")
    for kname in FLASH_KERNELS:
        for tag in timed:
            rec = records[(kname, tag)]
            # What the kernels' float32 arithmetic could reach at best.
            rec["bound_fp32_ms"] = rec["ops"] / flops * 1e3
        records[(kname, REPORTED[kname])]["shapes"] = {
            tag: {key: records[(kname, tag)].get(key)
                  for key in FLASH_SHAPE_KEYS}
            for tag in timed if tag != REPORTED[kname]}
    torch.cuda.empty_cache()
    return records


def counted(ops, launches, fn):
    """Run ``fn`` with every launch count set to 0 just before it and read
    just after it: the counts are added to ``launches`` and kept as
    ``counted.last``.  Returns what ``fn`` returns."""
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    try:
        return fn()
    finally:
        torch.cuda.synchronize()
        for key, n in ops.launch_counts().items():
            launches[key] += n
        counted.last = ops.launch_counts()


def training_optimizer(cfg):
    """The training phase's AdamW (no warmup, decayed over its steps)."""
    from repro_torch.optim import OptimizerConfig, make_optimizer

    return make_optimizer(OptimizerConfig(
        name=cfg.optimizer, lr=cfg.learning_rate, warmup_steps=0,
        total_steps=TRAIN_STEPS, weight_decay=cfg.weight_decay,
        grad_clip=cfg.grad_clip))


def training_batches(cfg, dev, tmp):
    """The training phase's batches: ``make_batch(step)`` over a synthetic
    corpus written into ``tmp`` from the seed."""
    from repro_torch.configs import SHAPES
    from repro_torch.data import TokenDataset, synthetic_corpus

    seq = SHAPES["train_4k"].seq_len
    corpus = os.path.join(tmp, "corpus")
    synthetic_corpus(corpus, n_tokens=(TRAIN_STEPS * TRAIN_BATCH + 1)
                     * (seq + 1), vocab=cfg.vocab, seed=SEED)
    ds = TokenDataset(corpus, seq, TRAIN_BATCH)

    def make_batch(step):
        return {key: torch.as_tensor(val).to(dev)
                for key, val in ds.batch(step).items()}

    return make_batch


def run_training(dev):
    """Phase 7: yi-6b at full width, 4 layers, through the port's training
    path (``make_train_step`` under ``TrainController``).  Returns (the
    phase's numbers, the launch counts of its main-path runs)."""
    import dataclasses
    import shutil
    import tempfile

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.models.common import tree_leaves, tree_paths
    from repro_torch.optim import global_norm
    from repro_torch.runtime import FaultToleranceConfig, TrainController
    from repro_torch.train import (grads_with_accum, make_loss_fn,
                                   make_train_step)

    cfg = dataclasses.replace(get_config("yi-6b"), n_layers=TRAIN_LAYERS)
    seq = SHAPES["train_4k"].seq_len
    launches = {k: 0 for k in ops.launch_counts()}
    out = dict(layers=cfg.n_layers, d_model=cfg.d_model,
               heads=f"{cfg.n_heads}/{cfg.n_kv_heads}", d_ff=cfg.d_ff,
               vocab=cfg.vocab, seq=seq, global_batch=TRAIN_BATCH,
               grad_accum=TRAIN_ACCUM, dtype=cfg.dtype,
               param_dtype=cfg.param_dtype, remat=cfg.remat)

    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        make_batch = training_batches(cfg, dev, tmp)

        opt = training_optimizer(cfg)
        train_step = make_train_step(cfg, opt, grad_accum=TRAIN_ACCUM)

        def step_fn(state, batch, step):
            p, o, metrics = train_step(state["params"], state["opt"], batch,
                                       step)
            return {"params": p, "opt": o}, metrics

        def fresh():
            params = lm.init_model(cfg, seed=SEED, device=dev)
            return {"params": params, "opt": opt.init(params)}

        # The plain path's first step (no update): loss and gradient norm.
        params = lm.init_model(cfg, seed=SEED, device=dev)
        out["params"] = sum(t.numel() for t in tree_leaves(params))
        batch0 = make_batch(0)
        loss_p, _, grads = grads_with_accum(make_loss_fn(cfg, "ref"), params,
                                            batch0, TRAIN_ACCUM)
        out.update(plain_step0_loss=float(loss_p),
                   plain_step0_grad_norm=float(global_norm(grads)))
        del grads

        # Determinism, which the bitwise resume below rests on: the kernel
        # path's gradients of one batch, twice, equal leaf by leaf.  The
        # digest lets two runs of this script be compared as well.
        loss_fn = make_loss_fn(cfg)
        grads_a = tree_paths(grads_with_accum(loss_fn, params, batch0,
                                              TRAIN_ACCUM)[2])
        grads_b = tree_paths(grads_with_accum(loss_fn, params, batch0,
                                              TRAIN_ACCUM)[2])
        differ = [path for (path, a), (_, b) in zip(grads_a, grads_b)
                  if not torch.equal(a, b)]
        out.update(step0_grads_differ=differ,
                   step0_grad_digest=tree_digest(grads_a))
        require(not differ, f"training: the gradients of one batch differ "
                f"between two runs in {differ}")
        del grads_a, grads_b

        # Forward-only loss, kernel 8 against the plain path, one microbatch.
        micro = {key: val[:TRAIN_BATCH // TRAIN_ACCUM]
                 for key, val in batch0.items()}
        with torch.no_grad():
            fwd_k = float(counted(ops, launches, lambda: lm.train_loss(
                params, micro, cfg)[0]))
            fwd_counts = counted.last
            fwd_p = float(lm.train_loss(params, micro, cfg, impl="ref")[0])
        out.update(no_grad_loss_kernel=fwd_k, no_grad_loss_plain=fwd_p,
                   no_grad_launches=fwd_counts)
        require(abs(fwd_k - fwd_p) <= LOSS_RTOL * abs(fwd_p),
                f"training: forward-only loss {fwd_k} (kernels) vs {fwd_p} "
                f"(plain) over {LOSS_RTOL} relative")
        require(fwd_counts["flash_attention"] == cfg.n_layers,
                f"training: the forward-only loss launched {fwd_counts}")
        del params, micro
        torch.cuda.empty_cache()

        # The straight run: 6 steps, checkpoints at 3 and 6.
        ft = FaultToleranceConfig(ckpt_dir=os.path.join(tmp, "ckpt"),
                                  ckpt_every=TRAIN_CKPT_EVERY, keep=2)
        c1 = TrainController(step_fn, make_batch, ft)
        state = fresh()
        record_allocated(f"yi-6b ({cfg.n_layers} layers)", cfg,
                         state["params"], state["opt"])
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state = counted(ops, launches, lambda: c1.run(
            state, TRAIN_STEPS, log_every=1, log_fn=log))
        out["straight_run_s"] = time.perf_counter() - t0
        counts = counted.last
        out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
        losses = [hist["loss"] for hist in c1.history]
        norms = [hist["grad_norm"] for hist in c1.history]
        out.update(losses=losses, grad_norms=norms,
                   step_s=c1.watchdog.history,
                   launches_per_step={key: counts[key] / TRAIN_STEPS
                                      for key in FLASH_KERNELS})
        require(all(np.isfinite(losses)) and all(np.isfinite(norms)),
                f"training: a loss is not finite: {losses} {norms}")
        require(counts["flash_attention_fwd"] > 0
                and counts["flash_attention_bwd"] > 0,
                f"training: a flash kernel never launched: {counts}")
        for key, want in (("loss", out["plain_step0_loss"]),
                          ("grad_norm", out["plain_step0_grad_norm"])):
            got = c1.history[0][key]
            rtol = LOSS_RTOL if key == "loss" else GRAD_NORM_RTOL
            require(abs(got - want) <= rtol * abs(want),
                    f"training: step 0 {key} {got} (kernels) vs {want} "
                    f"(plain) over {rtol} relative")
        step_s = statistics.median(c1.watchdog.history[1:])
        out.update(step_median_s=step_s,
                   tokens_per_s=TRAIN_BATCH * seq / step_s)

        # One more step, timed and profiled: the device's idle share.
        extra = make_batch(TRAIN_STEPS)
        one = lambda: step_fn(state, extra, TRAIN_STEPS)  # noqa: E731
        wall_ms = statistics.median(sync_ms(one) for _ in range(2))
        out.update(step_wall_ms=wall_ms, device_busy_ms="not measured")
        prof = profile_step(one, top=12)  # the flash kernels among them
        if prof is not None:
            out.update(device_busy_ms=prof["busy_ms"],
                       device_idle_share=1.0 - prof["busy_ms"] / wall_ms,
                       kernels_per_step=prof["kernels"], top=prof["top"])
        del state, one, extra
        torch.cuda.empty_cache()

        # A run killed at step 4 leaves the step-3 checkpoint as its
        # newest, as the straight run did before it went on: with step 6's
        # dropped, a fresh controller resumes from step 3, runs steps 3
        # and 4, and is killed at step 5.  Its losses must be the straight
        # run's, bit for bit.
        shutil.rmtree(os.path.join(ft.ckpt_dir, f"step_{TRAIN_STEPS:08d}"))
        c2 = TrainController(step_fn, make_batch, ft)
        require(c2.ckpt.latest_step() == TRAIN_CKPT_EVERY,
                f"training: resume finds step {c2.ckpt.latest_step()}")
        t0 = time.perf_counter()
        try:
            counted(ops, launches, lambda: c2.run(
                fresh(), TRAIN_STEPS, preempt_at=TRAIN_PREEMPT + 1,
                log_every=100))
            require(False, "training: the preemption never came")
        except KeyboardInterrupt:
            pass
        out["resumed_run_s"] = time.perf_counter() - t0
        resumed = [hist["loss"] for hist in c2.history]
        out["resumed_losses"] = resumed
        want = losses[TRAIN_CKPT_EVERY:TRAIN_PREEMPT + 1]
        out["resumed_equal_bitwise"] = resumed == want
        require(resumed == want,
                f"training: resumed losses {resumed} are not the straight "
                f"run's {want} bit for bit")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    return out, launches


# ---------------------------------------------------------------------------
# Phases 8 and 9: olmoe-1b-7b, dense generation and training
# ---------------------------------------------------------------------------


def run_moe_serving(dev):
    """Phase 8: olmoe-1b-7b at full size (random weights from a seeded
    generator) through ``dense_generate`` on the kernels and on the plain
    path.  Returns (the phase's numbers, the launch counts of the kernel
    path's run)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import dense_generate
    from repro_torch.models import lm
    from repro_torch.models.common import tree_leaves

    cfg = get_config(MOE_ARCH)
    params = lm.init_model(cfg, seed=SEED, device=dev)
    n_params = sum(t.numel() for t in tree_leaves(params))
    SERVED[MOE_ARCH] = dict(cfg=cfg, param_bytes=tree_layout(params)[1],
                            memory_allocated=torch.cuda.memory_allocated())
    rng = np.random.default_rng(SEED)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab,
                                           (MOE_BATCH, MOE_PROMPT)),
                              dtype=torch.int32, device=dev)
    max_len = MOE_PROMPT + MOE_NEW
    out = dict(layers=cfg.n_layers, d_model=cfg.d_model,
               experts=f"{cfg.n_experts} top-{cfg.top_k}", d_ff=cfg.d_ff,
               vocab=cfg.vocab, params=n_params,
               weight_gb=n_params * 4 / 1e9, batch=MOE_BATCH,
               prompt=MOE_PROMPT, new_tokens=MOE_NEW, dtype=cfg.dtype)
    log(f"{MOE_ARCH}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_experts} experts top-{cfg.top_k}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab}; {n_params:,} parameters, {n_params * 4 / 1e9:.2f} GB "
        f"of fp32 weights")

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    toks = dense_generate(cfg, params, prompts, MOE_NEW, max_len=max_len)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = ops.launch_counts()
    plain = dense_generate(cfg, params, prompts, MOE_NEW, max_len=max_len,
                           impl="ref")
    equal = bool((toks == plain).all())
    flips = np.argwhere(toks != plain)[:3].tolist()
    out.update(generate_s=secs, tokens_per_s=MOE_BATCH * MOE_NEW / secs,
               streams_equal=equal, first_flips=flips, launches=launches,
               sample=toks[0, :16].tolist())
    require(equal, f"serve {MOE_ARCH}: kernel and plain token streams "
            f"differ at (row, token) {flips}")
    steps = MOE_NEW + 1  # the prefill, then a decode step per token
    require(all(launches[k] == cfg.n_layers * steps for k in MOE_CONVERTERS)
            and sum(launches.values()) == 2 * cfg.n_layers * steps,
            f"serve {MOE_ARCH}: not one scatter and one gather a layer a "
            f"step: {launches}")

    with torch.no_grad():
        def prefill(impl="cuda"):
            cache = lm.init_cache(cfg, MOE_BATCH, max_len, device=dev)
            return lm.prefill(params, {"tokens": prompts}, cache, cfg,
                              impl=impl)

        logits_k, cache = prefill()
        logits_p, _ = prefill("ref")
        torch.cuda.synchronize()
        out["prefill_logits_bitwise"] = torch.equal(logits_k, logits_p)
        require(out["prefill_logits_bitwise"], f"serve {MOE_ARCH}: prefill "
                f"logits differ between the kernel and plain paths")
        prefill_ms = statistics.median(sync_ms(prefill) for _ in range(3))
        tok = torch.argmax(logits_k[:, 0, :cfg.vocab], dim=-1)[:, None]

        def step():
            return lm.decode_step(params, tok, cache, MOE_PROMPT, cfg)

        decode_ms = statistics.median(sync_ms(step) for _ in range(5))
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        step()
        torch.cuda.synchronize()
        per_step = {k: v for k, v in ops.launch_counts().items() if v}
        out.update(prefill_ms=prefill_ms,
                   prefill_tokens_per_s=MOE_BATCH * MOE_PROMPT
                   / prefill_ms * 1e3,
                   decode_step_ms=decode_ms,
                   decode_tokens_per_s=MOE_BATCH / decode_ms * 1e3,
                   launches_per_decode_step=per_step,
                   device_busy_ms="not measured")
        require(per_step == {k: cfg.n_layers for k in MOE_CONVERTERS},
                f"serve {MOE_ARCH}: a decode step launched {per_step}")
        prof = profile_step(step, top=8)
        if prof is not None:
            out.update(device_busy_ms=prof["busy_ms"],
                       device_idle_share=1.0 - prof["busy_ms"] / decode_ms,
                       kernels_per_decode_step=prof["kernels"],
                       top=prof["top"])
    del params, cache, logits_k, logits_p
    torch.cuda.empty_cache()
    return out, launches


def run_moe_training(dev):
    """Phase 9: olmoe-1b-7b at full width cut to MOE_TRAIN_LAYERS layers
    through ``make_train_step`` (AdamW, 2 microbatches, remat).  Returns
    (the phase's numbers, the launch counts of its main-path runs)."""
    import dataclasses
    import shutil
    import tempfile

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.data import TokenDataset, synthetic_corpus
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.models.common import tree_leaves, tree_paths
    from repro_torch.optim import OptimizerConfig, global_norm, make_optimizer
    from repro_torch.train import (grads_with_accum, make_loss_fn,
                                   make_train_step)

    cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=MOE_TRAIN_LAYERS)
    seq = SHAPES["train_4k"].seq_len
    launches = {k: 0 for k in ops.launch_counts()}
    out = dict(layers=cfg.n_layers, d_model=cfg.d_model,
               experts=f"{cfg.n_experts} top-{cfg.top_k}", d_ff=cfg.d_ff,
               vocab=cfg.vocab, seq=seq, global_batch=TRAIN_BATCH,
               grad_accum=TRAIN_ACCUM, dtype=cfg.dtype,
               param_dtype=cfg.param_dtype, remat=cfg.remat,
               steps=MOE_TRAIN_STEPS)

    tmp = tempfile.mkdtemp(prefix="chip_smoke_moe_")
    try:
        corpus = os.path.join(tmp, "corpus")
        synthetic_corpus(corpus, n_tokens=(MOE_TRAIN_STEPS + 2) * TRAIN_BATCH
                         * (seq + 1), vocab=cfg.vocab, seed=SEED)
        ds = TokenDataset(corpus, seq, TRAIN_BATCH)

        def make_batch(step):
            return {key: torch.as_tensor(val).to(dev)
                    for key, val in ds.batch(step).items()}

        params = lm.init_model(cfg, seed=SEED, device=dev)
        out["params"] = sum(t.numel() for t in tree_leaves(params))
        batch0 = make_batch(0)
        torch.cuda.reset_peak_memory_stats()

        # The plain path's gradients of the first batch (no update).
        loss_p, _, grads = grads_with_accum(make_loss_fn(cfg, "ref"), params,
                                            batch0, TRAIN_ACCUM)
        out.update(plain_step0_loss=float(loss_p),
                   plain_step0_grad_norm=float(global_norm(grads)))
        del grads

        # The kernel path's gradients of the same batch, twice: equal leaf
        # by leaf (no atomics on the path), one scatter and one gather a
        # layer a microbatch in each of forward, recompute and backward.
        loss_fn = make_loss_fn(cfg)
        grads_a = tree_paths(counted(ops, launches, lambda: grads_with_accum(
            loss_fn, params, batch0, TRAIN_ACCUM))[2])
        per_grads = counted.last
        digest = tree_digest(grads_a)
        grads_b = tree_paths(grads_with_accum(loss_fn, params, batch0,
                                              TRAIN_ACCUM)[2])
        differ = [path for (path, a), (_, b) in zip(grads_a, grads_b)
                  if not torch.equal(a, b)]
        out.update(step0_grads_differ=differ, step0_grad_digest=digest,
                   launches_per_step={k: per_grads[k] for k in
                                      MOE_CONVERTERS + FLASH_KERNELS})
        require(not differ, f"moe training: the gradients of one batch "
                f"differ between two runs in {differ}")
        want = cfg.n_layers * TRAIN_ACCUM * 3
        require(all(per_grads[k] == want for k in MOE_CONVERTERS),
                f"moe training: a step's gradients launched {per_grads}, not "
                f"{want} scatters and gathers")
        del grads_a, grads_b
        torch.cuda.empty_cache()

        # The steps: AdamW, one batch each, no checkpoints.
        opt = make_optimizer(OptimizerConfig(
            name=cfg.optimizer, lr=cfg.learning_rate, warmup_steps=0,
            total_steps=MOE_TRAIN_STEPS, weight_decay=cfg.weight_decay,
            grad_clip=cfg.grad_clip))
        train_step = make_train_step(cfg, opt, grad_accum=TRAIN_ACCUM)
        state = {"params": params, "opt": opt.init(params)}
        record_allocated(f"{MOE_ARCH} ({cfg.n_layers} layers)", cfg,
                         state["params"], state["opt"])
        history, step_s = [], []

        def one(step):
            p, o, metrics = train_step(state["params"], state["opt"],
                                       make_batch(step), step)
            state.update(params=p, opt=o)
            return metrics

        def run_steps():
            for step in range(MOE_TRAIN_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                metrics = one(step)
                history.append({k: float(v) for k, v in metrics.items()})
                step_s.append(time.perf_counter() - t0)
                log(f"moe step {step}: loss {history[-1]['loss']:.6f} "
                    f"grad_norm {history[-1]['grad_norm']:.6f} "
                    f"{step_s[-1]:.3f} s")

        counted(ops, launches, run_steps)
        counts = counted.last
        losses = [h["loss"] for h in history]
        norms = [h["grad_norm"] for h in history]
        step_med = statistics.median(step_s[1:])
        out.update(losses=losses, grad_norms=norms, step_s=step_s,
                   step_median_s=step_med,
                   tokens_per_s=TRAIN_BATCH * seq / step_med,
                   peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
        require(all(np.isfinite(losses)) and all(np.isfinite(norms)),
                f"moe training: a loss is not finite: {losses} {norms}")
        require(all(counts[k] == want * MOE_TRAIN_STEPS
                    for k in MOE_CONVERTERS)
                and counts["flash_attention_fwd"] > 0
                and counts["flash_attention_bwd"] > 0,
                f"moe training: the steps launched {counts}")
        for key, ref_val in (("loss", out["plain_step0_loss"]),
                             ("grad_norm", out["plain_step0_grad_norm"])):
            got = history[0][key]
            rtol = LOSS_RTOL if key == "loss" else GRAD_NORM_RTOL
            require(abs(got - ref_val) <= rtol * abs(ref_val),
                    f"moe training: step 0 {key} {got} (kernels) vs "
                    f"{ref_val} (plain) over {rtol} relative")

        # One more step, timed and profiled: the device's idle share.
        wall_ms = sync_ms(lambda: one(MOE_TRAIN_STEPS))
        out.update(step_wall_ms=wall_ms, device_busy_ms="not measured")
        prof = profile_step(lambda: one(MOE_TRAIN_STEPS + 1), top=12)
        if prof is not None:
            out.update(device_busy_ms=prof["busy_ms"],
                       device_idle_share=1.0 - prof["busy_ms"] / wall_ms,
                       kernels_per_step=prof["kernels"], top=prof["top"])
        del state, params, batch0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    return out, launches


# ---------------------------------------------------------------------------
# Phases 10-12: hymba-1.5b and hubert-xlarge at full size
# ---------------------------------------------------------------------------


def run_family_training(arch, dev):
    """Phases 10 and 11: ``arch`` at full size, no cut, through the
    training path (``grads_with_accum`` and the optimizer's update, as
    ``make_train_step`` runs them): the plain path's first-batch loss and
    gradient norm against the kernels' step 0 (1e-5 and 1e-3 relative);
    the kernel path's gradients of that batch, twice, equal leaf by leaf,
    with the flash kernels' launches counted (forward with lse twice a
    layer a microbatch under remat, the backward once); step 0 is the
    update by those gradients, then FAMILY_STEPS - 1 timed steps; every
    loss finite; step time, tokens/s, peak memory and the idle share of a
    profiled step.  Returns (the phase's numbers, the launch counts of its
    main-path runs)."""
    import shutil
    import tempfile

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.data import (TokenDataset, make_frontend_batch,
                                  synthetic_corpus)
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.models.common import tree_leaves, tree_paths
    from repro_torch.optim import OptimizerConfig, global_norm, make_optimizer
    from repro_torch.train import (grads_with_accum, make_loss_fn,
                                   make_train_step)

    cfg = get_config(arch)
    seq = SHAPES["train_4k"].seq_len
    launches = {k: 0 for k in ops.launch_counts()}
    out = dict(layers=cfg.n_layers, d_model=cfg.d_model,
               heads=f"{cfg.n_heads}/{cfg.n_kv_heads}", head_dim=cfg.hd,
               d_ff=cfg.d_ff, vocab=cfg.vocab, window=cfg.window,
               causal=cfg.causal, modality=cfg.modality, ssm=cfg.ssm,
               seq=seq, global_batch=TRAIN_BATCH, grad_accum=TRAIN_ACCUM,
               dtype=cfg.dtype, param_dtype=cfg.param_dtype,
               remat=cfg.remat, steps=FAMILY_STEPS,
               config_param_count=cfg.param_count())

    tmp = tempfile.mkdtemp(prefix="chip_smoke_family_")
    try:
        corpus = os.path.join(tmp, "corpus")
        synthetic_corpus(corpus, n_tokens=(FAMILY_STEPS + 2) * TRAIN_BATCH
                         * (seq + 1), vocab=cfg.vocab, seed=SEED)
        ds = TokenDataset(corpus, seq, TRAIN_BATCH)

        def make_batch(step):
            batch = make_frontend_batch(ds.batch(step), cfg,
                                        np.random.default_rng(SEED + step))
            return {key: torch.as_tensor(val).to(dev)
                    for key, val in batch.items()}

        params = lm.init_model(cfg, seed=SEED, device=dev)
        out["params"] = sum(t.numel() for t in tree_leaves(params))
        log(f"{arch}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
            f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.hd}, vocab "
            f"{cfg.vocab}; {out['params']:,} parameters "
            f"(ArchConfig.param_count {out['config_param_count']:,})")
        batch0 = make_batch(0)
        torch.cuda.reset_peak_memory_stats()

        loss_p, _, grads = grads_with_accum(make_loss_fn(cfg, "ref"), params,
                                            batch0, TRAIN_ACCUM)
        out.update(plain_step0_loss=float(loss_p),
                   plain_step0_grad_norm=float(global_norm(grads)))
        del grads

        loss_fn = make_loss_fn(cfg)
        loss_a, _, grads_a = counted(ops, launches, lambda: grads_with_accum(
            loss_fn, params, batch0, TRAIN_ACCUM))
        per_step = counted.last
        grads_b = grads_with_accum(loss_fn, params, batch0, TRAIN_ACCUM)[2]
        differ = [path for (path, a), (_, b) in zip(tree_paths(grads_a),
                                                    tree_paths(grads_b))
                  if not torch.equal(a, b)]
        out.update(step0_grads_differ=differ,
                   step0_grad_digest=tree_digest(tree_paths(grads_a)),
                   launches_per_step={k: per_step[k] for k in FLASH_KERNELS})
        del grads_b
        require(not differ, f"{arch} training: the gradients of one batch "
                f"differ between two runs in {differ}")
        want = {"flash_attention": 0,
                "flash_attention_fwd": 2 * cfg.n_layers * TRAIN_ACCUM,
                "flash_attention_bwd": cfg.n_layers * TRAIN_ACCUM}
        require(out["launches_per_step"] == want,
                f"{arch} training: a step's gradients launched "
                f"{out['launches_per_step']}, not {want}")

        # Step 0 is the update by those gradients; then the timed steps.
        opt = make_optimizer(OptimizerConfig(
            name=cfg.optimizer, lr=cfg.learning_rate, warmup_steps=0,
            total_steps=FAMILY_STEPS, weight_decay=cfg.weight_decay,
            grad_clip=cfg.grad_clip))
        train_step = make_train_step(cfg, opt, grad_accum=TRAIN_ACCUM)
        p, o, metrics = opt.update(grads_a, opt.init(params), params, 0)
        state = {"params": p, "opt": o}
        record_allocated(f"{arch} (full size)", cfg, p, o)
        history = [{"loss": float(loss_a),
                    **{k: float(v) for k, v in metrics.items()}}]
        del grads_a
        step_s = []

        def one(step):
            p, o, metrics = train_step(state["params"], state["opt"],
                                       make_batch(step), step)
            state.update(params=p, opt=o)
            return metrics

        def run_steps():
            for step in range(1, FAMILY_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                metrics = one(step)
                history.append({k: float(v) for k, v in metrics.items()})
                step_s.append(time.perf_counter() - t0)
                log(f"{arch} step {step}: loss {history[-1]['loss']:.6f} "
                    f"grad_norm {history[-1]['grad_norm']:.6f} "
                    f"{step_s[-1]:.3f} s")

        counted(ops, launches, run_steps)
        counts = counted.last
        losses = [h_["loss"] for h_ in history]
        norms = [h_["grad_norm"] for h_ in history]
        step_med = statistics.median(step_s)
        out.update(losses=losses, grad_norms=norms, step_s=step_s,
                   step_median_s=step_med,
                   tokens_per_s=TRAIN_BATCH * seq / step_med,
                   peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
        require(all(np.isfinite(losses)) and all(np.isfinite(norms)),
                f"{arch} training: a loss is not finite: {losses} {norms}")
        require(all(counts[k] == want[k] * (FAMILY_STEPS - 1)
                    for k in FLASH_KERNELS),
                f"{arch} training: the steps launched {counts}")
        for key, ref_val in (("loss", out["plain_step0_loss"]),
                             ("grad_norm", out["plain_step0_grad_norm"])):
            got = history[0][key]
            rtol = LOSS_RTOL if key == "loss" else GRAD_NORM_RTOL
            require(abs(got - ref_val) <= rtol * abs(ref_val),
                    f"{arch} training: step 0 {key} {got} (kernels) vs "
                    f"{ref_val} (plain) over {rtol} relative")

        # One more step under the profiler: the device's idle share against
        # the timed steps' median.
        out["device_busy_ms"] = "not measured"
        prof = profile_step(lambda: one(FAMILY_STEPS), top=12, warm=False)
        if prof is not None:
            out.update(device_busy_ms=prof["busy_ms"],
                       device_idle_share=1.0 - prof["busy_ms"]
                       / (step_med * 1e3),
                       kernels_per_step=prof["kernels"], top=prof["top"])
        del state, params, batch0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    return out, launches


def run_hymba_serving(dev):
    """Phase 12: hymba-1.5b at full size (random weights from a seeded
    generator) through ``dense_generate`` (bf16 activations), and the
    full-forward contract at float32 activations with the same weights.
    Returns (the phase's numbers, the launch counts of its runs)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import dense_generate
    from repro_torch.models import lm
    from repro_torch.models.common import map_tree, tree_leaves

    cfg = get_config(HYMBA)
    launches = {k: 0 for k in ops.launch_counts()}
    params = lm.init_model(cfg, seed=SEED, device=dev)
    n_params = sum(t.numel() for t in tree_leaves(params))
    rng = np.random.default_rng(SEED)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab,
                                           (HYMBA_BATCH, HYMBA_PROMPT)),
                              dtype=torch.int32, device=dev)
    max_len = HYMBA_PROMPT + HYMBA_NEW
    out = dict(params=n_params, batch=HYMBA_BATCH, prompt=HYMBA_PROMPT,
               new_tokens=HYMBA_NEW, dtype=cfg.dtype)

    t0 = time.perf_counter()
    toks = counted(ops, launches, lambda: dense_generate(
        cfg, params, prompts, HYMBA_NEW, max_len=max_len))
    secs = time.perf_counter() - t0
    require(toks.shape == (HYMBA_BATCH, HYMBA_NEW)
            and int(toks.max()) < cfg.vocab and int(toks.min()) >= 0,
            f"serve {HYMBA}: generated {toks.shape}, ids out of the vocab")
    out.update(generate_s=secs, tokens_per_s=HYMBA_BATCH * HYMBA_NEW / secs,
               sample=toks[0, :16].tolist(), launches=counted.last)

    with torch.no_grad():
        def prefill():
            cache = lm.init_cache(cfg, HYMBA_BATCH, max_len, device=dev)
            return lm.prefill(params, {"tokens": prompts}, cache, cfg)

        logits, cache = prefill()
        require(bool(torch.isfinite(logits).all()),
                f"serve {HYMBA}: prefill logits are not finite")
        prefill_ms = statistics.median(sync_ms(prefill) for _ in range(3))
        tok = torch.argmax(logits[:, 0, :cfg.vocab], dim=-1)[:, None]

        def step():
            return lm.decode_step(params, tok, cache, HYMBA_PROMPT, cfg)

        decode_ms = statistics.median(sync_ms(step) for _ in range(5))
        out.update(prefill_ms=prefill_ms,
                   prefill_tokens_per_s=HYMBA_BATCH * HYMBA_PROMPT
                   / prefill_ms * 1e3,
                   decode_step_ms=decode_ms,
                   decode_tokens_per_s=HYMBA_BATCH / decode_ms * 1e3,
                   device_busy_ms="not measured")
        prof = profile_step(step, top=8)
        if prof is not None:
            out.update(device_busy_ms=prof["busy_ms"],
                       device_idle_share=1.0 - prof["busy_ms"] / decode_ms,
                       kernels_per_decode_step=prof["kernels"],
                       top=prof["top"])
        del cache, logits

        # test_arch_smoke.py's contract at full size: prefill, then one
        # decode step a token, against one full forward over the same
        # tokens (the flash kernels, the SIMT route at float32).  Its
        # tolerance is set for float32 activations, so the check runs the
        # same weights with dtype float32.
        fcfg = dataclasses.replace(cfg, dtype="float32")
        total = CONTRACT_PROMPT + CONTRACT_NEW
        tokens = torch.as_tensor(rng.integers(0, cfg.vocab,
                                              (CONTRACT_BATCH, total)),
                                 device=dev)

        def full_forward():
            x = lm.embed_tokens(params, {"tokens": tokens}, fcfg)
            positions = torch.arange(total, device=dev)
            flags = lm.global_flags(fcfg)
            for i in range(fcfg.n_layers):
                lp = map_tree(lambda t: t[i], params["layers"])
                x, _ = lm._block_train(x, lp, fcfg, bool(flags[i]),
                                       positions, "cuda")
            return lm._logits(params, x, fcfg)

        full = counted(ops, launches, full_forward)
        out["contract_launches"] = {k: v for k, v in counted.last.items()
                                    if v}
        cache = lm.init_cache(fcfg, CONTRACT_BATCH, total, device=dev)
        lg, cache = lm.prefill(params, {"tokens": tokens[:, :CONTRACT_PROMPT]},
                               cache, fcfg)
        errs = [float((lg[:, 0] - full[:, CONTRACT_PROMPT - 1]).abs().max())]
        for t in range(CONTRACT_PROMPT, total):
            lg, cache = lm.decode_step(params, tokens[:, t:t + 1], cache, t,
                                       fcfg)
            errs.append(float((lg - full[:, t]).abs().max()))
        out.update(contract_max_err=max(errs), contract_prefill_err=errs[0],
                   contract_tokens=f"{CONTRACT_BATCH} x ({CONTRACT_PROMPT} "
                   f"+ {CONTRACT_NEW})",
                   contract_logit_absmax=float(full.abs().max()))
        require(out["contract_launches"].get("flash_attention", 0)
                == fcfg.n_layers,
                f"serve {HYMBA}: the full forward launched "
                f"{out['contract_launches']}")
        require(max(errs) < CONTRACT_TOL,
                f"serve {HYMBA}: prefill plus decode against the full "
                f"forward: max abs err {max(errs)} over {CONTRACT_TOL}")
        del full, cache, lg
    del params
    torch.cuda.empty_cache()
    return out, launches


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# Phase 13: the dry run
# ---------------------------------------------------------------------------


def run_dryrun(smi):
    """Phase 13: every production cell on ``meta`` tensors against this
    card's memory, then the world-size-1 check against what the training
    phases allocated (``ALLOCATED``) and phase 8's serving weights
    (``SERVED``), while the per-device analyses of ``PER_DEVICE_CELLS``
    run in subprocesses (:func:`start_per_device`).  Returns the phase's
    numbers."""
    import dataclasses

    from repro_torch.configs import SHAPES
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.specs import build_cell

    # Per-device dot FLOPs and collectives of six production cells, each
    # step run as meta DTensors over a fake 256- or 512-rank group in a
    # subprocess of its own (phase 14 owns this process's group).
    pending = start_per_device()
    card = dryrun.card_info()
    mem = card["total_memory"]
    gib = 2 ** 30
    t0 = time.perf_counter()
    rows = []
    for multi_pod in (False, True):
        for arch, shape in dryrun.all_cells():
            rec = dryrun.run_cell(arch, shape, multi_pod, save=False,
                                  flops=False, card=card)
            rows.append(rec)
            groups = ", ".join(f"{g} {b / gib:.3f}" for g, b in
                               rec["memory"]["by_group"].items())
            log(f"dryrun {arch:14s} {shape:12s} {rec['mesh']:10s} "
                f"{rec['memory']['argument_gib']:8.3f} GiB a device of "
                f"{mem / gib:.2f} GiB ({smi}): fits={rec['fits']} "
                f"[{groups}]")
    secs = time.perf_counter() - t0
    require(len(rows) == DRYRUN_CELLS,
            f"dryrun: {len(rows)} cells built, not {DRYRUN_CELLS}")
    fits = sum(bool(r["fits"]) for r in rows)
    log(f"dryrun: {len(rows)} cells in {secs:.2f} s; {fits} fit "
        f"{mem / gib:.2f} GiB ({smi}); temp bytes not measured (no torch "
        f"counterpart)")
    out = dict(cells=len(rows), seconds=secs, fit=fits,
               card_memory=mem, world_size_1={})

    # World size 1: the dry run's bytes are what the phases allocated.
    mesh = make_host_mesh(1, 1)
    shape = dataclasses.replace(SHAPES["train_4k"], global_batch=TRAIN_BATCH)
    require(len(ALLOCATED) == 4,
            f"dryrun: the training phases recorded {sorted(ALLOCATED)}")
    for label, got in ALLOCATED.items():
        cell = build_cell(label, "train_4k", mesh, tp=1, device="meta",
                          cfg=got["cfg"], shape=shape)
        recs = dryrun.leaf_records(cell)
        by = dryrun.argument_bytes(cell)
        layout = {g: [(r["path"], r["shape"], r["dtype"]) for r in recs
                      if r["group"] == g] for g in ("params", "opt_state")}
        equal = (layout["params"] == got["params"]
                 and layout["opt_state"] == got["opt_state"]
                 and by["params"] == got["param_bytes"]
                 and by["opt_state"] == got["opt_bytes"])
        row = dict(dryrun_param_bytes=by["params"],
                   dryrun_opt_bytes=by["opt_state"],
                   allocated_param_bytes=got["param_bytes"],
                   allocated_opt_bytes=got["opt_bytes"],
                   memory_allocated=got["memory_allocated"],
                   leaves=len(got["params"]) + len(got["opt_state"]),
                   equal=equal)
        out["world_size_1"][label] = row
        log(f"dryrun world size 1, {label} ({smi}): params + optimizer "
            f"state {by['params'] + by['opt_state']:,} B in the dry run, "
            f"{got['param_bytes'] + got['opt_bytes']:,} B of trees "
            f"allocated ({row['leaves']} leaves, equal leaf by leaf: "
            f"{equal}); torch.cuda.memory_allocated() then "
            f"{got['memory_allocated']:,} B")
        require(equal, f"dryrun: {label}'s params + optimizer state "
                f"differ from the trees the phase allocated: {row}")

    # Serving weights: bf16 in the dry run, fp32 in dense_generate (A30).
    for arch, got in SERVED.items():
        cell = build_cell(arch, "decode_32k", mesh, tp=1, device="meta",
                          cfg=got["cfg"])
        dry = dryrun.argument_bytes(cell)["params"]
        factor = got["param_bytes"] / dry
        out["serving_" + arch] = dict(dryrun_bf16_param_bytes=dry,
                                      dense_generate_fp32_bytes=got[
                                          "param_bytes"], factor=factor)
        log(f"dryrun {arch} serving weights ({smi}): {dry:,} B bf16 in the "
            f"dry run, {got['param_bytes']:,} B fp32 held by "
            f"dense_generate (memory_allocated {got['memory_allocated']:,} "
            f"B): factor {factor:.4f} (ROADMAP A30)")
    out["per_device"] = run_per_device(smi, pending)
    return out


def start_per_device():
    """Start ``dryrun.per_device`` of ``PER_DEVICE_CELLS``, all at once,
    each in its own subprocess (host CPU only) under
    ``PER_DEVICE_TIMEOUT_S``; phase 13 collects them
    (:func:`run_per_device`).  Returns (the pool, the futures, the start
    time)."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.launch import dryrun

    def one(cell):
        arch, shape, multi_pod = cell
        try:
            return cell, dryrun.per_device(arch, shape, multi_pod,
                                           timeout_s=PER_DEVICE_TIMEOUT_S)
        except Exception as e:  # noqa: BLE001 -- reported through require
            return cell, {"error": repr(e)[-3000:]}

    pool = ThreadPoolExecutor(len(PER_DEVICE_CELLS))
    return pool, [pool.submit(one, c) for c in PER_DEVICE_CELLS], \
        time.perf_counter()


def run_per_device(smi, pending):
    """Phase 13's per-device analyses, started by
    :func:`start_per_device`: a failed or timed-out analysis, or a missing
    field, fails the run.  Returns the records by cell, with the seconds
    from their start and the seconds this phase waited for them."""
    pool, futures, t_start = pending
    t0 = time.perf_counter()
    out = {}
    try:
        results = [f.result() for f in futures]
    finally:
        pool.shutdown(wait=True)
    waited = time.perf_counter() - t0
    for (arch, shape, multi_pod), rec in results:
        mesh = "pod2x16x16" if multi_pod else "pod16x16"
        out[f"{arch} {shape} {mesh}"] = rec
        require("error" not in rec, f"dryrun per-device {arch} {shape} "
                f"{mesh}: {rec.get('error')}")
        fields = ("dot_flops_per_device", "collectives",
                  "collective_wire_bytes_per_device")
        require(all(rec.get(f) is not None for f in fields),
                f"dryrun per-device {arch} {shape} {mesh}: a null field "
                f"in {rec}")
        if "error" in rec:
            continue
        kinds = ", ".join(
            f"{k} {v['count']:.0f} ops / {v['payload']:.4e} B payload / "
            f"{v['wire']:.4e} B wire" for k, v in
            sorted(rec["collectives"].items()))
        log(f"dryrun per-device {arch:12s} {shape:10s} {mesh:10s}: "
            f"{rec['dot_flops_per_device']:.6e} dot FLOPs, "
            f"{rec['collective_wire_bytes_per_device']:.6e} wire B a "
            f"device [{kinds}]; {rec['seconds']:.1f} s host CPU "
            f"(subprocess; card {smi})")
    out["wall_s"] = time.perf_counter() - t_start
    out["waited_s"] = waited
    log(f"dryrun per-device: {len(PER_DEVICE_CELLS)} cells done "
        f"{out['wall_s']:.1f} s after their start (host CPU, in parallel "
        f"with each other), {waited:.1f} s waited for here")
    return out


# ---------------------------------------------------------------------------
# Phase 14: the mesh-parallel paths at world size 1
# ---------------------------------------------------------------------------


def check_int8_psum(dev, group, n):
    """``int8_psum`` of n float32 values (the 4-layer yi-6b tree's length)
    on the card, timed; a slice of ``MESH_SLICE`` values from the middle,
    its codes, scales, sums and residuals bitwise against the same call
    on CPU copies over a gloo group."""
    import torch.distributed as dist

    from repro_torch.optim import compression

    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn(n, generator=gen, device=dev)
    err = torch.randn(n, generator=gen, device=dev).mul_(0.01)
    times = []
    for _ in range(MESH_TIMED):
        times.append(sync_ms(lambda: compression.int8_psum(x, group, err)))
    got, new_err = compression.int8_psum(x, group, err)
    lo = (n // 2) // compression.CHUNK * compression.CHUNK
    sl = slice(lo, lo + MESH_SLICE)
    q, sc = compression._quantize((x[sl] + err[sl])[None])
    cpu_group = dist.new_group([0], backend="gloo")
    want, want_err = compression.int8_psum(x[sl].cpu(), cpu_group,
                                           err[sl].cpu())
    wq, wsc = compression._quantize((x[sl].cpu() + err[sl].cpu())[None])
    n_pad = -(-n // compression.CHUNK) * compression.CHUNK
    out = dict(n=n, ms=times, ms_median=statistics.median(times),
               slice=[lo, lo + MESH_SLICE],
               codes_equal=torch.equal(q.cpu(), wq),
               scales_equal=torch.equal(sc.cpu(), wsc),
               sums_equal=torch.equal(got[sl].cpu(), want),
               residuals_equal=torch.equal(new_err[sl].cpu(), want_err),
               # each collective's buffers a device hands over and takes
               # back: the codes and fp32 scales of N (all_to_all) and of
               # its N / world shard (all_gather); at world size 1 the
               # collectives copy within the card
               all_to_all_int8_bytes=n_pad,
               all_to_all_scale_bytes=4 * n_pad // compression.CHUNK,
               all_gather_int8_bytes=n_pad,
               all_gather_scale_bytes=4 * n_pad // compression.CHUNK,
               max_abs_sum_err=float((got - x - err).abs().max()))
    for key in ("codes_equal", "scales_equal", "sums_equal",
                "residuals_equal"):
        require(out[key], f"mesh: int8_psum's {key[:-6]} on the card differ "
                f"from the CPU's on slice {out['slice']}")
    return out


def run_compressed_step(dev, mesh, training):
    """The compressed data-parallel step on the training phase's yi-6b (4
    layers), params, batches and optimizer: step 0's loss bitwise that
    phase's, later ones within ``COMPRESSED_RTOL``, a nonzero residual."""
    import dataclasses
    import shutil
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.train import make_compressed_train_step

    cfg = dataclasses.replace(get_config("yi-6b"), n_layers=TRAIN_LAYERS)
    launches = {k: 0 for k in ops.launch_counts()}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_train_")
    try:
        make_batch = training_batches(cfg, dev, tmp)
        opt = training_optimizer(cfg)
        params = lm.init_model(cfg, seed=SEED, device=dev)
        state = opt.init(params)
        step = make_compressed_train_step(cfg, opt, mesh, dp_axes=("data",),
                                          grad_accum=TRAIN_ACCUM)
        err = step.init_err_fb(params)
        torch.cuda.reset_peak_memory_stats()
        losses, step_s = [], []
        for i in range(COMPRESSED_STEPS):
            batch = make_batch(i)
            t0 = time.perf_counter()
            params, state, err, metrics = counted(
                ops, launches, lambda: step(params, state, batch, i, err))
            step_s.append(time.perf_counter() - t0)
            losses.append(float(metrics["loss"]))
            log(f"compressed step {i}: loss {losses[-1]!r} "
                f"({step_s[-1] * 1e3:.0f} ms)")
        want = training["losses"][:COMPRESSED_STEPS]
        out = dict(losses=losses, training_losses=want, step_s=step_s,
                   peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
                   residual_abs_max=float(err.abs().max()),
                   residual_numel=err.numel(),
                   launches_per_step={key: launches[key] / COMPRESSED_STEPS
                                      for key in FLASH_KERNELS})
        require(losses[0] == want[0], f"mesh: compressed step 0's loss "
                f"{losses[0]!r} is not the training phase's {want[0]!r}")
        for got, ref_loss in zip(losses[1:], want[1:]):
            require(abs(got - ref_loss) <= COMPRESSED_RTOL * abs(ref_loss),
                    f"mesh: compressed losses {losses} vs {want} over "
                    f"{COMPRESSED_RTOL} relative")
        require(out["residual_abs_max"] > 0, "mesh: the residual is zero")
        require(launches["flash_attention_fwd"] > 0
                and launches["flash_attention_bwd"] > 0,
                f"mesh: the compressed step launched no flash kernel: "
                f"{launches}")
        del params, state, err, step
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    return out, launches


def run_ep_moe(dev):
    """Expert-parallel MoE at olmoe-1b-7b full width on one card: the
    ``EP_SHARDS`` shards of one layer computed in turn
    (``mlp._ep_shard``) and their partials summed in shard order, against
    ``moe_fwd``'s portable path: outputs and gradients within ``EP_TOL``,
    ``aux`` bitwise, and each shard's partial and kept mask bitwise
    against the same shard on the plain dispatch and combine.  At
    capacity factor 8.0 (nothing drops) and at the config's own 1.25,
    where the tokens' shared mean makes capacity bind and the kept masks
    of the shards must make up the portable path's."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import mlp
    from repro_torch.models.common import init_params

    base = dataclasses.replace(get_config(MOE_ARCH), dtype="float32")
    launches = {k: 0 for k in ops.launch_counts()}
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = init_params(mlp.moe_defs(base), gen, dev)
    # A mean shared by all tokens favours the experts whose router column
    # leans its way, so the popular ones overflow at capacity factor 1.25.
    x = torch.randn(EP_BATCH, EP_SEQ, base.d_model, generator=gen,
                    device=dev)
    x += torch.randn(base.d_model, generator=gen, device=dev)
    ct = torch.randn(x.shape, generator=gen, device=dev)
    names = sorted(params)
    out = dict(d_model=base.d_model, experts=base.n_experts,
               top_k=base.top_k, d_ff=base.d_ff,
               tokens=x.shape[0] * x.shape[1], shards=EP_SHARDS)
    for cf in (EP_CF, base.capacity_factor):
        cfg = dataclasses.replace(base, capacity_factor=cf)
        p = {k: v.detach().requires_grad_() for k, v in params.items()}
        xr = x.detach().requires_grad_()
        want, want_aux = mlp.moe_fwd(p, xr, cfg)
        want_g = torch.autograd.grad((want * ct).sum() + want_aux,
                                     [p[k] for k in names] + [xr])
        t = x.shape[0] * x.shape[1]
        with torch.no_grad():
            gate, idx, _ = mlp._router(p, x.reshape(t, -1), cfg)
            cap = mlp.moe_capacity(cfg, t)
            keep = ops.moe_dispatch(x.reshape(t, -1), idx, cfg.n_experts,
                                    cap, impl="ref")[2]

        def ep():
            flat = xr.reshape(t, -1)
            g_, i_, aux_ = mlp._router(p, flat, cfg)
            parts = [mlp._ep_shard(p, flat, g_, i_, cfg, m, EP_SHARDS, cap)
                     for m in range(EP_SHARDS)]
            total = parts[0][0]
            for part, _ in parts[1:]:
                total = total + part
            grads = torch.autograd.grad((total.reshape(x.shape) * ct).sum()
                                        + aux_, [p[k] for k in names] + [xr])
            return total.reshape(x.shape), aux_, [k for _, k in parts], grads

        got, aux, kept, got_g = counted(ops, launches, ep)
        counts = counted.last
        with torch.no_grad():
            flat = x.reshape(t, -1)
            shard_equal = []
            for m in range(EP_SHARDS):
                a = mlp._ep_shard(params, flat, gate, idx, cfg, m, EP_SHARDS,
                                  cap)
                b = mlp._ep_shard(params, flat, gate, idx, cfg, m, EP_SHARDS,
                                  cap, impl="ref")
                shard_equal.append(torch.equal(a[0], b[0])
                                   and torch.equal(a[1], b[1]))
        union = kept[0]
        for k in kept[1:]:
            union = union | k
        rec = dict(capacity=cap,
                   max_abs_err=float((got - want).detach().abs().max()),
                   aux_equal=bool(torch.equal(aux, want_aux)),
                   grad_max_abs_err={
                       n_: float((a - b).abs().max())
                       for n_, a, b in zip(names + ["x"], got_g, want_g)},
                   kept=int(keep.sum()), kept_equal=bool(torch.equal(
                       union, keep)),
                   shards_bitwise_plain=shard_equal,
                   launches={k: counts[k] for k in MOE_CONVERTERS})
        out[f"capacity_factor {cf}"] = rec
        log(f"ep moe cf {cf}: " + json.dumps(rec))
        require(rec["max_abs_err"] <= EP_TOL, f"mesh: EP MoE output off by "
                f"{rec['max_abs_err']} at capacity factor {cf}")
        require(max(rec["grad_max_abs_err"].values()) <= EP_TOL,
                f"mesh: EP MoE gradients off: {rec['grad_max_abs_err']}")
        require(rec["aux_equal"], "mesh: EP MoE aux differs")
        require(rec["kept_equal"], f"mesh: EP kept masks differ at capacity "
                f"factor {cf}")
        require((rec["kept"] < keep.numel()) == (cf < EP_CF),
                f"mesh: capacity factor {cf} kept {rec['kept']} of "
                f"{keep.numel()} assignments")
        require(all(shard_equal), f"mesh: an EP shard differs from its "
                f"plain dispatch/combine: {shard_equal}")
        want_n = 2 * EP_SHARDS  # forward and backward, each shard
        require(all(counts[k] == want_n for k in MOE_CONVERTERS),
                f"mesh: EP launches {counts}, want {want_n} of each "
                f"converter")
    del params, x, ct
    torch.cuda.empty_cache()
    return out, launches


def run_sharded_embedding(dev):
    """yi-6b's 64,000 x 4,096 table over ``EMB_SHARDS`` vocab shards in
    turn, on the training batch's 4 x 4,096 ids: the summed shard
    lookups bitwise ``table[ids]``, and the shards' scatter-adds bitwise
    the unsharded gather's gradient."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.models import lm

    cfg = get_config("yi-6b")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    table = torch.randn(cfg.vocab, cfg.d_model, generator=gen, device=dev)
    ids = torch.randint(0, cfg.vocab, (TRAIN_BATCH,
                                       SHAPES["train_4k"].seq_len),
                        generator=gen, device=dev)
    g = torch.randn(ids.shape + (cfg.d_model,), generator=gen, device=dev)
    vs = cfg.vocab // EMB_SHARDS
    tr = table.detach().requires_grad_()
    (want_g,) = torch.autograd.grad(tr[ids.long()], [tr], g)
    with torch.no_grad():
        want = table[ids.long()]
        got = torch.zeros_like(want)
        for m in range(EMB_SHARDS):
            got += lm._embed_shard_fwd(table[m * vs:(m + 1) * vs], ids,
                                       m * vs, torch.float32)
        got_g = torch.cat([lm._embed_shard_bwd(ids, g, m * vs, vs,
                                               torch.float32)
                           for m in range(EMB_SHARDS)])
    out = dict(table=list(table.shape), ids=list(ids.shape),
               shards=EMB_SHARDS, forward_equal=torch.equal(got, want),
               grad_equal=torch.equal(got_g, want_g),
               grad_max_abs_err=float((got_g - want_g).abs().max()))
    require(out["forward_equal"], "mesh: the sharded embedding's forward "
            "is not table[ids] bit for bit")
    require(out["grad_equal"], f"mesh: the sharded embedding's gradient "
            f"differs by {out['grad_max_abs_err']}")
    del table, ids, g, tr, want_g, got, got_g, want
    torch.cuda.empty_cache()
    return out


def distribute_tree(tree, shardings):
    """A tree of tensors as DTensors, each by its ``Sharding`` (the same
    paths): every rank keeps its block, nothing moves."""
    if isinstance(tree, dict):
        return {k: distribute_tree(v, shardings[k]) for k, v in tree.items()}
    return shardings.distribute(tree.detach())


def run_dtensor_training(dev, training):
    """Phase 7's yi-6b step (4 layers, its batches, AdamW) with the
    parameters and batch as ``param_shardings`` DTensors on a bound 1 x 1
    ``data x model`` mesh and the training rules' ``constrain`` calls, on
    the flash kernels: step 0's loss bitwise phase 7's first; the
    gradients of batch 0 against the plain-tensor kernel path's, leaf by
    leaf (bitwise, or the first differing leaf named and held within
    ``LOSS_RTOL`` relative); what ``CommDebugMode`` counted (one rank:
    nothing crosses a wire)."""
    import dataclasses
    import shutil
    import tempfile

    from torch.distributed.tensor.debug import CommDebugMode
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import Mesh, bind_mesh
    from repro_torch.models import lm
    from repro_torch.models.common import tree_paths
    from repro_torch.parallel.sharding import (Sharding, make_rules,
                                               param_shardings)
    from repro_torch.train import (grads_with_accum, make_loss_fn,
                                   make_train_step)

    cfg = dataclasses.replace(get_config("yi-6b"), n_layers=TRAIN_LAYERS)
    mesh = bind_mesh(Mesh(("data", "model"), (1, 1)), torch.device(dev).type)
    rules = make_rules(fsdp=cfg.fsdp, shard_kv_heads=cfg.shard_kv_heads,
                       batch_axes=("data",), with_pod=False, mesh=mesh)
    shard = param_shardings(lm.model_defs(cfg, 1), rules, mesh)
    bspec = Sharding(mesh, rules.spec(("batch", "seq")))
    launches = {k: 0 for k in ops.launch_counts()}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dtensor_")
    out = {}
    try:
        make_batch = training_batches(cfg, dev, tmp)
        batch0 = make_batch(0)
        params = lm.init_model(cfg, seed=SEED, device=dev)
        _, _, plain = grads_with_accum(make_loss_fn(cfg), params, batch0,
                                       TRAIN_ACCUM)
        plain = tree_paths(plain)
        dparams = distribute_tree(params, shard)
        dbatch = {k: bspec.distribute(v) for k, v in batch0.items()}
        with implicit_replication():
            _, _, grads = counted(ops, launches, lambda: grads_with_accum(
                make_loss_fn(cfg, rules=rules), dparams, dbatch,
                TRAIN_ACCUM))
        grad_counts = counted.last
        grads = tree_paths(grads)
        first, rel = None, 0.0
        for (path, a), (_, b) in zip(plain, grads):
            b = b.to_local()
            if not torch.equal(a, b):
                if first is None:
                    first = path
                rel = max(rel, float((a - b).abs().max()
                                     / a.abs().max().clamp(min=1e-30)))
        del plain, grads
        opt = training_optimizer(cfg)
        step = make_train_step(cfg, opt, grad_accum=TRAIN_ACCUM, rules=rules)
        dparams = distribute_tree(params, shard)
        del params
        state = opt.init(dparams)
        with implicit_replication(), CommDebugMode() as comm:
            _, _, metrics = counted(ops, launches, lambda: step(
                dparams, state, dbatch, 0))
        step_counts = counted.last
        loss = float(metrics["loss"].to_local() if hasattr(
            metrics["loss"], "to_local") else metrics["loss"])
        want = training["losses"][0]
        comm_counts = {str(k): v for k, v in comm.get_comm_counts().items()}
        out.update(loss=loss, training_loss=want, loss_equal=loss == want,
                   grads_bitwise=first is None, first_differing_leaf=first,
                   grad_max_rel_err=rel, comm_counts=comm_counts,
                   comm_total=comm.get_total_counts(),
                   grad_launches={k: grad_counts[k] for k in FLASH_KERNELS},
                   step_launches={k: step_counts[k] for k in FLASH_KERNELS})
        log("dtensor yi-6b step: " + json.dumps(out))
        require(loss == want, f"mesh: the DTensor step's loss {loss!r} is "
                f"not phase 7's first {want!r}")
        require(rel <= LOSS_RTOL, f"mesh: DTensor gradient {first} off by "
                f"{rel} relative")
        require(step_counts["flash_attention_fwd"] > 0
                and step_counts["flash_attention_bwd"] > 0,
                f"mesh: the DTensor step launched {step_counts}")
        del dparams, state, dbatch
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    return out, launches


def run_dtensor_ep(dev):
    """EP MoE at olmoe-1b-7b width with ``param_shardings`` DTensor
    parameters on a bound 1 x 1 ``data x model`` mesh: ``mlp._ep_params``
    lays each expert weight out with its experts on the model axis (one
    rank: the whole weight, its local tensor) and the router replicated,
    and each of the ``EP_SHARDS`` shards in turn runs ``_ep_shard`` on its
    experts' block of those local tensors, on the converter kernels:
    bitwise the same shard with the plain tensors, forward and backward."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import Mesh, bind_mesh
    from repro_torch.models import mlp
    from repro_torch.models.common import init_params
    from repro_torch.parallel.sharding import make_rules, param_shardings

    cfg = dataclasses.replace(get_config(MOE_ARCH), dtype="float32")
    mesh = bind_mesh(Mesh(("data", "model"), (1, 1)), torch.device(dev).type)
    launches = {k: 0 for k in ops.launch_counts()}
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = init_params(mlp.moe_defs(cfg), gen, dev)
    x = torch.randn(EP_BATCH * EP_SEQ, cfg.d_model, generator=gen,
                    device=dev)
    ct = torch.randn(x.shape, generator=gen, device=dev)
    t = x.shape[0]
    cap = mlp.moe_capacity(cfg, t)
    e_loc = cfg.n_experts // EP_SHARDS
    out = {}
    for fsdp in (False, True):
        rules = make_rules(fsdp=fsdp, batch_axes=("data",), with_pod=False,
                           mesh=mesh)
        shard = param_shardings(mlp.moe_defs(cfg), rules, mesh)
        dparams = {k: shard[k].distribute(v).requires_grad_()
                   for k, v in params.items()}
        plain = {k: v.detach().requires_grad_() for k, v in params.items()}
        local, blocks = mlp._ep_params(dparams, rules, "model")
        equal = []

        def shard_run(p, m, w):
            g_, i_, _ = mlp._router(p, x, cfg)
            part, kept = mlp._ep_shard(p, x, g_, i_, cfg, m, EP_SHARDS, cap,
                                       w=w)
            return part, kept

        for m in range(EP_SHARDS):
            w = {k: v[m * e_loc:(m + 1) * e_loc] for k, v in blocks.items()}
            a, ka = counted(ops, launches, lambda: shard_run(plain, m, None))
            b, kb = counted(ops, launches, lambda: shard_run(local, m, w))
            ga = torch.autograd.grad((a * ct).sum(), list(plain.values()),
                                     allow_unused=True)
            gb = torch.autograd.grad((b * ct).sum(), list(dparams.values()),
                                     allow_unused=True)
            same = torch.equal(a, b) and torch.equal(ka, kb) and all(
                (u is None and v is None) or torch.equal(
                    u, v.to_local() if hasattr(v, "to_local") else v)
                for u, v in zip(ga, gb))
            equal.append(bool(same))
        out[f"fsdp {fsdp}"] = equal
        require(all(equal), f"mesh: DTensor-parameter EP shards differ from "
                f"the plain tensors' (fsdp {fsdp}): {equal}")
    out["launches"] = {k: launches[k] for k in MOE_CONVERTERS}
    log("dtensor ep moe: " + json.dumps(out))
    del params, x, ct
    torch.cuda.empty_cache()
    return out, launches


def run_mesh_parallel(dev, training):
    """Phase 14: a world-size-1 nccl group from a file store, then
    ``int8_psum``, the compressed step, EP MoE and the sharded
    embedding.  Returns (the phase's numbers, its launch counts)."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import Mesh, bind_mesh
    from repro_torch.parallel import collectives

    launches = {k: 0 for k in ops.launch_counts()}
    out = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    try:
        t0 = time.perf_counter()
        backend = collectives.init_group(tmp, 0, 1, device_type="cuda")
        mesh = bind_mesh(Mesh(("data",), (1,)), "cuda")
        group = collectives.axis_group(mesh, "data")
        out.update(backend=backend, group_backend=dist.get_backend(group),
                   init_s=time.perf_counter() - t0)
        require(out["group_backend"] == "nccl",
                f"mesh: the group's backend is {out['group_backend']}")
        t0 = time.perf_counter()
        out["int8_psum"] = check_int8_psum(dev, group, training["params"])
        out["int8_psum_s"] = time.perf_counter() - t0
        log("mesh int8_psum: " + json.dumps(out["int8_psum"]))
        t0 = time.perf_counter()
        out["compressed"], counts = run_compressed_step(dev, mesh, training)
        out["compressed_s"] = time.perf_counter() - t0
        for k, v in counts.items():
            launches[k] += v
        t0 = time.perf_counter()
        out["ep_moe"], counts = run_ep_moe(dev)
        out["ep_moe_s"] = time.perf_counter() - t0
        for k, v in counts.items():
            launches[k] += v
        t0 = time.perf_counter()
        out["embedding"] = run_sharded_embedding(dev)
        out["embedding_s"] = time.perf_counter() - t0
        # DTensor parameters on a bound 1 x 1 mesh (A9c), the launches
        # they add counted apart
        t0 = time.perf_counter()
        out["dtensor_training"], counts = run_dtensor_training(dev, training)
        for k, v in counts.items():
            launches[k] += v
        out["dtensor_ep"], counts2 = run_dtensor_ep(dev)
        for k, v in counts2.items():
            launches[k] += v
        out["dtensor_launches"] = {k: counts[k] + counts2[k]
                                   for k in FLASH_KERNELS + MOE_CONVERTERS}
        out["dtensor_s"] = time.perf_counter() - t0
        log("mesh-parallel DTensor runs: launches added " + json.dumps(
            out["dtensor_launches"]) + f", {out['dtensor_s']:.1f} s")
    finally:
        collectives.destroy_group()
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    return out, launches


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
    bw, flops, bf16_flops = peaks_for(name)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {name}; "
        f"peaks {bw / 1e12} TB/s, {flops / 1e12} fp32 TFLOP/s, "
        f"{bf16_flops / 1e12} bf16 tensor-core TFLOP/s")
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
    bf16_launches = dict(launches)  # the bf16 pools' serving runs alone
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
    statics, counts = serve_paged_dtypes(serve_mod, cfg, dev, params,
                                         prompts)
    add_launches(launches, bf16_launches, counts)
    for kv_dtype in ("fp32", "bf16"):
        tp = throughput(serve_mod, cfg, dev, params, prompts, kv_dtype)
        log(f"throughput {kv_dtype} ({smi}): " + json.dumps(tp))
        for step in ("decode", "prefill"):
            per = tp[f"launches_per_{step}_step"]
            require(per["paged_kv_write"] == cfg.n_layers
                    and all(per[k] == 0 for k in MOE_CONVERTERS),
                    f"throughput {kv_dtype}: not one paged K/V write a "
                    f"layer a {step} step: {per}")
    phase_s["paged serving"] = time.perf_counter() - t0

    # -- phase 5: speculative serving, full-width yi-6b -----------------------
    t0 = time.perf_counter()
    counts = serve_spec_dtypes(serve_mod, cfg, dev, params, prompts,
                               statics, smi)
    add_launches(launches, bf16_launches, counts)
    del params
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

    # -- phase 7: training, yi-6b width ----------------------------------------
    t0 = time.perf_counter()
    records.update(check_flash_kernels(ops, ref, dev, bw, flops, bf16_flops))
    for key in [k for k in records if k[0] in FLASH_KERNELS]:
        log(f"kernel {key[0]} [{key[1]}]: " + json.dumps(records[key]))
    phase_s["flash kernels"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    training, counts = run_training(dev)
    for k, v in counts.items():
        launches[k] += v
    summary = training
    log(f"training yi-6b width ({smi}): " + json.dumps(summary))
    log(f"training: step {summary['step_median_s']:.3f} s median, "
        f"{summary['tokens_per_s']:.1f} tokens/s, device idle share "
        f"{summary.get('device_idle_share', 'not measured')}, flash "
        f"launches per step {summary['launches_per_step']}; resumed losses "
        f"equal bit for bit: {summary['resumed_equal_bitwise']}")
    phase_s["training"] = time.perf_counter() - t0

    # -- phase 8: olmoe-1b-7b dense generation, full size ---------------------
    t0 = time.perf_counter()
    summary, counts = run_moe_serving(dev)
    for k, v in counts.items():
        launches[k] += v
    log(f"serve {MOE_ARCH} ({smi}): " + json.dumps(summary))
    log(f"serve {MOE_ARCH}: prefill {summary['prefill_tokens_per_s']:.1f} "
        f"tokens/s, decode {summary['decode_tokens_per_s']:.1f} tokens/s, "
        f"device idle share of a decode step "
        f"{summary.get('device_idle_share', 'not measured')}, kernels a "
        f"decode step {summary.get('kernels_per_decode_step', 'not measured')}"
        f", converter launches a decode step "
        f"{summary['launches_per_decode_step']}; streams equal: "
        f"{summary['streams_equal']}")
    phase_s["moe serving"] = time.perf_counter() - t0

    # -- phase 9: olmoe-1b-7b training, full width ----------------------------
    t0 = time.perf_counter()
    summary, counts = run_moe_training(dev)
    for k, v in counts.items():
        launches[k] += v
    log(f"training {MOE_ARCH} width ({smi}): " + json.dumps(summary))
    log(f"moe training: step {summary['step_median_s']:.3f} s median, "
        f"{summary['tokens_per_s']:.1f} tokens/s, peak "
        f"{summary['peak_memory_gb']:.2f} GB, device idle share "
        f"{summary.get('device_idle_share', 'not measured')}, launches per "
        f"step {summary['launches_per_step']}")
    phase_s["moe training"] = time.perf_counter() - t0

    # -- phases 10 and 11: hymba-1.5b and hubert-xlarge training, full size ---
    for arch in FAMILY_TRAIN:
        t0 = time.perf_counter()
        summary, counts = run_family_training(arch, dev)
        for k, v in counts.items():
            launches[k] += v
        log(f"training {arch} full size ({smi}): " + json.dumps(summary))
        log(f"{arch} training: step {summary['step_median_s']:.3f} s median, "
            f"{summary['tokens_per_s']:.1f} tokens/s, peak "
            f"{summary['peak_memory_gb']:.2f} GB, device idle share "
            f"{summary.get('device_idle_share', 'not measured')}, flash "
            f"launches per step {summary['launches_per_step']}")
        phase_s[f"{arch} training"] = time.perf_counter() - t0

    # -- phase 12: hymba-1.5b dense generation, full size ---------------------
    t0 = time.perf_counter()
    summary, counts = run_hymba_serving(dev)
    for k, v in counts.items():
        launches[k] += v
    log(f"serve {HYMBA} ({smi}): " + json.dumps(summary))
    log(f"serve {HYMBA}: prefill {summary['prefill_tokens_per_s']:.1f} "
        f"tokens/s, decode {summary['decode_tokens_per_s']:.1f} tokens/s, "
        f"device idle share of a decode step "
        f"{summary.get('device_idle_share', 'not measured')}, kernels a "
        f"decode step {summary.get('kernels_per_decode_step', 'not measured')}"
        f"; prefill + decode vs full forward max abs err "
        f"{summary['contract_max_err']:.3e}")
    phase_s[f"{HYMBA} serving"] = time.perf_counter() - t0

    # -- phase 13: the dry run (host only) ------------------------------------
    t0 = time.perf_counter()
    summary = run_dryrun(smi)
    log(f"dryrun ({smi}): " + json.dumps(summary))
    phase_s["dryrun"] = time.perf_counter() - t0

    # -- phase 14: the mesh-parallel paths (A9b), world size 1 ---------------
    t0 = time.perf_counter()
    summary, counts = run_mesh_parallel(dev, training)
    for k, v in counts.items():
        launches[k] += v
    log(f"mesh-parallel ({smi}): " + json.dumps(summary))
    comp = summary["compressed"]
    log(f"mesh-parallel: int8_psum of {summary['int8_psum']['n']} values "
        f"{summary['int8_psum']['ms_median']:.1f} ms; compressed steps "
        f"{comp['step_s']} s, peak {comp['peak_memory_gb']:.2f} GB, flash "
        f"launches per step {comp['launches_per_step']}; EP MoE and the "
        f"sharded embedding checked")
    phase_s["mesh-parallel"] = time.perf_counter() - t0
    phase_s["total"] = time.perf_counter() - t_start
    log("phase seconds: " + json.dumps(phase_s))
    log(f"profiler: {len(PROFILER_MISSES)} device_ms values taken by CUDA "
        f"events (no device time in any profiler session): "
        f"{PROFILER_MISSES}")

    for kname in ATTENTION_KERNELS:
        records[(kname, REPORTED[kname])]["shapes"]["bf16"]["launches"] = \
            bf16_launches[kname]
    for stag in ("bf16 append", "bf16 chunk"):
        records[("paged_kv_write", REPORTED["paged_kv_write"])]["shapes"][
            stag]["launches"] = bf16_launches["paged_kv_write"]
    log("bf16 pools' serving runs, launches: " + json.dumps(bf16_launches))
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
            bound_rate=rec["bound_rate"],
            **({"bound_fp32_ms": rec["bound_fp32_ms"]}
               if "bound_fp32_ms" in rec else {}),
            **{key: rec[key] for key in REDESIGN_KEYS if key in rec},
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
